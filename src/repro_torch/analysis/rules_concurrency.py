"""R1 (blocking-in-async) and R2 (single-consumer / thread affinity).

Both rules protect the live runtime's lock-free design (see
docs/ARCHITECTURE.md "Checked invariants"):

R1 — the event loop must never block. Every function reachable on the
loop thread from an ``async def`` in ``src/repro_torch/runtime/`` is
scanned for blocking primitives (``time.sleep``, blocking
``Queue.get/put``, ``Thread/Process.join``, file ``open``,
``subprocess``, the payloads' ``run_sync``, and the host syncs of the
torch idiom: ``torch.cuda.synchronize()`` and any ``.synchronize()``).
``@worker_side`` bodies are exempt — they run on worker
threads/processes where blocking is the point — but an edge from
loop-reachable code *into* a ``@worker_side`` function is itself a
finding. A deliberate blocking section on the loop thread (the kill
path's synchronous data-channel tail-drain, teardown joins) must carry
``@loop_only(blocking="reason")``.

R2 — state affinity.  The multiproc data channel is single-consumer by
construction: only ``@loop_only`` code may read ``data_q``.  Master-side
mirrors (``LivePE.state/.msg/.idle_since``, a worker's ``pes`` list, the
multiproc handles' ``kernel_launches`` and the transport's
``payload_kernel_launches``) and the ``Master``'s queue-mutating methods
may only be touched from ``@loop_only`` functions or ``async def``s
(which run on the loop by construction) — and never from
``@worker_side`` code.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

from .callgraph import body_calls, reachable_from_async
from .model import Finding, FunctionInfo, RepoIndex

__all__ = ["check_blocking_in_async", "check_affinity"]

RUNTIME_PREFIX = "src/repro_torch/runtime/"
#: Call edges are resolved only into the control plane: the runtime
#: package itself plus the core algorithms the control loop invokes per tick.
CONTROL_PLANE_PREFIXES = (RUNTIME_PREFIX, "src/repro_torch/core/")

#: Mirror attributes whose assignment is loop-thread-only (R2).  The
#: last two are the port's own: a process handle's payload launch count
#: and the transport's sum of them, folded in from the data channel.
MIRROR_ATTRS = {"state", "msg", "idle_since", "pes", "kernel_launches",
                "payload_kernel_launches"}

#: Master methods that mutate the backlog queues (R2).
MASTER_MUTATORS = {"pull", "push_back", "push_front", "requeue", "complete"}

_QUEUE_GET = {"get"}
_JOIN_RECEIVERS = ("proc", "process", "thread")


def _receiver_tail(func: ast.expr) -> Optional[str]:
    """Syntactic name of a method call's receiver: ``h.cmd_q.put`` → ``cmd_q``."""
    if not isinstance(func, ast.Attribute):
        return None
    value = func.value
    if isinstance(value, ast.Attribute):
        return value.attr
    if isinstance(value, ast.Name):
        return value.id
    return None


def _receiver_chain(func: ast.expr) -> List[str]:
    """All names along a call's receiver chain: ``self.pool.master.requeue``
    → ``["self", "pool", "master"]``."""
    names: List[str] = []
    node = func.value if isinstance(func, ast.Attribute) else None
    while node is not None:
        if isinstance(node, ast.Attribute):
            names.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Name):
            names.append(node.id)
            node = None
        else:
            node = getattr(node, "value", None) if isinstance(node, ast.Subscript) else None
    return names


def _is_queue_like(name: Optional[str]) -> bool:
    if name is None:
        return False
    return name == "q" or name.endswith("_q") or name == "queue" or name.endswith("_queue")


def _dotted(node: ast.expr) -> Optional[str]:
    """``time.sleep`` → "time.sleep"; ``np.random.normal`` → "np.random.normal"."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _blocking_call(call: ast.Call) -> Optional[str]:
    """A human-readable label if this call is a blocking primitive."""
    func = call.func
    dotted = _dotted(func)
    if dotted in ("time.sleep",):
        return dotted
    if dotted is not None and dotted.split(".", 1)[0] in ("subprocess",):
        return dotted
    if dotted in ("os.system", "os.wait", "os.waitpid"):
        return dotted
    if isinstance(func, ast.Name) and func.id == "open":
        return "open()"
    if isinstance(func, ast.Attribute):
        attr = func.attr
        tail = _receiver_tail(func)
        if attr == "synchronize":
            return f"{dotted or tail or '<expr>'}() (host waits for the device)"
        if attr == "run_sync":
            return f"{tail or '<expr>'}.run_sync() (worker-side blocking payload)"
        if attr in _QUEUE_GET | {"put"} and _is_queue_like(tail):
            return f"{tail}.{attr}() (blocking queue op; use {attr}_nowait)"
        if attr == "join" and tail is not None and (
            tail in _JOIN_RECEIVERS
            or any(tail.endswith(s) for s in _JOIN_RECEIVERS)
        ):
            return f"{tail}.join()"
    return None


def _scan_blocking(fn: FunctionInfo) -> Iterator[Tuple[int, str]]:
    for call in body_calls(fn):
        label = _blocking_call(call)
        if label is not None:
            yield call.lineno, label


def check_blocking_in_async(index: RepoIndex, root) -> List[Finding]:
    """R1: no blocking primitive reachable from async bodies in runtime/."""
    findings: List[Finding] = []
    reached, boundary = reachable_from_async(
        index, RUNTIME_PREFIX, resolve_prefixes=CONTROL_PLANE_PREFIXES
    )
    for caller, callee, line in boundary:
        findings.append(
            Finding(
                rule="R1",
                path=caller.path,
                line=line,
                symbol=caller.qualname,
                message=(
                    f"loop-reachable code calls @worker_side function "
                    f"{callee.qualname} ({callee.path}); worker-side code "
                    f"must be dispatched via a thread/process/executor, "
                    f"never invoked on the event loop"
                ),
            )
        )
    for fn in reached.values():
        if fn.allows_blocking():
            continue
        for line, label in _scan_blocking(fn):
            findings.append(
                Finding(
                    rule="R1",
                    path=fn.path,
                    line=line,
                    symbol=fn.qualname,
                    message=(
                        f"blocking call {label} reachable from async code; "
                        f"move it worker-side (@worker_side) or annotate a "
                        f"deliberate stall with @loop_only(blocking=...)"
                    ),
                )
            )
    return findings


def _assigned_mirror_attrs(fn: FunctionInfo) -> Iterator[Tuple[int, str, str]]:
    """(line, receiver, attr) for mirror-attribute assignments in ``fn``."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn.node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        targets: List[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for tgt in targets:
            if isinstance(tgt, ast.Tuple):
                sub = list(tgt.elts)
            else:
                sub = [tgt]
            for t in sub:
                if (
                    isinstance(t, ast.Attribute)
                    and t.attr in MIRROR_ATTRS
                    and not (isinstance(t.value, ast.Name) and t.value.id == "self")
                ):
                    recv = _dotted(t.value) or "<expr>"
                    yield node.lineno, recv, t.attr
        stack.extend(ast.iter_child_nodes(node))


def check_affinity(index: RepoIndex, root) -> List[Finding]:
    """R2: data-channel single-consumer + mirror/master mutation affinity."""
    findings: List[Finding] = []
    for fn in index.src_functions(RUNTIME_PREFIX):
        on_loop = fn.loop_only or (fn.is_async and not fn.worker_side)
        # --- annotation vocabulary consistency --------------------------------
        if fn.loop_only and fn.worker_side:
            findings.append(
                Finding(
                    rule="R2",
                    path=fn.path,
                    line=fn.line,
                    symbol=fn.qualname,
                    message="function annotated both @loop_only and @worker_side",
                )
            )
        if fn.has_blocking_kwarg and not fn.blocking_reason:
            findings.append(
                Finding(
                    rule="R2",
                    path=fn.path,
                    line=fn.line,
                    symbol=fn.qualname,
                    message=(
                        "@loop_only(blocking=...) requires a non-empty literal "
                        "reason string explaining why stalling the loop is safe"
                    ),
                )
            )
        # --- mirror mutations -------------------------------------------------
        for line, recv, attr in _assigned_mirror_attrs(fn):
            if fn.worker_side:
                findings.append(
                    Finding(
                        rule="R2",
                        path=fn.path,
                        line=line,
                        symbol=fn.qualname,
                        message=(
                            f"@worker_side code mutates master-side mirror "
                            f"state ({recv}.{attr}); mirrors are loop-thread-"
                            f"only — report through the data channel instead"
                        ),
                    )
                )
            elif not on_loop:
                findings.append(
                    Finding(
                        rule="R2",
                        path=fn.path,
                        line=line,
                        symbol=fn.qualname,
                        message=(
                            f"mirror mutation {recv}.{attr} outside @loop_only: "
                            f"annotate the function (it must only run on the "
                            f"event-loop thread) or move the mutation"
                        ),
                    )
                )
        # --- master queue mutations + data-channel reads ----------------------
        for call in body_calls(fn):
            func = call.func
            if not isinstance(func, ast.Attribute):
                continue
            attr = func.attr
            tail = _receiver_tail(func)
            if attr in MASTER_MUTATORS and "master" in _receiver_chain(func):
                if fn.worker_side:
                    findings.append(
                        Finding(
                            rule="R2",
                            path=fn.path,
                            line=call.lineno,
                            symbol=fn.qualname,
                            message=(
                                f"@worker_side code calls Master.{attr}(); the "
                                f"master's queues are loop-thread-only"
                            ),
                        )
                    )
                elif not on_loop:
                    findings.append(
                        Finding(
                            rule="R2",
                            path=fn.path,
                            line=call.lineno,
                            symbol=fn.qualname,
                            message=(
                                f"Master.{attr}() called outside @loop_only; "
                                f"queue mutations must stay on the event-loop "
                                f"thread (annotate the caller)"
                            ),
                        )
                    )
            if attr in ("get", "get_nowait") and tail == "data_q":
                if not fn.loop_only:
                    findings.append(
                        Finding(
                            rule="R2",
                            path=fn.path,
                            line=call.lineno,
                            symbol=fn.qualname,
                            message=(
                                "data_q read outside a @loop_only function: the "
                                "multiproc data channel is single-consumer — "
                                "only the poller and the kill-path drain (both "
                                "on the loop thread) may consume it"
                            ),
                        )
                    )
    return findings

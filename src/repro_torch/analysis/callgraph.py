"""Call-graph approximation for reachability from ``async def`` roots.

The concurrency rules need to answer one question: *which functions can
run on the event-loop thread as part of an async call chain?*  A precise
answer needs type inference; the checker instead uses a name-based
over-approximation that is cheap, deterministic, and errs toward
reporting (a finding in an over-approximated branch is still a blocking
primitive in loop-adjacent code — the fix is an annotation stating why
that is safe).

Edges: for every ``ast.Call`` in a function body (excluding nested
``def`` bodies — those are separate nodes reached only if actually
called), take the called name (``foo`` / ``obj.foo``) and connect to
every port function (``src/repro_torch/``) with that name.  Traversal stops at:

- ``@worker_side`` functions — they run on another thread/process; the
  *call itself* is reported by R1 (loop code must not call into
  worker-side code), but their bodies are never scanned;
- calls dispatched through well-known thread/process entry points
  (``run_in_executor``, ``Thread(target=...)``, ``Process(target=...)``)
  — the callee escapes the loop thread by construction.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Set, Tuple

from .model import FunctionInfo, RepoIndex

__all__ = ["called_names", "reachable_from_async", "body_calls"]

#: Call names whose *arguments* are thread/process entry points, not
#: loop-thread calls — edges through them are not followed.
_ESCAPE_DISPATCHERS = {"run_in_executor", "Thread", "Process", "create_task"}


def body_calls(fn: FunctionInfo) -> Iterator[ast.Call]:
    """Every ``ast.Call`` lexically in ``fn``, excluding nested ``def``s."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn.node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue  # separate call-graph node
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def called_names(fn: FunctionInfo) -> List[Tuple[str, int]]:
    """(callee name, line) for every call edge leaving ``fn``."""
    out: List[Tuple[str, int]] = []
    for call in body_calls(fn):
        func = call.func
        if isinstance(func, ast.Attribute):
            name = func.attr
        elif isinstance(func, ast.Name):
            name = func.id
        else:
            continue
        if name in _ESCAPE_DISPATCHERS:
            continue
        out.append((name, call.lineno))
    return out


def reachable_from_async(
    index: RepoIndex,
    root_prefix: str,
    resolve_prefixes: Tuple[str, ...] = (),
) -> Tuple[Dict[str, FunctionInfo], List[Tuple[FunctionInfo, FunctionInfo, int]]]:
    """Functions reachable on the loop thread from async roots.

    Roots are every ``async def`` under ``root_prefix`` (e.g.
    ``src/repro_torch/runtime/``).  ``resolve_prefixes`` limits which files
    call edges may land in (the control-plane packages) so the name-based
    resolution cannot wander into unrelated same-named functions in other
    subsystems.  Returns ``(reached, worker_side_calls)``: ``reached``
    maps ``path:qualname`` to the function (bodies the R1 scan must
    cover), and ``worker_side_calls`` lists every resolved edge from
    reached code into a ``@worker_side`` function as
    ``(caller, callee, call line)`` — each is an R1 boundary violation.
    """
    roots = [
        fn
        for fn in index.src_functions(root_prefix)
        if fn.is_async and not fn.worker_side
    ]
    reached: Dict[str, FunctionInfo] = {}
    boundary: List[Tuple[FunctionInfo, FunctionInfo, int]] = []
    seen_edges: Set[Tuple[str, str]] = set()
    stack = list(roots)
    while stack:
        fn = stack.pop()
        key = f"{fn.path}:{fn.qualname}"
        if key in reached:
            continue
        reached[key] = fn
        for name, line in called_names(fn):
            for callee in index.resolve_call(name):
                if resolve_prefixes and not callee.path.startswith(resolve_prefixes):
                    continue
                ckey = f"{callee.path}:{callee.qualname}"
                if (key, ckey) in seen_edges:
                    continue
                seen_edges.add((key, ckey))
                if callee.worker_side:
                    boundary.append((fn, callee, line))
                    continue  # never scan worker-side bodies
                if ckey not in reached:
                    stack.append(callee)
    return reached, boundary

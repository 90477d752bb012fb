"""Explicit-state model checker for the delivery protocol.

Explores *every* interleaving of a bounded configuration (default: 2
workers × 1 PE each × 3 messages, one SIGKILL injectable at any step) of
the message×worker×PE product machine, where the legal moves are read
from the protocol manifest (``machines.py``) — the same machines rule R7
extracts from the runtime and rule R8 replays against event logs.

The model is the **master-side mirror view**, which is what the harvest
path actually works from: a completion a worker flushed before dying
travels the data channel as a frame; ``kill`` first drains the victim's
frames (each nondeterministically applied or lost with the severed
pipe), then harvests whatever the mirror still shows in flight.  The
in-process transport's atomic completion is the interleaving where
``flush`` and ``apply`` run back-to-back, so one model covers both
transports.

Checked invariants (fixed — deliberately *not* read from the manifest,
so a manifest mutation is caught as a violation rather than silently
redefining correctness):

I1  at-least-once / no-loss: every terminal state has every message
    completed exactly once; no reachable state has no enabled action
    while work remains.
I2  no duplicate completion: a message never completes twice.
I3  a message is only pulled out of ``enqueued`` / ``requeued``.
I4  kill-harvest never races a completion: a harvested message is in
    ``pulled``/``started`` — never ``completed`` — at harvest time.

Counterexamples are returned as step-by-step interleaving traces
(``Violation.trace``).  Scale-down (``worker.deactivate``) and PE idle
timeout (``pe.exit``) are excluded from the explored actions: neither
can fire in the bounded configuration (the explorer drives messages
back-to-back, so no PE idles out), and both remain in the machines for
R8's replay.

Seeded-mutation hooks, used by the tests to prove the checker can fail:
``drop_transition(manifest, event)`` removes an edge (dropping
``msg.requeued`` makes the kill path provably lose work), and
``explore(..., unsafe_harvest=True)`` models a kill that harvests from
the pre-drain mirror (the historical harvest/completion race), which I2
and I4 catch with a duplicate-completion trace.
"""

from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from .machines import Machine, machines_from_manifest

__all__ = ["BoundedConfig", "Violation", "ExploreResult", "explore",
           "drop_transition", "render_trace"]


@dataclasses.dataclass(frozen=True)
class BoundedConfig:
    workers: int = 2
    pes_per_worker: int = 1
    messages: int = 3
    kills: int = 1


@dataclasses.dataclass
class Violation:
    invariant: str           # "I1".."I4"
    message: str
    trace: List[str]         # action labels from the initial state


@dataclasses.dataclass
class ExploreResult:
    states: int
    transitions: int
    violations: List[Violation]

    @property
    def ok(self) -> bool:
        return not self.violations


def drop_transition(manifest: dict, event: str, entity: str = None) -> dict:
    """A deep-copied manifest with every ``event`` edge removed (the
    seeded-mutation hook: the checker must produce a counterexample)."""
    mut = json.loads(json.dumps(manifest))
    for name, ent in mut.get("entities", {}).items():
        if entity is not None and name != entity:
            continue
        ent["transitions"] = [
            tr for tr in ent["transitions"] if tr["event"] != event
        ]
    return mut


# ---------------------------------------------------------------------------
# state encoding
#
# workers: tuple of state strings ("created"/"booting"/"active"/"off";
#          a killed slot additionally lands in `dead`)
# pes:     tuple of (state, holder_msg_or_-1, flushed_bool); pe i lives
#          on worker i // pes_per_worker
# msgs:    tuple of (state, done_count)
# kills_left, dead: frozenset of killed worker indices
# ---------------------------------------------------------------------------

State = Tuple[tuple, tuple, tuple, int, FrozenSet[int]]


def _allowed(machine: Optional[Machine], event: str, state: str
             ) -> Optional[str]:
    """dst if the machine allows ``event`` from ``state``, else None."""
    if machine is None:
        return None
    for tr in machine.by_event(event):
        if state in tr.src:
            return tr.dst
    return None


def explore(
    manifest: dict,
    config: BoundedConfig = BoundedConfig(),
    unsafe_harvest: bool = False,
    max_states: int = 2_000_000,
) -> ExploreResult:
    """Breadth-first exploration of every interleaving; stops at the
    first invariant violation (with its counterexample trace) or when
    the reachable space is exhausted."""
    machines = machines_from_manifest(manifest)
    m_msg = machines.get("msg")
    m_wrk = machines.get("worker")
    m_pe = machines.get("pe")
    cfg = config
    n_pes = cfg.workers * cfg.pes_per_worker

    def worker_of(p: int) -> int:
        return p // cfg.pes_per_worker

    init: State = (
        tuple(["created"] * cfg.workers),
        tuple([("created", -1, False)] * n_pes),
        tuple([("created", 0)] * cfg.messages),
        cfg.kills,
        frozenset(),
    )

    parents: Dict[State, Tuple[Optional[State], str]] = {init: (None, "")}
    seen = {init}
    frontier = deque([init])
    n_transitions = 0

    def trace_of(state: State, last: Optional[str] = None) -> List[str]:
        steps: List[str] = []
        cur: Optional[State] = state
        while cur is not None:
            prev, label = parents[cur]
            if label:
                steps.append(label)
            cur = prev
        steps.reverse()
        if last:
            steps.append(last)
        return steps

    def successors(state: State):
        """Yield (label, next_state) — or a Violation raised via list."""
        workers, pes, msgs, kills_left, dead = state

        # worker boot / activate
        for w in range(cfg.workers):
            if w in dead:
                continue
            dst = _allowed(m_wrk, "worker.boot", workers[w])
            if dst is not None:
                nw = list(workers)
                nw[w] = dst
                yield f"boot worker {w}", (tuple(nw), pes, msgs,
                                           kills_left, dead)
            dst = _allowed(m_wrk, "worker.active", workers[w])
            if dst is not None:
                nw = list(workers)
                nw[w] = dst
                yield f"activate worker {w}", (tuple(nw), pes, msgs,
                                               kills_left, dead)

        # message arrival
        for i in range(cfg.messages):
            dst = _allowed(m_msg, "msg.enqueued", msgs[i][0])
            if dst is not None:
                nm = list(msgs)
                nm[i] = (dst, msgs[i][1])
                yield f"enqueue msg {i}", (workers, pes, tuple(nm),
                                           kills_left, dead)

        # PE lifecycle + the pull-execute loop
        for p in range(n_pes):
            w = worker_of(p)
            st, holder, flushed = pes[p]
            if w in dead:
                continue
            # spawn (placement gates on an ACTIVE worker)
            dst = _allowed(m_pe, "pe.spawn", st)
            if dst is not None and workers[w] == "active":
                np_ = list(pes)
                np_[p] = (dst, -1, False)
                yield f"spawn pe {p} on worker {w}", (
                    workers, tuple(np_), msgs, kills_left, dead)
            # internal readiness (ε edges scheduled as ordinary steps)
            for tr in (m_pe.internal_edges() if m_pe else ()):
                if st in tr.src:
                    np_ = list(pes)
                    np_[p] = (tr.dst, holder, flushed)
                    yield f"pe {p} {tr.event} ({st}->{tr.dst})", (
                        workers, tuple(np_), msgs, kills_left, dead)
            # pull: any eligible message (superset of FIFO order)
            if holder == -1:
                pe_dst = _allowed(m_pe, "msg.pulled", st)
                if pe_dst is not None and workers[w] == "active":
                    for i in range(cfg.messages):
                        msg_dst = _allowed(m_msg, "msg.pulled", msgs[i][0])
                        if msg_dst is None:
                            continue
                        if msgs[i][0] not in ("enqueued", "requeued"):
                            raise _Stop(Violation(
                                "I3",
                                f"msg {i} pulled out of state "
                                f"{msgs[i][0]!r} — only enqueued/requeued "
                                f"messages may be pulled",
                                trace_of(state, f"pull msg {i} at pe {p}"),
                            ))
                        np_ = list(pes)
                        np_[p] = (pe_dst, i, False)
                        nm = list(msgs)
                        nm[i] = (msg_dst, msgs[i][1])
                        yield f"pull msg {i} at pe {p}", (
                            workers, tuple(np_), tuple(nm),
                            kills_left, dead)
            else:
                i = holder
                # start executing
                msg_dst = _allowed(m_msg, "msg.started", msgs[i][0])
                if msg_dst is not None:
                    nm = list(msgs)
                    nm[i] = (msg_dst, msgs[i][1])
                    yield f"start msg {i} at pe {p}", (
                        workers, pes, tuple(nm), kills_left, dead)
                # flush the completion frame onto the data channel
                if not flushed and msgs[i][0] == "started":
                    np_ = list(pes)
                    np_[p] = (st, holder, True)
                    yield f"flush completion of msg {i} from pe {p}", (
                        workers, tuple(np_), msgs, kills_left, dead)
                # master applies the frame (poller / inproc bookkeeping)
                if flushed:
                    msg_dst = _allowed(m_msg, "msg.completed", msgs[i][0])
                    pe_dst = _allowed(m_pe, "msg.completed", st)
                    if msg_dst is not None and pe_dst is not None:
                        done = msgs[i][1] + 1
                        if done > 1:
                            raise _Stop(Violation(
                                "I2",
                                f"msg {i} completed {done} times",
                                trace_of(state,
                                         f"apply completion of msg {i}"),
                            ))
                        np_ = list(pes)
                        np_[p] = (pe_dst, -1, False)
                        nm = list(msgs)
                        nm[i] = (msg_dst, done)
                        yield f"apply completion of msg {i} from pe {p}", (
                            workers, tuple(np_), tuple(nm),
                            kills_left, dead)

        # SIGKILL injection
        if kills_left > 0:
            for w in range(cfg.workers):
                if w in dead or workers[w] in ("created", "off"):
                    continue
                yield from _kill_branches(state, w)

    class _Stop(Exception):
        def __init__(self, violation: Violation):
            self.violation = violation

    def _kill_branches(state: State, w: int):
        workers, pes, msgs, kills_left, dead = state
        my_pes = [p for p in range(n_pes) if worker_of(p) == w]
        flushed_pes = [p for p in my_pes if pes[p][2]]
        # the mirror the harvest works from: post-drain normally,
        # pre-drain under the seeded unsafe_harvest mutation
        for mask in range(1 << len(flushed_pes)):
            applied = {flushed_pes[b] for b in range(len(flushed_pes))
                       if mask & (1 << b)}
            np_ = list(pes)
            nm = list(msgs)
            labels = []
            harvest_list = (
                [(p, pes[p][1]) for p in my_pes if pes[p][1] != -1]
                if unsafe_harvest else None
            )
            bad: Optional[Violation] = None
            for p in applied:  # drained frames that survived the pipe
                i = np_[p][1]
                done = nm[i][1] + 1
                if done > 1:
                    bad = Violation(
                        "I2", f"msg {i} completed {done} times",
                        trace_of(state, f"kill worker {w} "
                                        f"(drain applies pe {p})"))
                    break
                dst = _allowed(m_msg, "msg.completed", nm[i][0])
                nm[i] = (dst if dst is not None else nm[i][0], done)
                np_[p] = (np_[p][0], -1, False)
                labels.append(f"apply pe {p}")
            if bad is not None:
                raise _Stop(bad)
            if harvest_list is None:
                harvest_list = [(p, np_[p][1]) for p in my_pes
                                if np_[p][1] != -1]
            for p, i in harvest_list:  # harvest the rest of the mirror
                if nm[i][0] == "completed":
                    raise _Stop(Violation(
                        "I4",
                        f"kill-harvest of worker {w} raced msg {i}'s "
                        f"completion: harvested while already completed",
                        trace_of(state, f"kill worker {w} (harvest "
                                        f"races completion of msg {i})"),
                    ))
                dst = _allowed(m_msg, "msg.requeued", nm[i][0])
                if dst is None:
                    raise _Stop(Violation(
                        "I1",
                        f"kill of worker {w} found msg {i} in state "
                        f"{nm[i][0]!r} with no requeue edge — the "
                        f"message is lost (at-least-once broken)",
                        trace_of(state, f"kill worker {w} (msg {i} "
                                        f"unharvestable)"),
                    ))
                nm[i] = (dst, nm[i][1])
                labels.append(f"requeue msg {i}")
            for p in my_pes:
                np_[p] = ("stopped", -1, False)
            nw = list(workers)
            nw[w] = "off"
            drop = sorted(set(flushed_pes) - applied)
            label = f"kill worker {w}"
            extra = labels + ([f"drop pe {p} frame" for p in drop])
            if extra:
                label += " (" + ", ".join(extra) + ")"
            yield label, (tuple(nw), tuple(np_), tuple(nm),
                          kills_left - 1, dead | {w})

    while frontier:
        state = frontier.popleft()
        any_succ = False
        try:
            for label, nxt in successors(state):
                n_transitions += 1
                any_succ = True
                if nxt not in seen:
                    if len(seen) >= max_states:
                        return ExploreResult(
                            len(seen), n_transitions,
                            [Violation(
                                "bound",
                                f"state-space bound {max_states} hit — "
                                f"shrink the configuration",
                                [])],
                        )
                    seen.add(nxt)
                    parents[nxt] = (state, label)
                    frontier.append(nxt)
        except _Stop as stop:
            return ExploreResult(len(seen), n_transitions, [stop.violation])
        if not any_succ:
            # terminal state: I1 — all work done, exactly once
            msgs = state[2]
            for i, (st, done) in enumerate(msgs):
                if st != "completed" or done != 1:
                    return ExploreResult(
                        len(seen), n_transitions,
                        [Violation(
                            "I1",
                            f"terminal state with msg {i} in state "
                            f"{st!r} (completed {done}x) — work lost "
                            f"or stuck",
                            trace_of(state),
                        )],
                    )
    return ExploreResult(len(seen), n_transitions, [])


def render_trace(violation: Violation) -> str:
    lines = [f"[{violation.invariant}] {violation.message}",
             "counterexample interleaving:"]
    for n, step in enumerate(violation.trace, 1):
        lines.append(f"  step {n:>3}: {step}")
    return "\n".join(lines)

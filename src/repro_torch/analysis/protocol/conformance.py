"""Trace conformance (rule R8's replay core).

Replays a recorded ``events.jsonl`` log against the protocol machines:
every event advances the machine of each entity that carries it, keyed
by the event's identity fields (``msg_id`` for messages, ``worker`` for
slots, ``(worker, pe)`` for PEs).  Violations are happens-before bugs
the event schema alone cannot see — a ``msg.pulled`` with no preceding
``msg.enqueued``/``msg.requeued``, a second completion for the same
message, events for a worker slot after its failing ``worker.kill``.

Internal transitions (``ready`` — no dot in the event name) never
appear in logs; the replay closes over them as ε-edges, so a
zero-boot-delay worker that was born active or a PE whose readiness
event is unobserved does not fail conformance.

End-of-log semantics: a message still ``pulled``/``started`` when the
log ends is in-flight limbo — delivery was lost, a violation.  Messages
still ``enqueued``/``requeued``/unseen are *backlog*, not a violation:
the live driver legitimately exits early under ``starvation_grace``
with work still queued.  The backlog count is reported in the summary.

Shared by rule R8 (``rules.check_trace_conformance``), ``python -m
repro_torch.analysis.protocol conformance <log>`` and ``python -m
repro_torch.obs conformance <log>``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .machines import Machine, machines_from_manifest

__all__ = ["ConformanceViolation", "ReplaySummary", "replay_events",
           "load_events_file"]


@dataclasses.dataclass
class ConformanceViolation:
    seq: int
    event: str
    entity: str
    key: tuple
    message: str

    def __str__(self) -> str:
        key = ",".join(str(k) for k in self.key)
        return (f"seq {self.seq}: {self.event} [{self.entity} {key}] "
                f"{self.message}")


@dataclasses.dataclass
class ReplaySummary:
    events: int = 0
    violations: List[ConformanceViolation] = dataclasses.field(
        default_factory=list)
    #: messages the log ends with still queued (legal: starvation-grace
    #: early exit) — reported, not flagged
    backlog: int = 0
    completed: int = 0
    requeued: int = 0

    @property
    def ok(self) -> bool:
        return not self.violations


def load_events_file(path: Path) -> Tuple[List[dict], List[str]]:
    """(events, errors) from a JSONL log; bad lines are errors, not
    crashes — a truncated log from a killed run must still replay."""
    events: List[dict] = []
    errors: List[str] = []
    try:
        text = Path(path).read_text(encoding="utf-8")
    except OSError as exc:
        return [], [f"unreadable log {path}: {exc}"]
    for n, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            errors.append(f"{path}:{n}: not valid JSON — skipped")
            continue
        if not isinstance(ev, dict) or "ev" not in ev:
            errors.append(f"{path}:{n}: not an event envelope — skipped")
            continue
        events.append(ev)
    return events, errors


def _epsilon_reach(machine: Machine, state: str, targets: Set[str]
                   ) -> Optional[str]:
    """Follow internal ε-edges from ``state`` to any state in
    ``targets``; returns the reached state or None."""
    seen = {state}
    frontier = [state]
    while frontier:
        cur = frontier.pop()
        if cur in targets:
            return cur
        for tr in machine.internal_edges():
            if cur in tr.src and tr.dst not in seen:
                seen.add(tr.dst)
                frontier.append(tr.dst)
    return None


def replay_events(
    events: Iterable[dict], manifest: dict, strict_end: bool = True
) -> ReplaySummary:
    """Replay a log against the manifest's machines."""
    machines = machines_from_manifest(manifest)
    ignore = set(manifest.get("ignore_events", ()))
    summary = ReplaySummary()

    # entity -> key -> state; dead instances reject every further event
    states: Dict[str, Dict[tuple, str]] = {m: {} for m in machines}
    dead: Dict[str, Set[tuple]] = {m: set() for m in machines}
    # pe ownership, for scope="worker" transitions
    pes_of_worker: Dict[object, Set[tuple]] = {}

    known_events: Dict[str, List[str]] = {}
    for name, machine in machines.items():
        for ev in machine.events():
            known_events.setdefault(ev, []).append(name)

    for ev in events:
        etype = ev.get("ev")
        seq = int(ev.get("seq", summary.events))
        summary.events += 1
        if etype in ignore or etype not in known_events:
            continue
        if etype == "msg.completed":
            summary.completed += 1
        elif etype == "msg.requeued":
            summary.requeued += 1
        for entity in known_events[etype]:
            machine = machines[entity]
            transitions = machine.by_event(etype)
            scoped = [tr for tr in transitions if tr.scope == "worker"]
            if scoped and entity == "pe":
                # apply to every PE owned by the event's worker; PEs not
                # in a source state (already stopped) are skipped
                widx = ev.get("worker")
                for pe_key in sorted(pes_of_worker.get(widx, ()),
                                     key=str):
                    st = states[entity].get(pe_key, machine.initial)
                    for tr in scoped:
                        landed = st if st in tr.src else _epsilon_reach(
                            machine, st, set(tr.src))
                        if landed is not None:
                            states[entity][pe_key] = tr.dst
                            break
                continue
            try:
                key = tuple(ev[f] for f in machine.key)
            except KeyError as exc:
                summary.violations.append(ConformanceViolation(
                    seq, etype, entity, (),
                    f"event lacks identity field {exc.args[0]!r}",
                ))
                continue
            st = states[entity].get(key)
            if key in dead[entity]:
                summary.violations.append(ConformanceViolation(
                    seq, etype, entity, key,
                    f"event for a failed {entity} instance — a killed "
                    f"slot must never produce further events",
                ))
                continue
            if st is None:
                st = machine.initial
            if st in machine.terminal:
                summary.violations.append(ConformanceViolation(
                    seq, etype, entity, key,
                    f"event after terminal state {st!r}"
                    + (" — duplicate completion"
                       if etype == "msg.completed" else ""),
                ))
                continue
            applied = False
            for tr in transitions:
                landed = st if st in tr.src else _epsilon_reach(
                    machine, st, set(tr.src))
                if landed is None:
                    continue
                states[entity][key] = tr.dst
                if tr.failing:
                    dead[entity].add(key)
                applied = True
                break
            if not applied:
                allowed = sorted({s for tr in transitions for s in tr.src})
                summary.violations.append(ConformanceViolation(
                    seq, etype, entity, key,
                    f"illegal from state {st!r} (allowed from {allowed})",
                ))
                continue
            if entity == "pe":
                pes_of_worker.setdefault(ev.get("worker"), set()).add(key)

    if strict_end and "msg" in machines:
        for key, st in sorted(states["msg"].items(), key=str):
            if st in ("pulled", "started"):
                summary.violations.append(ConformanceViolation(
                    -1, "<end-of-log>", "msg", key,
                    f"log ends with the message in-flight (state {st!r}) "
                    f"— neither completed nor requeued: delivery lost",
                ))
            elif st not in ("completed",):
                summary.backlog += 1
    return summary

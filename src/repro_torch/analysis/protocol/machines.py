"""Entity state machines and their committed manifest.

The delivery protocol is modeled as three state machines — one per
entity kind the runtime tracks:

``msg``
    a stream message: ``created → enqueued → pulled → started →
    completed``, with ``requeued`` re-entering the pull edge (the
    at-least-once path a worker kill takes);
``worker``
    a worker slot: ``created → booting → active → off`` (scale-down) or
    ``→ off`` via the failing ``worker.kill`` edge (the slot is dead and
    never reboots);
``pe``
    a processing element: ``created → starting → idle ⇄ busy → stopped``.

Transitions are *declared in the runtime itself* with the
``@transition`` decorator (``runtime.annotations``); ``extract.py``
verifies each declaration against AST evidence, assembles the machines,
and diffs them against the committed ``protocol_manifest.json`` next to
this module (rule R7).  The same machines drive the explicit-state model
checker (``explore.py``) and the event-log replay (``conformance.py``,
rule R8) — one model, three consumers.

A transition whose ``event`` contains no dot (e.g. ``ready``) is
*internal*: a state change that produces no observability event.  The
replay treats internal edges as ε-transitions; the explorer schedules
them as ordinary steps.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Transition",
    "Machine",
    "ENTITY_SPEC",
    "PROTOCOL_MANIFEST_PATH",
    "machines_to_manifest",
    "machines_from_manifest",
    "load_committed_manifest",
    "diff_manifests",
]

#: Repo-relative path of the committed protocol manifest.
PROTOCOL_MANIFEST_PATH = "src/repro_torch/analysis/protocol/protocol_manifest.json"

#: Per-entity structure that is not itself extracted: the event fields
#: that key an instance, the initial/terminal states, and which
#: ``core.sim`` enum (if any) the state names must come from.
ENTITY_SPEC: Dict[str, Dict[str, object]] = {
    "msg": {
        "key": ("msg_id",),
        "initial": "created",
        "terminal": ("completed",),
        "enum": None,
    },
    "worker": {
        "key": ("worker",),
        "initial": "created",
        "terminal": (),
        "enum": "WorkerState",
    },
    "pe": {
        "key": ("worker", "pe"),
        "initial": "created",
        "terminal": ("stopped",),
        "enum": "PEState",
    },
}


@dataclasses.dataclass(frozen=True)
class Transition:
    """One edge of an entity machine (possibly declared at many sites)."""

    entity: str
    event: str            # pinned event type, or internal name (no dot)
    src: Tuple[str, ...]  # sorted source states
    dst: str
    failing: bool = False
    scope: Optional[str] = None   # None or "worker" (all PEs of the worker)
    sites: Tuple[str, ...] = ()   # "path:qualname" declaration sites

    @property
    def internal(self) -> bool:
        return "." not in self.event

    def to_json(self) -> Dict[str, object]:
        return {
            "event": self.event,
            "src": list(self.src),
            "dst": self.dst,
            "failing": self.failing,
            "scope": self.scope,
            "sites": list(self.sites),
        }


@dataclasses.dataclass
class Machine:
    """One entity's state machine."""

    entity: str
    key: Tuple[str, ...]
    initial: str
    terminal: Tuple[str, ...]
    transitions: List[Transition]

    @property
    def states(self) -> List[str]:
        out = {self.initial, *self.terminal}
        for tr in self.transitions:
            out.update(tr.src)
            out.add(tr.dst)
        return sorted(out)

    def by_event(self, event: str) -> List[Transition]:
        return [tr for tr in self.transitions if tr.event == event]

    def events(self) -> List[str]:
        return sorted({tr.event for tr in self.transitions if not tr.internal})

    def internal_edges(self) -> List[Transition]:
        return [tr for tr in self.transitions if tr.internal]

    def to_json(self) -> Dict[str, object]:
        return {
            "key": list(self.key),
            "initial": self.initial,
            "terminal": list(self.terminal),
            "states": self.states,
            "transitions": [
                tr.to_json()
                for tr in sorted(
                    self.transitions, key=lambda t: (t.event, t.dst, t.src)
                )
            ],
        }


def machines_to_manifest(
    machines: Dict[str, Machine], wire: Optional[dict] = None
) -> dict:
    """Serialize machines (+ the wire-frame section) canonically."""
    return {
        "_comment": (
            "Extracted master-worker protocol (rule R7). Regenerate with: "
            "PYTHONPATH=src python -m repro_torch.analysis.protocol extract --write"
        ),
        "version": 1,
        "entities": {
            name: machines[name].to_json() for name in sorted(machines)
        },
        "wire": wire or {},
        "ignore_events": ["irm.pack"],
    }


def machines_from_manifest(manifest: dict) -> Dict[str, Machine]:
    machines: Dict[str, Machine] = {}
    for name, ent in manifest.get("entities", {}).items():
        machines[name] = Machine(
            entity=name,
            key=tuple(ent["key"]),
            initial=ent["initial"],
            terminal=tuple(ent["terminal"]),
            transitions=[
                Transition(
                    entity=name,
                    event=tr["event"],
                    src=tuple(tr["src"]),
                    dst=tr["dst"],
                    failing=bool(tr.get("failing", False)),
                    scope=tr.get("scope"),
                    sites=tuple(tr.get("sites", ())),
                )
                for tr in ent["transitions"]
            ],
        )
    return machines


def load_committed_manifest() -> dict:
    """The manifest shipped inside this package (runtime consumers —
    the obs ``conformance`` subcommand — load it without needing a repo
    checkout; rule R7 reads the root-relative copy instead so fixture
    trees can pin their own)."""
    here = Path(__file__).resolve().parent
    with open(here / "protocol_manifest.json", encoding="utf-8") as fh:
        return json.load(fh)


def _transition_key(tr: dict) -> Tuple[str, str]:
    return (tr["event"], tr["dst"])


def diff_manifests(extracted: dict, committed: dict) -> List[str]:
    """Human-readable drift lines between two manifests ([] if none)."""
    out: List[str] = []
    ext_e = extracted.get("entities", {})
    com_e = committed.get("entities", {})
    for name in sorted(set(ext_e) - set(com_e)):
        out.append(f"entity {name!r} extracted from code but not committed")
    for name in sorted(set(com_e) - set(ext_e)):
        out.append(f"entity {name!r} committed but no longer extracted")
    for name in sorted(set(ext_e) & set(com_e)):
        ext_t = {_transition_key(t): t for t in ext_e[name]["transitions"]}
        com_t = {_transition_key(t): t for t in com_e[name]["transitions"]}
        for k in sorted(set(ext_t) - set(com_t)):
            out.append(
                f"{name}: transition {k[0]!r}->{k[1]!r} declared in code "
                f"but not committed"
            )
        for k in sorted(set(com_t) - set(ext_t)):
            out.append(
                f"{name}: transition {k[0]!r}->{k[1]!r} committed but no "
                f"longer declared in code"
            )
        for k in sorted(set(ext_t) & set(com_t)):
            for field in ("src", "failing", "scope", "sites"):
                if ext_t[k].get(field) != com_t[k].get(field):
                    out.append(
                        f"{name}: transition {k[0]!r}->{k[1]!r} field "
                        f"{field!r} drifted: code {ext_t[k].get(field)!r} "
                        f"vs committed {com_t[k].get(field)!r}"
                    )
        for field in ("key", "initial", "terminal"):
            if list(ext_e[name].get(field, [])) != list(
                com_e[name].get(field, [])
            ):
                out.append(
                    f"{name}: {field} drifted: code "
                    f"{ext_e[name].get(field)!r} vs committed "
                    f"{com_e[name].get(field)!r}"
                )
    if extracted.get("wire") != committed.get("wire"):
        ext_w, com_w = extracted.get("wire", {}), committed.get("wire", {})
        for section in sorted(set(ext_w) | set(com_w)):
            if ext_w.get(section) != com_w.get(section):
                out.append(
                    f"wire section {section!r} drifted: code "
                    f"{json.dumps(ext_w.get(section), sort_keys=True)} vs "
                    f"committed "
                    f"{json.dumps(com_w.get(section), sort_keys=True)}"
                )
    return out

"""Rules R7 (protocol model) and R8 (trace conformance).

R7 = extraction + drift + bounded model check, all static:

- every ``@transition`` declaration in the four protocol modules is
  verified against AST evidence, and every protocol ``bus.emit`` /
  mirror assignment is covered by a declaration (``extract.py``);
- the assembled machines must equal the committed
  ``protocol_manifest.json`` (drift findings, like R4);
- the committed machines are then *model-checked*: the bounded
  2-worker × 1-PE × 3-message configuration with one injectable SIGKILL
  is exhaustively explored and the delivery invariants (at-least-once,
  no duplicate completion, pull-from-queue-only, harvest never races a
  completion) must hold on every interleaving.  A violation carries its
  counterexample trace in the finding message.

R8 replays recorded ``events.jsonl`` logs against the same machines —
it only fires when it is given logs; with none to check it is a clean
no-op.

Both report a protocol module (or the enums' module) that does not parse
as a ``parse`` finding first: an unparseable file is never a clean file.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Sequence

from ..model import Finding, RepoIndex
from .conformance import load_events_file, replay_events
from .explore import BoundedConfig, explore
from .extract import PROTOCOL_MODULES, SIM_PATH, extract_findings
from .machines import PROTOCOL_MANIFEST_PATH

__all__ = ["check_protocol_model", "check_trace_conformance",
           "iter_event_logs"]


def _parse_findings(index: RepoIndex) -> List[Finding]:
    for path in (*PROTOCOL_MODULES, SIM_PATH):
        index.module(path)
    return list(index.parse_findings)


def check_protocol_model(index: RepoIndex, root) -> List[Finding]:
    """R7: extraction ↔ manifest ↔ bounded model check."""
    findings = _parse_findings(index) + extract_findings(index, Path(root))
    manifest_file = Path(root) / PROTOCOL_MANIFEST_PATH
    if not manifest_file.is_file():
        return findings  # extract_findings already flagged it
    try:
        committed = json.loads(manifest_file.read_text(encoding="utf-8"))
    except json.JSONDecodeError:
        return findings  # already flagged
    if not committed.get("entities"):
        return findings
    result = explore(committed, BoundedConfig())
    for v in result.violations:
        trace = "; ".join(v.trace[-8:])
        findings.append(Finding(
            rule="R7",
            path=PROTOCOL_MANIFEST_PATH,
            line=1,
            symbol=v.invariant,
            message=(
                f"model-check violation [{v.invariant}]: {v.message} "
                f"(counterexample tail: {trace}; full trace via python -m "
                f"repro_torch.analysis.protocol check)"
            ),
        ))
    return findings


def iter_event_logs(paths: Sequence[Path]) -> List[Path]:
    """Expand files/directories into concrete events.jsonl paths."""
    logs: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            logs.extend(sorted(p.rglob("events.jsonl")))
        else:
            logs.append(p)
    return logs


def check_trace_conformance(
    index: RepoIndex, root, events: Optional[Sequence[Path]] = None
) -> List[Finding]:
    """R8: replay the given event logs against the committed machines.

    With no ``--events`` paths this is a clean no-op; a missing or
    unreadable log is a finding, never a crash.
    """
    findings = _parse_findings(index)
    if not events:
        return findings
    root = Path(root)
    manifest_file = root / PROTOCOL_MANIFEST_PATH
    if not manifest_file.is_file():
        return findings + [Finding(
            rule="R8", path=PROTOCOL_MANIFEST_PATH, line=1, symbol="",
            message="protocol manifest is missing — cannot replay logs",
        )]
    try:
        manifest = json.loads(manifest_file.read_text(encoding="utf-8"))
    except json.JSONDecodeError as exc:
        return findings + [Finding(
            rule="R8", path=PROTOCOL_MANIFEST_PATH, line=1, symbol="",
            message=f"protocol manifest is not valid JSON: {exc.msg}",
        )]

    logs = iter_event_logs(events)
    if not logs:
        findings.append(Finding(
            rule="R8", path=str(events[0]), line=0, symbol="",
            message="no events.jsonl logs found under the given paths",
        ))
    for log in logs:
        try:
            rel = log.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = str(log)
        evs, errors = load_events_file(log)
        for err in errors:
            findings.append(Finding(
                rule="R8", path=rel, line=0, symbol="",
                message=f"unparseable log content: {err}",
            ))
        summary = replay_events(evs, manifest)
        for v in summary.violations:
            findings.append(Finding(
                rule="R8", path=rel, line=max(v.seq, 0),
                symbol=f"{v.entity}:{','.join(str(k) for k in v.key)}",
                message=f"trace conformance: {v}",
            ))
    return findings

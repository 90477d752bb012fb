"""R6 (event-schema manifest): every observability event the port's
runtime can emit is pinned.

The port's observability plane is an :class:`~repro_torch.obs.bus.EventBus`
threaded through all three backends, with every ``bus.emit(...)`` call
producing an event whose payload schema must be identical across sim,
inproc-live, and multiproc.  The runtime half of that pin is the
cross-backend schema-equality test; this rule is the static half.  It
checks, for every ``.emit`` call on a bus-shaped receiver in
``src/repro_torch/`` (``emit_sites`` finds them):

- the event type is a string literal (a computed type cannot be pinned),
- the type is registered in ``repro_torch/obs/event_manifest.json``
  (drift: a new event emitted without updating the manifest),
- the keyword fields at the call site are exactly the manifest's field
  set for that type (payloads are keyword-only, so the AST *is* the
  schema),

and, mirroring R4's stale/exercised semantics:

- every manifest entry has at least one live emit site (stale manifest),
- every manifest entry appears in the schema test named by the
  manifest's ``schema_test`` key, so a schema regression on any type
  fails a test rather than sailing through.
"""

from __future__ import annotations

import ast
import json
from pathlib import Path
from typing import Dict, List, Set

from .emit_sites import EVENT_MANIFEST_PATH, emit_sites
from .model import SRC_PREFIX, Finding, RepoIndex
from .rules_contracts import _test_tokens

__all__ = ["check_event_schema", "EVENT_MANIFEST_PATH"]


def check_event_schema(index: RepoIndex, root) -> List[Finding]:
    """R6: bus.emit call sites ↔ event manifest ↔ schema test."""
    findings: List[Finding] = []
    manifest_file = Path(root) / EVENT_MANIFEST_PATH
    if not manifest_file.is_file():
        return [
            Finding(
                rule="R6",
                path=EVENT_MANIFEST_PATH,
                line=1,
                symbol="",
                message="event-schema manifest is missing from the tree",
            )
        ]
    manifest = json.loads(manifest_file.read_text(encoding="utf-8"))
    events: Dict[str, List[str]] = manifest["events"]
    emitted_types: Set[str] = set()

    for mod in index.modules.values():
        if not mod.path.startswith(SRC_PREFIX):
            continue
        for call, _recv in emit_sites(mod.tree):
            if not call.args or not (
                isinstance(call.args[0], ast.Constant)
                and isinstance(call.args[0].value, str)
            ):
                findings.append(
                    Finding(
                        rule="R6",
                        path=mod.path,
                        line=call.lineno,
                        symbol="",
                        message=(
                            "bus.emit with a non-literal event type — the "
                            "schema pin needs a string constant"
                        ),
                    )
                )
                continue
            ev = call.args[0].value
            emitted_types.add(ev)
            if ev not in events:
                findings.append(
                    Finding(
                        rule="R6",
                        path=mod.path,
                        line=call.lineno,
                        symbol="",
                        message=(
                            f"event type {ev!r} is emitted but not registered "
                            f"in {EVENT_MANIFEST_PATH} — register its field "
                            f"set AND exercise it in "
                            f"{manifest['schema_test']}"
                        ),
                    )
                )
                continue
            star = [kw for kw in call.keywords if kw.arg is None]
            if star:
                findings.append(
                    Finding(
                        rule="R6",
                        path=mod.path,
                        line=call.lineno,
                        symbol="",
                        message=(
                            f"bus.emit({ev!r}, **...) — payload fields must "
                            f"be explicit keywords so the schema is checkable"
                        ),
                    )
                )
                continue
            actual = {kw.arg for kw in call.keywords if kw.arg}
            declared = set(events[ev])
            for extra in sorted(actual - declared):
                findings.append(
                    Finding(
                        rule="R6",
                        path=mod.path,
                        line=call.lineno,
                        symbol="",
                        message=(
                            f"event-schema drift: field {extra!r} of {ev!r} "
                            f"is emitted here but not in the manifest entry"
                        ),
                    )
                )
            for missing in sorted(declared - actual):
                findings.append(
                    Finding(
                        rule="R6",
                        path=mod.path,
                        line=call.lineno,
                        symbol="",
                        message=(
                            f"event-schema drift: {ev!r} emitted without "
                            f"manifest field {missing!r} — every backend must "
                            f"emit the full pinned field set"
                        ),
                    )
                )

    for ev in sorted(set(events) - emitted_types):
        findings.append(
            Finding(
                rule="R6",
                path=EVENT_MANIFEST_PATH,
                line=1,
                symbol=ev,
                message=(
                    f"stale event manifest: {ev!r} is registered but no "
                    f"bus.emit site in {SRC_PREFIX} produces it"
                ),
            )
        )

    test_path = manifest["schema_test"]
    test_mod = index.module(test_path)
    if test_mod is None:
        findings.append(
            Finding(
                rule="R6",
                path=test_path,
                line=1,
                symbol="",
                message="event-schema test file is missing",
            )
        )
    else:
        tokens = _test_tokens(test_mod.tree)
        for ev in sorted(events):
            if ev not in tokens:
                findings.append(
                    Finding(
                        rule="R6",
                        path=test_path,
                        line=1,
                        symbol=ev,
                        message=(
                            f"event type {ev!r} is never exercised by the "
                            f"schema test — a payload regression on it would "
                            f"go unnoticed"
                        ),
                    )
                )
    return findings

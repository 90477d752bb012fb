"""Protocol model checker: extraction (R7), explicit-state exploration,
and trace conformance (R8) for the master↔worker delivery protocol.

One model, three consumers:

- ``extract.py`` recovers the per-entity state machines (message,
  worker slot, PE) from the runtime's ASTs — ``@transition``
  declarations verified against emit sites, mirror assignments, and
  wire-frame literals — and pins them in ``protocol_manifest.json``;
- ``explore.py`` exhaustively explores a bounded configuration of the
  product machine with SIGKILL injection, proving the delivery
  invariants over *every* interleaving;
- ``conformance.py`` replays recorded ``events.jsonl`` logs against the
  same machines, catching happens-before violations offline.

CLI: ``python -m repro_torch.analysis.protocol {extract,check,conformance}``.
"""

from .conformance import (
    ConformanceViolation,
    ReplaySummary,
    load_events_file,
    replay_events,
)
from .explore import (
    BoundedConfig,
    ExploreResult,
    Violation,
    drop_transition,
    explore,
    render_trace,
)
from .extract import PROTOCOL_MODULES, SIM_PATH, extract_findings, extract_protocol
from .machines import (
    ENTITY_SPEC,
    PROTOCOL_MANIFEST_PATH,
    Machine,
    Transition,
    diff_manifests,
    load_committed_manifest,
    machines_from_manifest,
    machines_to_manifest,
)
from .rules import check_protocol_model, check_trace_conformance

__all__ = [
    "BoundedConfig",
    "ConformanceViolation",
    "ENTITY_SPEC",
    "ExploreResult",
    "Machine",
    "PROTOCOL_MANIFEST_PATH",
    "PROTOCOL_MODULES",
    "ReplaySummary",
    "SIM_PATH",
    "Transition",
    "Violation",
    "check_protocol_model",
    "check_trace_conformance",
    "diff_manifests",
    "drop_transition",
    "explore",
    "extract_findings",
    "extract_protocol",
    "load_committed_manifest",
    "load_events_file",
    "machines_from_manifest",
    "machines_to_manifest",
    "render_trace",
    "replay_events",
]

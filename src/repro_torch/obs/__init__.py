"""Unified observability plane: events, metrics, exporters, analyzer.

One schema across all three backends (sim, live in-process, multiproc):

- :class:`EventBus` — typed event sink (message spans, worker/PE
  lifecycle, IRM decision audit), stamped in both nominal-tick and
  backend time.  Drivers thread it behind ``if bus is not None`` guards.
- :class:`MetricsRegistry` — counters/gauges/fixed-bucket histograms as
  *mergeable deltas*; multiproc workers flush deltas over the existing
  data queue and the master folds them into one view.
- Exporters — JSONL event log, Prometheus text exposition, run-summary
  JSON (``finalize_run`` writes all three).
- Analyzer — ``obs.analyze``: latency decomposition, per-message
  critical paths, the "why did first-fit skip bin 3" audit render, and
  event-log drift reports.

Entry point for callers: ``run_scenario(..., obs=ObsConfig(...))`` or
the CLI's ``--obs-out DIR --obs-level {lifecycle,full}``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .analyze import (
    audit_report,
    drift_report,
    e2e_percentiles,
    fold_events,
    latency_decomposition,
    load_manifest,
    render_drift,
    schema_of,
    summarize,
    validate_events,
)
from .audit import emit_packing_audit, explain_rejections
from .bus import ENVELOPE_FIELDS, EventBus
from .exporters import (
    finalize_run,
    fold_transport_stats,
    load_events,
    prometheus_text,
    run_summary,
    write_jsonl,
    write_run_summary,
)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = [
    "ObsConfig",
    "EventBus",
    "ENVELOPE_FIELDS",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "emit_packing_audit",
    "explain_rejections",
    "finalize_run",
    "fold_events",
    "fold_transport_stats",
    "write_jsonl",
    "load_events",
    "prometheus_text",
    "run_summary",
    "write_run_summary",
    "latency_decomposition",
    "e2e_percentiles",
    "schema_of",
    "validate_events",
    "load_manifest",
    "drift_report",
    "render_drift",
    "audit_report",
    "summarize",
]


@dataclasses.dataclass
class ObsConfig:
    """What the engine should observe and where to put it.

    ``out=None`` keeps everything in memory (``ScenarioResult.obs``);
    a path writes ``events.jsonl`` / ``metrics.prom`` / ``summary.json``
    into that directory at finalize.  ``level="lifecycle"`` drops the
    IRM decision audit (``irm.pack`` events + allocator capture).
    """

    out: Optional[str] = None
    level: str = "full"

"""Exporters: JSONL event log, Prometheus text exposition, run summary.

These are the only obs modules that touch the filesystem, and they are
called exclusively from synchronous engine/CLI code after a run has
drained — never from the event loop or a worker (R1 keeps it that way).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Iterable, List, Optional

from .metrics import MetricsRegistry

RUN_SUMMARY_SCHEMA = 1

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def write_jsonl(path, events: Iterable[dict]) -> None:
    """One event per line, key order preserved from the envelope."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w", encoding="utf-8") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")


def load_events(path) -> List[dict]:
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def prometheus_text(registry: MetricsRegistry) -> str:
    """Prometheus text exposition (name-sorted, deterministic)."""
    lines = []
    for name, snap in registry.snapshot().items():
        pname = _prom_name(name)
        kind = snap["type"]
        lines.append(f"# TYPE {pname} {kind}")
        if kind in ("counter", "gauge"):
            lines.append(f"{pname} {snap['value']}")
        else:  # histogram
            cum = 0
            for bound, c in zip(snap["bounds"], snap["counts"][:-1],
                                strict=True):
                cum += c
                lines.append(f'{pname}_bucket{{le="{bound}"}} {cum}')
            cum += snap["counts"][-1]
            lines.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{pname}_sum {snap['sum']}")
            lines.append(f"{pname}_count {snap['count']}")
    return "\n".join(lines) + "\n"


def run_summary(registry: MetricsRegistry,
                extra: Optional[dict] = None) -> dict:
    out = {"schema": RUN_SUMMARY_SCHEMA, "metrics": registry.snapshot()}
    if extra:
        out.update(extra)
    return out


def write_run_summary(path, registry: MetricsRegistry,
                      extra: Optional[dict] = None) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(run_summary(registry, extra), indent=2) + "\n",
                 encoding="utf-8")


#: ``Transport.stats()`` keys promoted to first-class run-summary metrics
#: (they previously died inside the transport unless a caller dug).
TRANSPORT_METRIC_KEYS = (
    "profiler_drift_pp",
    "ser_bytes_per_msg",
    "ser_ms_per_msg",
    "serialize_ms",
    "data_bytes_out",
    "data_bytes_in",
    "data_msgs_out",
    "data_msgs_in",
    "workers_spawned",
)


def fold_transport_stats(registry: MetricsRegistry, stats: dict) -> None:
    """Surface the transport's counters as ``transport.*`` gauges."""
    for key in TRANSPORT_METRIC_KEYS:
        v = stats.get(key)
        if isinstance(v, (int, float)):
            registry.gauge(f"transport.{key}").set(float(v))


def finalize_run(bus, *, out=None, transport_stats: Optional[dict] = None,
                 extra: Optional[dict] = None) -> None:
    """Post-run folding + optional export.

    Derives master-side metrics from the event log, merges the transport
    counters, drops the bus's clock closure (so results survive the
    sweep pool's pickling), and — when ``out`` is set — writes
    ``events.jsonl``, ``metrics.prom``, and ``summary.json`` into it.
    """
    from .analyze import fold_events  # local import: avoid cycle

    fold_events(bus.registry, bus.events)
    if transport_stats:
        fold_transport_stats(bus.registry, transport_stats)
    bus.now = None
    if out is not None:
        d = Path(out)
        d.mkdir(parents=True, exist_ok=True)
        write_jsonl(d / "events.jsonl", bus.events)
        (d / "metrics.prom").write_text(prometheus_text(bus.registry),
                                        encoding="utf-8")
        write_run_summary(d / "summary.json", bus.registry, extra=extra)

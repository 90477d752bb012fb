"""Event-log analysis: spans, latency decomposition, audit & drift reports.

Everything here consumes a plain list of event dicts (in-memory from an
:class:`~obs.bus.EventBus` or loaded from a JSONL log) — the
analyzer never needs the run that produced them, which is what makes
"one command instead of printf archaeology" work on CI artifacts.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .bus import ENVELOPE_FIELDS

MANIFEST_PATH = Path(__file__).parent / "event_manifest.json"


def load_manifest(path=None) -> dict:
    return json.loads(Path(path or MANIFEST_PATH).read_text(encoding="utf-8"))


# ---------------------------------------------------------------------------
# Span reconstruction + latency decomposition
# ---------------------------------------------------------------------------


def spans(events: List[dict]) -> Dict[int, List[dict]]:
    """Per-message event lists (``msg.*`` only), in emission order."""
    by_msg: Dict[int, List[dict]] = {}
    for e in events:
        if e["ev"].startswith("msg."):
            by_msg.setdefault(e["msg_id"], []).append(e)
    return by_msg


def latency_decomposition(events: List[dict]) -> dict:
    """Decompose every completed message's e2e latency into components.

    Per message (times in scenario seconds):

    - ``queue_wait`` — first ``msg.enqueued`` to the *last* ``msg.pulled``
      (requeued messages charge their abandoned attempts to the queue)
    - ``handoff``    — last pull to the authoritative ``start_t`` stamped
      on the completion (transport/scheduling cost of starting work)
    - ``service``    — ``start_t`` to ``done_t``
    - ``e2e``        — the sum of the three, and identically
      ``done_t - enqueued.t`` up to float re-association
    - ``e2e_arrival``— ``done_t - arrival`` (the stream's nominal arrival
      time; the exact quantity BENCH_runtime.json's pipeline reports)
    """
    per_message: List[dict] = []
    by_msg = spans(events)
    for msg_id in sorted(by_msg):
        evs = by_msg[msg_id]
        enq = next((e for e in evs if e["ev"] == "msg.enqueued"), None)
        done = next((e for e in reversed(evs) if e["ev"] == "msg.completed"),
                    None)
        if enq is None or done is None:
            continue
        pulls = [e for e in evs if e["ev"] == "msg.pulled"]
        last_pull_t = pulls[-1]["t"] if pulls else done["start_t"]
        queue_wait = last_pull_t - enq["t"]
        handoff = done["start_t"] - last_pull_t
        service = done["done_t"] - done["start_t"]
        per_message.append({
            "msg_id": msg_id,
            "image": done["image"],
            "attempts": len(pulls),
            "queue_wait": queue_wait,
            "handoff": handoff,
            "service": service,
            "e2e": queue_wait + handoff + service,
            "e2e_arrival": done["done_t"] - done["arrival"],
        })
    by_image: Dict[str, dict] = {}
    for row in per_message:
        agg = by_image.setdefault(row["image"], {
            "count": 0, "queue_wait": 0.0, "handoff": 0.0,
            "service": 0.0, "e2e": 0.0,
        })
        agg["count"] += 1
        for k in ("queue_wait", "handoff", "service", "e2e"):
            agg[k] += row[k]
    for agg in by_image.values():
        n = agg["count"]
        for k in ("queue_wait", "handoff", "service", "e2e"):
            agg[k] = agg[k] / n if n else 0.0
    totals = {"count": len(per_message)}
    for k in ("queue_wait", "handoff", "service", "e2e"):
        vals = [r[k] for r in per_message]
        totals[k] = sum(vals) / len(vals) if vals else 0.0
    return {"per_message": per_message, "by_image": by_image,
            "totals": totals}


def e2e_percentiles(events: List[dict]) -> dict:
    """p50/p95/p99 of ``done_t - arrival`` over completed messages —
    computed exactly as ``benchmarks/runtime_throughput.py`` computes the
    pipeline's latency percentiles, so the analyzer reproduces
    ``BENCH_runtime.json`` from the event log alone."""
    lat = [e["done_t"] - e["arrival"] for e in events
           if e["ev"] == "msg.completed"]
    if not lat:
        return {"count": 0, "p50": None, "p95": None, "p99": None}
    arr = np.asarray(lat, dtype=np.float64)
    return {
        "count": len(lat),
        "p50": float(np.percentile(arr, 50)),
        "p95": float(np.percentile(arr, 95)),
        "p99": float(np.percentile(arr, 99)),
    }


def critical_path(events: List[dict], msg_id: int) -> List[dict]:
    """The ordered event chain of one message, with per-hop deltas."""
    evs = spans(events).get(msg_id, [])
    out = []
    prev_t: Optional[float] = None
    for e in evs:
        out.append({
            "ev": e["ev"],
            "t": e["t"],
            "dt": 0.0 if prev_t is None else e["t"] - prev_t,
            "worker": e.get("worker"),
            "pe": e.get("pe"),
        })
        prev_t = e["t"]
    return out


# ---------------------------------------------------------------------------
# Metric folding (master-side derivation from the event log)
# ---------------------------------------------------------------------------


def fold_events(registry, events: List[dict]) -> None:
    """Derive the master's counters/histograms from the event log."""
    for e in events:
        registry.counter("events." + e["ev"]).inc()
    rows = latency_decomposition(events)["per_message"]
    for r in rows:
        registry.histogram("latency.e2e_s").observe(r["e2e_arrival"])
        registry.histogram("latency.queue_wait_s").observe(r["queue_wait"])
        registry.histogram("latency.service_s").observe(r["service"])
        if r["attempts"] > 1:
            registry.counter("msgs.reexecuted").inc()


# ---------------------------------------------------------------------------
# Schema: observation, validation, cross-log drift
# ---------------------------------------------------------------------------


def schema_of(events: List[dict]) -> Dict[str, List[str]]:
    """Observed payload field set per event type (sorted, envelope
    excluded).  ``json.dumps(schema_of(...), sort_keys=True)`` is the
    byte-identity the cross-backend test pins."""
    sch: Dict[str, set] = {}
    for e in events:
        fields = set(e) - set(ENVELOPE_FIELDS)
        sch.setdefault(e["ev"], set()).update(fields)
    return {ev: sorted(fields) for ev, fields in sorted(sch.items())}


def validate_events(events: List[dict],
                    manifest: Optional[dict] = None) -> List[str]:
    """Violations of the committed manifest: unknown types, payload field
    sets that differ from the pinned schema.  Empty list == clean."""
    man = (manifest or load_manifest())["events"]
    violations: List[str] = []
    seen: set = set()
    for e in events:
        ev = e["ev"]
        fields = tuple(sorted(set(e) - set(ENVELOPE_FIELDS)))
        key = (ev, fields)
        if key in seen:
            continue
        seen.add(key)
        if ev not in man:
            violations.append(f"event type {ev!r} not in event_manifest.json")
            continue
        pinned = tuple(sorted(man[ev]))
        if fields != pinned:
            violations.append(
                f"{ev}: payload fields {list(fields)} != manifest "
                f"{list(pinned)}"
            )
    return violations


def _counts_by_type(events: List[dict]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for e in events:
        out[e["ev"]] = out.get(e["ev"], 0) + 1
    return out


def drift_report(events_a: List[dict], events_b: List[dict]) -> dict:
    """Structural diff of two event logs (e.g. sim vs live on the same
    scenario): schema drift, per-type count deltas, latency-component
    drift, and requeue/kill accounting."""
    sa, sb = schema_of(events_a), schema_of(events_b)
    only_a = sorted(set(sa) - set(sb))
    only_b = sorted(set(sb) - set(sa))
    field_diffs = {
        ev: {"a": sa[ev], "b": sb[ev]}
        for ev in sorted(set(sa) & set(sb)) if sa[ev] != sb[ev]
    }
    ca, cb = _counts_by_type(events_a), _counts_by_type(events_b)
    counts = {ev: {"a": ca.get(ev, 0), "b": cb.get(ev, 0)}
              for ev in sorted(set(ca) | set(cb))}
    la = latency_decomposition(events_a)["totals"]
    lb = latency_decomposition(events_b)["totals"]
    latency = {
        "a": la, "b": lb,
        "delta": {k: lb[k] - la[k]
                  for k in ("queue_wait", "handoff", "service", "e2e")},
    }
    return {
        "schema": {"only_in_a": only_a, "only_in_b": only_b,
                   "field_diffs": field_diffs},
        "counts": counts,
        "latency": latency,
    }


def render_drift(report: dict) -> str:
    lines = ["drift report (a vs b):"]
    sch = report["schema"]
    if sch["only_in_a"] or sch["only_in_b"] or sch["field_diffs"]:
        lines.append(f"  schema: only_in_a={sch['only_in_a']} "
                     f"only_in_b={sch['only_in_b']}")
        for ev, d in sch["field_diffs"].items():
            lines.append(f"  schema {ev}: a={d['a']} b={d['b']}")
    else:
        lines.append("  schema: identical")
    lines.append("  event counts (a / b):")
    for ev, c in report["counts"].items():
        marker = "" if c["a"] == c["b"] else "   <-- differs"
        lines.append(f"    {ev:<18} {c['a']:>6} / {c['b']:<6}{marker}")
    lat = report["latency"]
    lines.append("  mean latency components (a -> b, delta):")
    for k in ("queue_wait", "handoff", "service", "e2e"):
        lines.append(
            f"    {k:<11} {lat['a'][k]:>9.3f} -> {lat['b'][k]:<9.3f} "
            f"({lat['delta'][k]:+.3f})"
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Decision-audit rendering
# ---------------------------------------------------------------------------


def audit_report(events: List[dict], run: Optional[int] = None) -> str:
    """Human-readable render of the IRM decision audit."""
    packs = [e for e in events if e["ev"] == "irm.pack"]
    if run is not None:
        packs = packs[run:run + 1]
    if not packs:
        return ("no irm.pack events in this log (obs level 'lifecycle' "
                "drops them; rerun with --obs-level full)")
    lines = []
    for i, p in enumerate(packs):
        lines.append(
            f"packing run {i} [t={p['t']:.2f} tick={p['tick']:.2f}] "
            f"policy={p['policy']} requests={p['requests']} "
            f"bins={p['num_bins']} target={p['target_workers']} "
            f"ideal={p['ideal_bins']}"
        )
        if p["free_before"]:
            free = ", ".join(
                f"bin {j}: [{', '.join(f'{x:.3f}' for x in row)}]"
                for j, row in enumerate(p["free_before"])
            )
            lines.append(f"  free before: {free}")
        for pl in p["placements"]:
            size = ", ".join(f"{s:.3g}" for s in pl["size"])
            lines.append(
                f"  req {pl['req_id']} ({pl['image']}, size [{size}]) "
                f"-> bin {pl['bin']}"
            )
            for rej in pl["rejections"]:
                lines.append(f"      bin {rej['bin']}: {rej['reason']}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Summary
# ---------------------------------------------------------------------------


def summarize(events: List[dict]) -> dict:
    counts = _counts_by_type(events)
    workers = {e["worker"] for e in events if "worker" in e}
    tmax = max((e["t"] for e in events), default=0.0)
    return {
        "events": len(events),
        "counts": counts,
        "distinct_workers": len(workers),
        "t_last": tmax,
        "e2e": e2e_percentiles(events),
    }

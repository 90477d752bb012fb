"""Mergeable metric instruments: counters, gauges, fixed-bucket histograms.

The registry is the unit of aggregation for the observability plane.  Every
instrument is a *mergeable delta*: a worker-side registry accumulates
observations locally, ``delta()`` snapshots what changed since the last
flush (resetting the baseline), and the delta — plain dicts of floats and
lists, nothing custom — rides the existing pickled data queue to the
master, whose registry ``merge()``s it.  The same mechanism works over any
transport that can move JSON-shaped payloads (the planned socket transport
included), which is why the wire format here is primitives only and never
the instrument objects themselves.

Merge semantics per instrument:

- **Counter** — deltas add.  Merging N worker deltas in any order yields
  the same total (float addition over non-negative increments).
- **Gauge** — last write wins; a delta carries the gauge only when it
  changed since the flush.
- **Histogram** — fixed bucket bounds chosen at creation; deltas are
  per-bucket count differences plus (sum, count) differences, merged by
  elementwise addition.  Merging rejects mismatched bounds rather than
  resampling.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence

# Buckets in *scenario seconds* — wide enough for e2e latency on the
# paper's scenarios and for sub-second service/handoff components.
DEFAULT_BOUNDS = (0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0,
                  120.0, 300.0, 600.0)


class Counter:
    """Monotone float counter."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram: ``len(bounds) + 1`` counts (last = +Inf)."""

    __slots__ = ("bounds", "counts", "total", "count")
    kind = "histogram"

    def __init__(self, bounds: Sequence[float] = DEFAULT_BOUNDS) -> None:
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError("histogram bounds must be sorted ascending")
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.total += v
        self.count += 1

    def snapshot(self) -> dict:
        return {
            "type": "histogram",
            "bounds": list(self.bounds),
            "counts": list(self.counts),
            "sum": self.total,
            "count": self.count,
        }


class MetricsRegistry:
    """A named collection of instruments with delta/merge aggregation."""

    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        self._flushed: Dict[str, dict] = {}

    # -- instrument accessors (create on first use, type-checked after) --

    def _get(self, name: str, cls, *args):
        inst = self._metrics.get(name)
        if inst is None:
            inst = cls(*args)
            self._metrics[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} is {type(inst).__name__}, "
                f"not {cls.__name__}"
            )
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds: Sequence[float] = DEFAULT_BOUNDS) -> Histogram:
        return self._get(name, Histogram, bounds)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    # -- aggregation ----------------------------------------------------

    def snapshot(self) -> dict:
        """Full current state, name-sorted, primitives only."""
        return {n: self._metrics[n].snapshot() for n in sorted(self._metrics)}

    def delta(self) -> dict:
        """What changed since the previous ``delta()``; resets the
        baseline.  Returns primitives only — safe to pickle/json."""
        out = {}
        for name in sorted(self._metrics):
            snap = self._metrics[name].snapshot()
            base = self._flushed.get(name)
            d = _subtract(snap, base)
            if d is not None:
                out[name] = d
            self._flushed[name] = snap
        return out

    def merge(self, delta: Optional[dict]) -> None:
        """Fold a ``delta()`` (or full ``snapshot()``) from another
        registry into this one."""
        if not delta:
            return
        for name, payload in delta.items():
            kind = payload["type"]
            if kind == "counter":
                self.counter(name).inc(payload["value"])
            elif kind == "gauge":
                self.gauge(name).set(payload["value"])
            elif kind == "histogram":
                h = self.histogram(name, payload["bounds"])
                if list(h.bounds) != list(payload["bounds"]):
                    raise ValueError(
                        f"histogram {name!r}: bounds mismatch on merge"
                    )
                for i, c in enumerate(payload["counts"]):
                    h.counts[i] += c
                h.total += payload["sum"]
                h.count += payload["count"]
            else:
                raise ValueError(f"unknown instrument type {kind!r}")


def _subtract(snap: dict, base: Optional[dict]) -> Optional[dict]:
    """Delta between two snapshots of the same instrument; None = no
    change worth shipping."""
    kind = snap["type"]
    if kind == "counter":
        prev = base["value"] if base else 0.0
        d = snap["value"] - prev
        if d == 0.0:
            return None
        return {"type": "counter", "value": d}
    if kind == "gauge":
        if base is not None and base["value"] == snap["value"]:
            return None
        return dict(snap)
    if kind == "histogram":
        if base is None:
            if snap["count"] == 0:
                return None
            return dict(snap)
        if snap["count"] == base["count"]:
            return None
        return {
            "type": "histogram",
            "bounds": list(snap["bounds"]),
            "counts": [a - b for a, b in zip(snap["counts"], base["counts"],
                                             strict=True)],
            "sum": snap["sum"] - base["sum"],
            "count": snap["count"] - base["count"],
        }
    raise ValueError(f"unknown instrument type {kind!r}")

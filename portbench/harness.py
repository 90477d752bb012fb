"""The harness: find a cell's files by name, run its driver, read the
per-layer metrics, print the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
configuration's file holds the model, the traffic's file names its driver
(``kind``: ``drivers/<kind>.py``), and ``limits/<config>.<kind>.json`` holds
the limits of the numbers that driver compares.  Each per-layer metric is
read by ``metrics/<name>.py`` from a ``Record`` of the run.  A new cell,
traffic mix or metric is new files and entries; no file here changes.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["Cell", "Context", "Record", "Trace", "load_cell", "main", "forbidden_modules"]

PACKAGE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name, whole, is JAX's or the JAX
    package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _for_cell(metrics: List[Dict], cell: str) -> List[Dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(root: Path, name: str, spec: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` (or of ``spec``) with its
    configuration, traffic and limits read from their files."""
    spec = spec or json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "portbench" / "limits"
                         / f"{w['config']}.{traffic['kind']}.json").read_text())["limits"]
    return Cell(name, w["chips"], config, traffic, limits,
                _for_cell(spec["end_to_end"], name), _for_cell(spec["per_layer"], name))


# --------------------------------------------------------------------------
# the trace of a segment: host spans and device intervals


@dataclasses.dataclass
class Trace:
    """A profiled segment: its window and, in ns on one clock, the host's
    spans (name, start, end) and the device's operations (name, start,
    end).  ``work`` is what the driver fed the segment, for the readers
    that count operations and bytes."""

    window: Tuple[int, int]
    spans: List[Tuple[str, int, int]]
    device: List[Tuple[str, int, int]]
    work: Dict[str, Any]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy(self) -> List[Tuple[int, int]]:
        """The device's busy intervals inside the window, merged."""
        lo, hi = self.window
        ivs = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device if e > lo and s < hi)
        merged: List[List[int]] = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def kernel_s(self, *keys: str) -> Tuple[float, int]:
        """Seconds and launches of the device operations whose name holds
        one of ``keys``."""
        hits = [(s, e) for n, s, e in self.device if any(k in n for k in keys)]
        return sum(e - s for s, e in hits) / 1e9, len(hits)

    def breakdown(self) -> Dict[str, List]:
        by_op: Dict[str, float] = {}
        for n, s, e in self.device:
            by_op[n[:100]] = by_op.get(n[:100], 0.0) + (e - s) / 1e9
        gaps: Dict[str, float] = {}
        edges = [self.window[0]] + [t for iv in self.busy() for t in iv] + [self.window[1]]
        for s, e in zip(edges[::2], edges[1::2]):
            if e <= s:
                continue
            mid = (s + e) // 2
            inside = [(a, n) for n, a, b in self.spans if a <= mid <= b]
            what = max(inside)[1] if inside else "other"
            gaps[what] = gaps.get(what, 0.0) + (e - s) / 1e9

        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}


class Spans:
    """Host spans around each call into a layer, recorded on the host's
    clock (ns since the epoch, the profiler's clock) while a segment is
    traced; nothing otherwise."""

    def __init__(self):
        self.on = False
        self.seen: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def _span(self, name: str):
        start = time.time_ns()
        try:
            yield
        finally:
            self.seen.append((name, start, time.time_ns()))

    def __call__(self, name: str):
        return self._span(name) if self.on else contextlib.nullcontext()


def profile(segment: Callable[[], Dict[str, Any]], spans: Spans, sync: Callable[[], None],
            cuda: bool) -> Trace:
    """Run ``segment`` under ``torch.profiler``, recording the device's
    operations only (the host's own events would cost ~20 us an operation
    and starve the device), with the spans on; it returns what it fed the
    program (``Trace.work``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    sync()
    spans.seen = []
    with torch_profile(activities=acts) as prof:
        spans.on = True
        try:
            start = time.time_ns()
            work = segment()
            sync()
            end = time.time_ns()
        finally:
            spans.on = False
    device = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    return Trace((start, end), spans.seen, device, work)


@dataclasses.dataclass
class Record:
    """What a per-layer reader reads: the cell's configuration, the
    driver's counters of the measured window, and the traced segment (None
    without ``--trace 1``)."""

    config: Dict[str, Any]
    counters: Dict[str, float]
    trace: Optional[Trace]


def _reader(name: str) -> ModuleType:
    path = PACKAGE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------------------
# a run


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, the device, the
    spans, the clock the set-up started on."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    started: float
    spans: Spans = dataclasses.field(default_factory=Spans)
    setup_s: Optional[float] = None
    marks: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize(self.device)

    def mark(self, name: str) -> None:
        """Note the seconds since the start at a point of the run (printed
        to standard error, to see where set-up and the check go)."""
        self.marks[name] = time.perf_counter() - self.started

    def setup_done(self) -> None:
        """Set-up ends here and the window starts."""
        self.sync()
        self.setup_s = time.perf_counter() - self.started
        self.marks["setup"] = self.setup_s

    def profile(self, segment: Callable[[], Dict[str, Any]]) -> Trace:
        return profile(segment, self.spans, self.sync, self.cuda)


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def _checks(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict]]:
    missing = sorted(set(limits) ^ set(values))
    if missing:
        raise RuntimeError(f"compared numbers and limits differ: {missing}")
    out = {k: {"value": values[k], "limit": limits[k]} for k in sorted(values)}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in out.values())
    return ok, out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, started: float) -> Dict:
    """Drive the cell once and return the result line's object."""
    import torch

    ctx = Context(cell, seed, seconds, trace, device, started)
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['kind']}")
    ctx.mark("imported")
    out = driver.run(ctx)
    ctx.mark("checked")
    diag = {"marks_s": ctx.marks, "counters": out["counters"]}
    tr = out.get("trace")
    if tr is not None and tr.device:  # the device's first and last operation against the window
        diag["trace_edges_ms"] = [(min(s for _, s, _ in tr.device) - tr.window[0]) / 1e6,
                                  (tr.window[1] - max(e for _, _, e in tr.device)) / 1e6]
    print("portbench: " + json.dumps(diag), file=sys.stderr)
    correct, checks = _checks(out["checks"], cell.limits)
    e2e = dict(out["end_to_end"], setup_s=ctx.setup_s)
    metrics: Dict[str, Dict] = {}
    if not trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        rec = Record(cell.config, out["counters"], out.get("trace"))
        for m in cell.per_layer:
            value = _reader(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev: Dict[str, Any] = {"platform": "gpu" if ctx.cuda else "cpu",
                           "kind": torch.cuda.get_device_name(device) if ctx.cuda else "cpu",
                           "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    if ctx.cuda:
        dev["power"] = _power_limit()
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace and tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result


def main(argv: Optional[List[str]] = None, *, started: Optional[float] = None,
         root: Optional[Path] = None, spec: Optional[Dict] = None, device: Any = None) -> int:
    """The command.  ``device`` (a test's) skips the look for a card."""
    started = time.perf_counter() if started is None else started
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(root or PACKAGE.parent, args.workload, spec)

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device(device),
                      started)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}: the port must run without JAX",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

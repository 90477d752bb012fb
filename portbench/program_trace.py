"""The program's own spans and counters in a traced segment, joined to its
device operations.

The port records them (``repro_torch.obs.spans``) while the segment's
profiler session records, on the clock the device operations are stamped
with.  The first reader to ask drains the port's buffer into this module;
every reader takes the records inside ``trace.window``.  A span marked on
the card is taken on the device's timeline, from the end of its start
marker to the start of its end marker: exactly the operations it launched.
Any other span is taken on the host's.  A port without the recorder gives
no records, and the readers that need them return None.

Run as a script, it runs one cell traced as ``run.py`` does and prints, as
one JSON line on standard output after the result line, the traced
segment's idle time split by the innermost span around it, the program's
spans before the benchmark's:

    python3 portbench/program_trace.py --workload <cell> --seed <n> --seconds <s>
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

_seen: list = []


def _spans_module():
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    return spans


def _records() -> list:
    spans = _spans_module()
    if spans is not None:
        _seen.extend(spans.drain())
    return _seen


def _in_window(trace) -> list:
    lo, hi = trace.window
    return [r for r in _records() if hasattr(r, "end_ns") and lo <= r.start_ns and r.end_ns <= hi]


def _markers(trace, recs: list) -> Optional[Dict[int, Tuple[int, int]]]:
    """Each marker index of ``recs`` to its operation on the device; None
    if the device ran another number of markers than the spans launched."""
    spans = _spans_module()
    marks = sorted(i for r in recs if getattr(r, "marks", None) for i in r.marks)
    if not marks:
        return {}
    lo, hi = trace.window
    ops = sorted((s, e) for n, s, e in trace.device if spans.MARKER in n and lo <= s <= hi)
    if len(ops) != len(marks) or marks[-1] - marks[0] + 1 != len(marks):
        return None
    return dict(zip(marks, ops))


def timed_spans(trace) -> List[Tuple[str, int, int]]:
    """(name, start, end) of the program's spans inside the segment's
    window, a marked span on the device's timeline; without the marked
    spans if their markers cannot be matched."""
    recs = _in_window(trace)
    ops = _markers(trace, recs)
    out = []
    for r in recs:
        marks = getattr(r, "marks", None)
        if marks is None:
            out.append((r.name, r.start_ns, r.end_ns))
        elif ops is not None:
            out.append((r.name, ops[marks[0]][1], ops[marks[1]][0]))
    return out


def spans_named(trace, *names: str) -> List[Tuple[int, int]]:
    """(start, end) of the program's spans named one of ``names`` inside
    the segment's window (``timed_spans``)."""
    return [(s, e) for n, s, e in timed_spans(trace) if n in names]


def counter(trace, name: str) -> Optional[float]:
    """The sum of the counter ``name`` inside the window; None if it was
    never counted there."""
    lo, hi = trace.window
    values = [r.value for r in _records()
              if r.name == name and hasattr(r, "t_ns") and lo <= r.t_ns <= hi]
    return sum(values) if values else None


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def length(intervals: Iterable[Tuple[int, int]]) -> int:
    return sum(e - s for s, e in union(intervals))


def busy_inside(trace, intervals: Iterable[Tuple[int, int]]) -> int:
    """Nanoseconds inside ``intervals`` in which the device ran an
    operation."""
    inside = union(intervals)
    busy, i, total = trace.busy(), 0, 0
    for s, e in inside:
        while i < len(busy) and busy[i][1] <= s:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < e:
            total += min(e, busy[j][1]) - max(s, busy[j][0])
            j += 1
    return total


def device_share(trace, outer: str, *inner: str) -> Optional[float]:
    """Percent of the device's busy time inside the ``outer`` spans that
    falls inside the ``inner`` spans; None without either."""
    if trace is None:
        return None
    steps, parts = spans_named(trace, outer), spans_named(trace, *inner)
    total = busy_inside(trace, steps) if steps and parts else 0
    return 100.0 * busy_inside(trace, parts) / total if total else None


def idle_by_span(trace) -> Dict[str, float]:
    """Seconds of the window in which the device ran nothing, by the
    innermost span around them: the program's (``timed_spans``) before the
    benchmark's (``trace.spans``, named ``harness:<name>``), "other" outside
    both.  The innermost of two spans is the one that started later."""
    ranked = sorted((s, e, n) for n, s, e in timed_spans(trace))
    harness = sorted((s, e, "harness:" + n) for n, s, e in trace.spans)

    def innermost(t: int) -> str:
        for group in (ranked, harness):
            inside = [(s, n) for s, e, n in group if s <= t < e]
            if inside:
                return max(inside)[1]
        return "other"

    bounds = sorted({t for s, e, _ in ranked + harness for t in (s, e)})
    edges = [trace.window[0]] + [t for iv in trace.busy() for t in iv] + [trace.window[1]]
    out: Dict[str, float] = {}
    for s, e in zip(edges[::2], edges[1::2]):
        cuts = [s] + bounds[bisect.bisect_right(bounds, s):bisect.bisect_left(bounds, e)] + [e]
        for x, y in zip(cuts, cuts[1:]):
            if y > x:
                name = innermost(x)
                out[name] = out.get(name, 0.0) + (y - x) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main(argv: Optional[List[str]] = None, **run) -> int:
    """``run.py --trace 1`` for one cell, then the idle split's line;
    ``run`` goes to ``harness.main``."""
    import json
    import time

    from portbench import harness

    started = time.perf_counter()
    kept = []
    profile = harness.profile

    def keep(*args, **kwargs):
        kept.append(profile(*args, **kwargs))
        return kept[-1]

    harness.profile = keep
    try:
        rc = harness.main(list(argv or []) + ["--trace", "1"], started=started, **run)
    finally:
        harness.profile = profile
    if rc == 0 and kept:
        tr = kept[-1]
        print(json.dumps({"window_s": tr.window_s, "busy_s": tr.busy_s(),
                          "idle_by_span_s": idle_by_span(tr)}), flush=True)
    return rc


if __name__ == "__main__":
    import os
    import sys
    from pathlib import Path

    ROOT = Path(__file__).resolve().parents[1]
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import program_trace

    sys.exit(program_trace.main(sys.argv[1:]))

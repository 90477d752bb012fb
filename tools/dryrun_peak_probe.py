#!/usr/bin/env python3
"""The dry-run's predicted peak of a train step against the card's, tensor
by tensor.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/dryrun_peak_probe.py [--top 30] [--out build/peak_probe.json]

It takes ``chip_smoke.py`` phase 11c's olmo-1b train step (4 x 4096, remat
``"nothing"``, the first batch of the training stream) and reads its peak
six ways:

  - ``count_mesh``: counted on meta stand-ins on the one-card (1, 1) mesh,
    as phase 11c counts it (``dryrun.lower_cell``);
  - ``count_plain``: counted on meta stand-ins, no mesh;
  - ``count_card``: counted on the card's own tensors (the count's rule
    over the real step);
  - ``card``: ``max_memory_allocated()`` over the step less what the
    process holds beside its arguments, as phase 11c reads it;
  - ``card_no_gc``: the same with Python's garbage collector off during the
    step;
  - ``card_history``: the same under the allocator's memory history (with
    Python stacks, or without where recording them fails).

Each count prints its ``top`` largest storages held at its peak (by the op
that made them: ``analyze_step(..., top_held=n)``); the card's history is
replayed to the moment the step's own blocks peaked, and the blocks live
there are listed by size and the innermost frame of this repository's code
that allocated them (where a stack was recorded: recording Python stacks
fails inside the checkpoint's recompute on torch 2.11).
Each reading is one JSON line; ``--out`` writes them all to one file.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _frame(frames) -> str:
    for fr in frames:
        name = fr.get("filename", "")
        if "/src/repro_torch/" in name or name.endswith("chip_smoke.py"):
            return f"{name.split('/src/')[-1]}:{fr.get('line')} {fr.get('name')}"
    return "no stack recorded" if not frames else (
        f"{frames[0].get('filename', '').split('/')[-1]}:{frames[0].get('line')}")


def _replay(trace, top: int):
    """(peak bytes of the blocks allocated in ``trace``, the blocks live at
    that moment grouped by (size, frame), the largest groups first)."""
    live, held, peak, at = {}, 0, 0, -1
    for i, ev in enumerate(trace):
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev["size"]
            held += ev["size"]
            if held > peak:
                peak, at = held, i
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            held -= live.pop(ev["addr"])
    live = {}
    for ev in trace[:at + 1]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], _frame(ev.get("frames", [])))
        elif ev["action"] == "free_completed":
            live.pop(ev["addr"], None)
    groups = Counter()
    for size, frame in live.values():
        groups[(size, frame)] += 1
    rows = sorted(((s * n, s, n, f) for (s, f), n in groups.items()), reverse=True)
    return peak, [{"bytes": b, "size": s, "count": n, "frame": f} for b, s, n, f in rows[:top]]


def _count_rows(cost):
    return [{"op": op, "shape": list(shape), "dtype": dt, "bytes": b}
            for op, shape, dt, b in cost.held_at_peak]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode

    import chip_smoke as cs
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.trace_analysis import analyze_step
    from repro_torch.models import abstract_params, build_model, input_specs
    from repro_torch.training import OptimizerConfig, init_opt_state, make_train_step

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S = cs.TRAIN["B"], cs.TRAIN["S"]
    shape = ShapeConfig("train_4k", "train", S, B)
    lines = []

    def emit(name, **rec):
        rec = {"reading": name, **rec}
        lines.append(rec)
        print(json.dumps({k: v for k, v in rec.items() if k != "held"}), flush=True)
        for row in rec.get("held", []):
            print(f"  [{name}] {json.dumps(row)}")

    # the counts on stand-ins
    t0 = time.perf_counter()
    dryrun.fake_process_group(1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        rec = dryrun.lower_cell("olmo-1b", "train_4k", mesh=mesh, remat_policy="nothing",
                                shape=shape, keep_hlo=True, top_held=args.top)
    finally:
        dist.destroy_process_group()
    emit("count_mesh", peak_gib=rec["_cost"].peak_bytes / 2**30,
         arg_gib=rec["_cost"].arg_bytes / 2**30, seconds=time.perf_counter() - t0,
         held=_count_rows(rec["_cost"]))

    model = build_model(get_config("olmo-1b"))
    specs = model.param_specs()
    step_fn = make_train_step(model, OptimizerConfig(), remat_policy="nothing")
    meta_state = {"m": abstract_params(specs, torch.float32),
                  "v": abstract_params(specs, torch.float32),
                  "step": torch.empty((), dtype=torch.int32, device="meta")}
    _, cost = analyze_step(step_fn, abstract_params(specs), meta_state,
                           input_specs(model.cfg, shape), top_held=args.top)
    emit("count_plain", peak_gib=cost.peak_bytes / 2**30, arg_gib=cost.arg_bytes / 2**30,
         held=_count_rows(cost))
    del meta_state, cost

    # the card
    dev = torch.device("cuda")
    params = train.make_params(model, 0, dev)
    batch = {k: torch.from_numpy(getattr(next(cs._train_batches()), k)).to(dev)
             for k in ("tokens", "labels", "segment_ids", "positions")}
    opt_state = init_opt_state(params)
    params, opt_state, _ = step_fn(params, opt_state, batch)  # warm-up
    torch.cuda.synchronize()

    _, cost = analyze_step(step_fn, params, opt_state, batch, top_held=args.top)
    torch.cuda.synchronize()
    emit("count_card", peak_gib=cost.peak_bytes / 2**30, arg_gib=cost.arg_bytes / 2**30,
         held=_count_rows(cost))
    del cost

    def reading(collect=True, history=None):
        """The step's peak as phase 11c reads it (under ``FlopCounterMode``
        unless the allocator's history is recorded: the two together fail
        inside the checkpoint's recompute), and the history's replay."""
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        beside = torch.cuda.memory_allocated() - cs._storage_bytes(torch, (params, opt_state, batch))
        if history:
            torch.cuda.memory._record_memory_history(max_entries=500_000, **history)
        if not collect:
            gc.disable()
        try:
            with FlopCounterMode(display=False) if not history else contextlib.nullcontext():
                res = step_fn(params, opt_state, batch)
                torch.cuda.synchronize()
        finally:
            gc.enable()
        peak = torch.cuda.max_memory_allocated() - beside
        extra = {}
        if history:
            snap = torch.cuda.memory._snapshot()
            torch.cuda.memory._record_memory_history(enabled=None)
            trace = snap["device_traces"][torch.cuda.current_device()]
            step_peak, held = _replay(trace, args.top)
            extra = {"history": history, "trace_events": len(trace),
                     "trace_peak_gib": step_peak / 2**30, "held": held}
        del res
        return {"peak_gib": peak / 2**30, "beside_gib": beside / 2**30, **extra}

    emit("card", **reading())
    emit("card_no_gc", **reading(collect=False))
    for history in ({"stacks": "python"}, {"context": None}):
        try:
            emit("card_history", **reading(history=history))
            break
        except Exception as exc:  # a failed recording: say so, try the next
            torch.cuda.memory._record_memory_history(enabled=None)
            emit("card_history", failed=f"{type(exc).__name__}: {exc}", history=history)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(lines, indent=1) + "\n")


if __name__ == "__main__":
    main()

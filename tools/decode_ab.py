#!/usr/bin/env python3
"""Time the qwen3-8b ragged decode step of two checkouts on one card, in
turns, and the kernel operators' dispatch cost inside one process.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/decode_ab.py OTHER_ROOT [--rounds 2] [--steps 64]

``OTHER_ROOT`` is another checkout of this repository, for example the
parent commit unpacked by ``git archive`` into a directory that
``.gitignore`` lists.  Each side runs in a child interpreter with its own
``src/`` first on the path and builds its kernels there, and serves as
``chip_smoke.py``'s phase 10 does: ``qwen3-8b`` at full width in bf16
(weights drawn on the card from seed 0), 8 prompts of 64-1024 tokens
(numpy seed 21) through ``prefill`` into a 1024-page paged cache, 8
warm-up decode steps, then ``--steps`` decode steps, each ended by a
synchronise and timed on the host clock.  The sides run other, this,
this, other for each round.  This side's child then reads the cost of the
paged kernel's ``torch.library`` operator inside one process, where the
host's pace is the same for both: decode steps alternating, one by one,
between the operator (as the port calls it) and the launch called directly
(``ops._launch``), and the host time of one call each way at a one-page
shape, in interleaved blocks of ``CALLS`` calls.  Each child prints one
JSON line; the last line holds the medians per side.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WARM, AB_STEPS, CALLS, CALL_BLOCKS = 8, 128, 2000, 10


def child(src: Path, steps: int, dispatch_ab: bool) -> None:
    """One side's decode steps; print one JSON line."""
    sys.path.insert(0, str(src))
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.packed_attention import kernel as packed_kernel
    from repro_torch.kernels.paged_attention import kernel as paged_kernel
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.main sets them
    torch.backends.cudnn.allow_tf32 = False
    packed_kernel.build()
    paged_kernel.build()
    dev = torch.device("cuda")
    cfg = get_config("qwen3-8b")
    model = build_model(cfg)
    params = serve.make_params(model, 0, dev)
    rng = np.random.default_rng(21)
    B = 8
    lens = rng.integers(64, 1025, size=B)
    S = int(lens.max())
    tokens = np.zeros((B, S), np.int32)
    seg = np.zeros((B, S), np.int32)
    for b, n in enumerate(lens):
        tokens[b, :n] = rng.integers(1, cfg.vocab_size, size=n)
        seg[b, :n] = 1
    batch = {"tokens": torch.tensor(tokens, device=dev),
             "segment_ids": torch.tensor(seg, device=dev),
             "positions": torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)}
    cache = model.init_paged_cache(serve.paged_layout(cfg, 1024), serve.DTYPE, dev)
    logits, cache = model.prefill(params, batch, cache)
    state = {"tok": serve.greedy(logits), "cache": cache}

    def step() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, state["cache"] = model.decode_step(params, {"tokens": state["tok"]},
                                                state["cache"])
        state["tok"] = serve.greedy(out)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for _ in range(WARM):
        step()
    ms = [step() for _ in range(steps)]
    result = {"src": str(src), "step_ms_p50": statistics.median(ms),
              "step_ms_mean": statistics.fmean(ms), "step_ms_min": min(ms)}
    if dispatch_ab:
        op = paged_ops._PAGED
        routes = {"operator": op, "direct": paged_ops._launch}
        by = {"operator": [], "direct": []}
        for i in range(AB_STEPS):  # operator, direct, direct, operator, ...
            mode = ("operator", "direct")[(i + i // 2) % 2]
            paged_ops._PAGED = routes[mode]
            by[mode].append(step())
        p50 = {k: statistics.median(v) for k, v in by.items()}
        result["dispatch_ab_ms_p50"] = p50
        result["operator_over_direct"] = p50["operator"] / p50["direct"] - 1
        # one call's host time each way, at one page
        q = torch.zeros((1, cfg.n_heads, cfg.head_dim_), dtype=serve.DTYPE, device=dev)
        pool = torch.zeros((1, 16, cfg.n_kv_heads, cfg.head_dim_), dtype=serve.DTYPE,
                           device=dev)
        table = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        lens = torch.ones((1,), dtype=torch.int32, device=dev)
        us = {"operator": [], "direct": []}
        for i in range(CALL_BLOCKS):
            mode = ("operator", "direct")[(i + i // 2) % 2]
            paged_ops._PAGED = routes[mode]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                paged_ops.paged_attention(q, pool, pool, table, lens)
            torch.cuda.synchronize()
            us[mode].append((time.perf_counter() - t0) / CALLS * 1e6)
        paged_ops._PAGED = op
        per_call = {k: statistics.median(v) for k, v in us.items()}
        result["call_us"] = per_call
        result["operator_adds_us_per_call"] = per_call["operator"] - per_call["direct"]
    print(json.dumps(result), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--child", type=Path, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dispatch-ab", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.steps, args.dispatch_ab)
        return
    sides = {"other": args.other.resolve() / "src", "this": ROOT / "src"}
    runs = {"other": [], "this": []}
    for _ in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            cmd = [sys.executable, str(Path(__file__).resolve()), str(args.other),
                   "--steps", str(args.steps), "--child", str(sides[side])]
            if side == "this":
                cmd.append("--dispatch-ab")
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                sys.stderr.write(res.stderr[-4000:])
                raise SystemExit(f"the {side} side exited with {res.returncode}")
            line = json.loads(res.stdout.strip().splitlines()[-1])
            print(json.dumps({"side": side, **line}), flush=True)
            runs[side].append(line)
    med = {side: statistics.median(r["step_ms_p50"] for r in rs) for side, rs in runs.items()}
    low = {side: statistics.median(r["step_ms_min"] for r in rs) for side, rs in runs.items()}
    print(json.dumps({
        "step_ms_p50_median": med, "this_over_other": med["this"] / med["other"] - 1,
        "step_ms_min_median": low, "this_over_other_by_min": low["this"] / low["other"] - 1,
        "operator_over_direct_median": statistics.median(
            r["operator_over_direct"] for r in runs["this"]),
        "operator_adds_us_per_call_median": statistics.median(
            r["operator_adds_us_per_call"] for r in runs["this"])}))


if __name__ == "__main__":
    main()

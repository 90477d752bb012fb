#!/usr/bin/env python3
"""Time the packed-attention kernels of two checkouts on one card, in turns.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/packed_attention_ab.py OTHER_ROOT [--rounds 1]

``OTHER_ROOT`` is another checkout of this repository, for example the
parent commit unpacked by ``git archive`` into a directory that
``.gitignore`` lists.  Each side runs in a child interpreter with its own
``src/`` first on the path, builds its kernels there, and times the forward
and the backward at ``chip_smoke.py``'s phase-7 shapes (the train shape,
the first train batch with two documents or more in every row, the prefill
shape) with ``chip_smoke._time_ms`` (median of CUDA events, L2 flushed),
beside ``scaled_dot_product_attention`` (causal, forward and backward).
A side whose backward takes the forward's rounding residual (``out_lo``)
times the training forward, which writes it; an older side, its forward
alone.  With ``--dtype float32`` the shapes are phase 7b's instead (the
train shape cut to ``chip_smoke.F32_TRAIN_ROWS`` rows, the prefill shape,
each head dim at 2 x 1024 with two documents a row) and the tensors fp32,
sdpa's too (TF32 off), with the bound at 3xTF32 on the tensor cores beside
the fp32 one.  The sides run other, this, this, other for each round.  Each
run prints one JSON line; then a line of the medians per side.  With
``--train`` each side then runs its own ``chip_smoke.train_phase``
(olmo-1b, 8 steps at full width; ``train_f32_phase``, phase 11d, in
float32) in the same turns, its ``[train]`` (``[train-f32]``) lines are
printed, and the last line holds each side's step p50s and profiled device
ms with their medians.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 10


def child(src: Path, dtype_name: str = "bfloat16") -> None:
    """Time one side's kernels in ``dtype_name``; print one JSON line."""
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels.packed_attention import kernel as pk

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # sdpa's fp32 yardstick in fp32
    dtype = getattr(torch, dtype_name)
    pk.build()
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    if dtype == torch.float32:  # phase 7b's shapes
        two_docs = cs._two_document_ids(np, 2, 1024, 1024)
        shapes = (("train f32", dict(cs.TRAIN, B=cs.F32_TRAIN_ROWS),
                   next(cs._train_batches(cs.F32_TRAIN_ROWS)).segment_ids),
                  ("prefill f32", cs.PREFILL,
                   np.ones((cs.PREFILL["B"], cs.PREFILL["S"]), np.int32)),
                  *((f"f32 D={d}", {"B": 2, "S": 1024, "H": 8, "KVH": 2, "D": d}, two_docs)
                    for d in cs.F32_HEAD_DIMS))
    else:
        first = np.concatenate([next(cs._train_batches()).segment_ids,
                                np.zeros((1, cs.TRAIN["S"]), np.int32)])
        multi_idx, multi = cs._multi_segment_batch()
        shapes = (("train", dict(cs.TRAIN, B=cs.TRAIN["B"] + 1), first),
                  (f"train batch {multi_idx}", cs.TRAIN, multi.segment_ids),
                  ("prefill", cs.PREFILL,
                   np.ones((cs.PREFILL["B"], cs.PREFILL["S"]), np.int32)))
    result = {}
    for name, shp, seg_np in shapes:
        B, S, H, KVH, D = (shp[k] for k in ("B", "S", "H", "KVH", "D"))
        seg = torch.tensor(seg_np, device=dev)
        gen = torch.Generator(device=dev).manual_seed(23)
        q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                      for shape in ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D),
                                    (B, S, H, D)))
        residual = "out_lo" in inspect.signature(pk.packed_flash_attention_bwd).parameters
        kw = {"residual": True} if residual else {}
        o, lse, *lo = pk.packed_flash_attention(q, k, v, seg, seg, **kw)
        fwd = cs._time_ms(torch, lambda: pk.packed_flash_attention(q, k, v, seg, seg, **kw),
                          REPS, flush)
        bwd = cs._time_ms(torch, lambda: pk.packed_flash_attention_bwd(
            q, k, v, seg, seg, o, *lo, g, lse), REPS, flush)
        hs = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v)]
        gt = g.transpose(1, 2).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(*hs, is_causal=True, enable_gqa=H != KVH)

        with torch.no_grad():
            sdpa_fwd = cs._time_ms(torch, sdpa, REPS, flush)
        sd = sdpa()
        sdpa_bwd = cs._time_ms(torch, lambda: torch.autograd.grad(
            sd, hs, gt, retain_graph=True), REPS, flush)
        pairs = cs._visible_pairs(np, seg_np)
        result[name] = {
            "residual": residual,
            "fwd_ms": fwd, "bwd_ms": bwd, "sdpa_fwd_ms": sdpa_fwd, "sdpa_bwd_ms": sdpa_bwd,
            "fwd_bound_ms": cs._packed_bound("fwd", pairs, B, S, H, KVH, D, dtype_name,
                                             residual=residual)[0],
            "bwd_bound_ms": cs._packed_bound("bwd", pairs, B, S, H, KVH, D, dtype_name)[0],
            "fwd_tflops": 4.0 * D * H * pairs / fwd / 1e9,
            "bwd_tflops": 10.0 * D * H * pairs / bwd / 1e9,
        }
        if dtype == torch.float32:
            result[name].update({
                f"{kind}_bound_tf32x3_ms": cs._packed_bound(
                    kind, pairs, B, S, H, KVH, D, dtype_name, peak="tf32x3")[0]
                for kind in ("fwd", "bwd")})
        del q, k, v, g, o, lse, lo, hs, gt, sd
        torch.cuda.empty_cache()
    print(json.dumps({"src": str(src), "card": torch.cuda.get_device_name(0),
                      "shapes": result}))


def train_child(root: Path, dtype_name: str = "bfloat16") -> None:
    """One side's ``chip_smoke.train_phase`` (``train_f32_phase`` in
    float32), from that side's checkout."""
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.packed_attention import kernel as pk

    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.main sets them
    torch.backends.cudnn.allow_tf32 = False
    pk.build()
    if dtype_name == "float32":
        cs.train_f32_phase(torch, np)
    else:
        cs.train_phase(torch, np)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="root of the checkout to compare with")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--train", action="store_true",
                    help="then run each side's train phase, other first")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the kernels' instance to time (float32: phase 7b's shapes)")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--train-child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.dtype)
        return
    if args.train_child is not None:
        train_child(args.train_child, args.dtype)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sides = {"other": args.other.resolve() / "src", "this": ROOT / "src"}
    runs = {side: [] for side in sides}
    for _ in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), str(args.other),
                 "--child", str(sides[side]), "--dtype", args.dtype],
                capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr[-4000:])
                raise SystemExit(f"the {side} run exited with {proc.returncode}")
            line = proc.stdout.strip().splitlines()[-1]
            print(json.dumps({"side": side, **json.loads(line)}), flush=True)
            runs[side].append(json.loads(line)["shapes"])
    summary = {side: {name: {key: statistics.median(r[name][key] for r in rs)
                             for key in rs[0][name]} for name in rs[0]}
               for side, rs in runs.items()}
    print(json.dumps({"median": summary}), flush=True)
    if args.train:
        roots = {"other": args.other.resolve(), "this": ROOT}
        steps = {side: {"step_ms_p50": [], "device_ms": []} for side in roots}
        for _ in range(args.rounds):
            for side in ("other", "this", "this", "other"):
                proc = subprocess.run(
                    [sys.executable, str(Path(__file__).resolve()), str(args.other),
                     "--train-child", str(roots[side]), "--dtype", args.dtype],
                    capture_output=True, text=True, timeout=900)
                tag = "[train-f32]" if args.dtype == "float32" else "[train]"
                for line in proc.stdout.splitlines():
                    if line.startswith(tag):
                        print(f"[{side}] {line}", flush=True)
                    if line.startswith(f"{tag} {{"):
                        steps[side]["step_ms_p50"].append(
                            json.loads(line[len(tag) + 1:])["step_ms_p50"])
                    if line.startswith(f"{tag} step profile: "):
                        steps[side]["device_ms"].append(
                            json.loads(line[len(f"{tag} step profile: "):])["device_ms"])
                if proc.returncode != 0:
                    sys.stderr.write(proc.stderr[-4000:])
                    raise SystemExit(f"the {side} train run exited with {proc.returncode}")
        print(json.dumps({"train": {side: {**runs, **{
            f"median_{key}": statistics.median(vals) for key, vals in runs.items() if vals}}
            for side, runs in steps.items()}}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time the paged-decode-attention and grouped-matmul kernels of two
checkouts on one card, in turns.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/kernel_ab.py OTHER_ROOT [--rounds 1]

``OTHER_ROOT`` is another checkout of this repository, for example the
parent commit unpacked by ``git archive`` into a directory that
``.gitignore`` lists.  Each side runs in a child interpreter with its own
``src/`` first on the path and builds its kernels there; the inputs, the
timing and the yardsticks are this checkout's ``chip_smoke.py``'s, so both
sides get the same ones: the paged kernel in bf16 at phase 6's decode shape
(beside ``scaled_dot_product_attention`` on the gathered K/V), the
grouped matmul at phase 4's payload shape, f32 128 x 128 x 2048 x 2048,
and its bf16 entry at phase 4's three MoE bins (``chip_smoke.MOE_GMM``:
the decode bins and the prefill's gate/up and down), each grouped matmul
beside ``torch.bmm`` and the row mask, each time by
``chip_smoke._time_ms`` (median of CUDA events, L2 flushed).  The sides run
other, this, this, other for each round.  Each run prints one JSON line (with each kernel's largest
difference from its plain version, and the bf16 bins' relative l2); then a
line of the medians per side.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = {"paged": 50, "gmm": 20}


def child(src: Path) -> None:
    """Time one side's kernels; print one JSON line."""
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.grouped_matmul import kernel as gk
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.main sets them
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gk.build()
    pk.build()
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    result = {}

    args, lens = cs._decode_inputs(torch, np, torch.bfloat16)
    err = (pk.paged_decode_attention(*args).float()
           - paged_attention_ref(*args).float()).abs().max().item()
    ms = cs._time_ms(torch, lambda: pk.paged_decode_attention(*args), REPS["paged"], flush)
    sdpa_ms = cs._time_ms(torch, cs._sdpa_yardstick(torch, args, lens), REPS["paged"],
                          flush)
    bound_ms, _, nbytes, _ = cs._paged_bound(args, lens)
    result["paged"] = {"ms": ms, "sdpa_ms": sdpa_ms, "bound_ms": bound_ms,
                       "of_bound": bound_ms / ms, "gb_per_s": nbytes / ms / 1e6,
                       "max_abs_err": err}
    del args
    torch.cuda.empty_cache()

    x, w, gs = cs._payload_inputs(torch)
    err = (gk.grouped_matmul(x, w, gs) - grouped_matmul_ref(x, w, gs)).abs().max().item()
    ms = cs._time_ms(torch, lambda: gk.grouped_matmul(x, w, gs), REPS["gmm"], flush)
    bmm_ms = cs._time_ms(torch, cs._bmm_yardstick(torch, x, w, gs), REPS["gmm"], flush)
    bound_ms, _ = cs._bound(x, w, gs)
    flops = 2.0 * x.shape[0] * x.shape[1] * x.shape[2] * w.shape[2]
    result["gmm"] = {"ms": ms, "bmm_ms": bmm_ms, "bound_ms": bound_ms,
                     "of_bound": bound_ms / ms, "tflops": flops / ms / 1e9,
                     "max_abs_err": err}
    del x, w, gs
    torch.cuda.empty_cache()

    for name, E, C, d, f, tokens in cs.MOE_GMM:
        x, w, gs, _ = cs._moe_gmm_inputs(torch, E, C, d, f, tokens)
        ref = grouped_matmul_ref(x, w, gs).float()
        out = gk.grouped_matmul(x, w, gs).float()
        rel_l2 = ((out - ref).norm() / ref.norm()).item()
        ms = cs._time_ms(torch, lambda: gk.grouped_matmul(x, w, gs), REPS["gmm"], flush)
        bmm_ms = cs._time_ms(torch, cs._bmm_yardstick(torch, x, w, gs), REPS["gmm"], flush)
        bound_ms, _ = cs._bound(x, w, gs)
        result[f"gmm bf16 moe {name}"] = {
            "ms": ms, "bmm_ms": bmm_ms, "bound_ms": bound_ms, "of_bound": bound_ms / ms,
            "max_abs_err": (out - ref).abs().max().item(), "rel_l2": rel_l2}
        del x, w, gs, ref, out
        torch.cuda.empty_cache()
    print(json.dumps({"src": str(src), "card": torch.cuda.get_device_name(0),
                      "kernels": result}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="root of the checkout to compare with")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child)
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
                 "--child", str(sides[side])],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr[-4000:])
                raise SystemExit(f"the {side} run exited with {proc.returncode}")
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"side": side, **line}), flush=True)
            runs[side].append(line["kernels"])
    print(json.dumps({"median": {
        side: {name: {key: statistics.median(r[name][key] for r in rs)
                      for key in rs[0][name]} for name in rs[0]}
        for side, rs in runs.items()}}), flush=True)


if __name__ == "__main__":
    main()

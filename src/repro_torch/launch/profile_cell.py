"""Dry-run profiler: the per-cell debugging view, the counterpart of
``repro/launch/profile_cell.py``.

Counts one (arch x shape x mesh) cell exactly as ``dryrun.py`` does and
prints the roofline terms, memory, the collective bytes per kind and the
LARGEST collective contributors (wire bytes over all of a step's calls,
ranked by bytes x calls): on a machine without the cards, the dispatch
count is the ground truth for what DTensor will move over the wire.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.profile_cell --arch olmo-1b \\
      --shape train_4k [--multi-pod] [--remat dots] [--microbatches 4]
"""

from __future__ import annotations

import argparse
import json

import torch.distributed as dist

from .dryrun import fake_process_group, lower_cell
from .trace_analysis import top_collectives


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--remat", default="nothing")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--layout", default="tp", choices=["tp", "fsdp", "serve"])
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    fake_process_group(512 if args.multi_pod else 256)
    try:
        rec = lower_cell(
            args.arch, args.shape, multi_pod=args.multi_pod,
            remat_policy=args.remat, microbatches=args.microbatches,
            keep_hlo=True, layout=args.layout,
        )
    finally:
        dist.destroy_process_group()
    print(json.dumps(
        {k: rec[k] for k in (
            "arch", "shape", "mesh", "chips", "compile_seconds",
            "t_compute_s", "t_memory_s", "t_collective_s", "dominant",
            "useful_flops_fraction", "model_flops_util",
        )}, indent=1))
    print("memory/dev: "
          f"{rec['memory']['total_hbm_bytes'] / 1e9:.2f} GB "
          f"(peak {rec['memory']['peak_memory_in_bytes'] / 1e9:.2f} GB, "
          f"temp {rec['memory']['temp_size_in_bytes'] / 1e9:.2f} GB)")
    print("collectives/dev: "
          + ", ".join(f"{k}={v / 1e9:.2f}GB"
                      for k, v in rec["collectives"].items()
                      if k not in ("count",) and v))

    print(f"\ntop {args.top} collective contributors "
          "(bytes x calls, per device):")
    for name, kind, wire, calls in top_collectives(rec["_cost"], n=args.top):
        print(f"  {wire / 1e9:>9.3f} GB  x{calls:<6.0f} {kind:<18} {name}")


if __name__ == "__main__":
    main()

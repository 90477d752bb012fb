#!/usr/bin/env python3
"""Witness runs for ``chip_smoke.py``'s full-stream target check, on the CPU.

Run from the root of a checkout (no card needed):

    python3 tools/final_target_witness.py [--pairs 20] [--planted 4] [--procs 4]

Phase 5 of ``chip_smoke.py`` holds the live run's worker target to that of
a ``sleep``-payload witness made just before it, within ``TARGET_TOL``.
This tool runs ``2 * pairs`` such witnesses (the port's ``run_live``
in-process on the full 767-image microscopy stream, First-Fit, at
``FULL_TIME_SCALE``, ``procs`` at a time) and reads each pair with both
instants: the final target (the check before) and the target at the last
dispatch (``chip_smoke._target_at_last_dispatch``, the check now).  Then it
runs ``planted`` live runs of each wrong IRM below and holds each to a
witness, as phase 5 would:

  - ``no-scale-down``: the packing runs' target never falls;
  - ``next-fit``, ``best-fit``, ``worst-fit``: another packer in place of
    First-Fit.

It prints one JSON line per run and a summary line: for each check, how
many witness pairs fail it and which planted runs it catches.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PLANTED = ("no-scale-down", "next-fit", "best-fit", "worst-fit")


def one_run(kind: str) -> dict:
    """One live run of the sleep payload under the IRM ``kind``."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.irm import IRM
    from repro_torch.runtime import RuntimeConfig, run_live

    stream, sim_config, irm_config = cs._microscopy(smoke=False)
    ic = irm_config()
    if kind not in ("first-fit", "no-scale-down"):
        ic.allocator.algorithm = kind
    irm = IRM(ic)
    if kind == "no-scale-down":
        run, high = irm.packing_manager.run, [0]

        def never_lower(*args, **kwargs):
            packing = run(*args, **kwargs)
            high[0] = max(high[0], packing.target_workers)
            packing.target_workers = high[0]
            return packing

        irm.packing_manager.run = never_lower
    res = run_live(stream(), sim_config(), irm=irm,
                   runtime=RuntimeConfig(time_scale=cs.FULL_TIME_SCALE, payload="sleep"))
    return {"kind": kind, "completed": int(res.completed), "total": int(res.total),
            "final": int(res.target_workers[-1]),
            "at_last_dispatch": cs._target_at_last_dispatch(res),
            "max": int(res.target_workers.max())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=20)
    ap.add_argument("--planted", type=int, default=4, help="runs of each wrong IRM")
    ap.add_argument("--procs", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    kinds = ["first-fit"] * (2 * args.pairs) + [
        k for k in PLANTED for _ in range(args.planted)]
    runs = []
    with ProcessPoolExecutor(args.procs,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        for run in pool.map(one_run, kinds):
            print(json.dumps(run), flush=True)
            runs.append(run)
    witnesses = [r for r in runs if r["kind"] == "first-fit"]
    tol = cs.TARGET_TOL
    summary = {"pairs": args.pairs, "target_tol": tol,
               "witness_complete": all(r["completed"] == r["total"] for r in witnesses)}
    for key in ("final", "at_last_dispatch"):
        pairs = list(zip(witnesses[0::2], witnesses[1::2]))
        fails = sum(abs(a[key] - b[key]) > tol for a, b in pairs)
        counts = {}
        for r in witnesses:
            counts[r[key]] = counts.get(r[key], 0) + 1
        caught = {}
        for i, r in enumerate(r for r in runs if r["kind"] != "first-fit"):
            ref = witnesses[i % len(witnesses)][key]
            caught.setdefault(r["kind"], []).append(abs(r[key] - ref) > tol)
        summary[key] = {"witness_values": dict(sorted(counts.items())),
                        "witness_pairs_failing": fails,
                        "planted_caught": {k: f"{sum(v)}/{len(v)}" for k, v in caught.items()},
                        "planted_values": {k: sorted({r[key] for r in runs if r["kind"] == k})
                                           for k in PLANTED if args.planted}}
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()

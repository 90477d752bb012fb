"""The knee of a serving cell's traffic: the highest arrival rate the
program sustains, found once by a sweep on the card, in one process:

    python3 portbench/sweep.py --workload <cell> --seed N --rates 10,12,14 \
        [--cvs 1,2] [--seconds 25] [--out <file>]

For each coefficient of variation of the gaps (``arrival_cv``: 1 is
Poisson) and each rate, the cell's traffic with those two values and no
queue at the start, served as a run serves it for ``--seconds``; one JSON
line each: the requests, prompt tokens a second, the time to first token's
median and 95th percentile, the wait's 95th percentile and its mean over
the first and the last quarter of the arrivals, the mean batch, and the
seconds from the last arrival to its first token.  Where the last
quarter's wait grows well past the first's, the queue grows: the rate is
past the knee.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench import traffic as traffic_gen  # noqa: E402
from portbench.drivers import batched_prefill as bp  # noqa: E402


def point(prog, cfg, tr, seed: int, seconds: float) -> dict:
    """Serve the schedule of ``tr`` for ``seconds`` and read its queue."""
    due = bp.arrivals(tr, seconds)
    ids = [bp.prompts(cfg, [bp.length_of(tr, i)], seed, i)[0] for i in range(len(due))]
    out = prog.open_loop(due, ids)
    wait, q = out["wait"], max(1, len(due) // 4)
    return {"requests": len(due),
            "tokens_per_s": sum(len(x) for x in ids) / out["seconds"],
            "ttft_p50_ms": 1e3 * float(np.percentile(out["ttft"], 50)),
            "ttft_p95_ms": 1e3 * float(np.percentile(out["ttft"], 95)),
            "wait_p95_ms": 1e3 * float(np.percentile(wait, 95)),
            "wait_first_q_ms": 1e3 * float(wait[:q].mean()),
            "wait_last_q_ms": 1e3 * float(wait[-q:].mean()),
            "mean_batch": len(due) / len(out["batches"]),
            "drain_s": out["seconds"] - float(due[-1])}


def _floats(text: str):
    return [float(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--cvs", default="1")
    ap.add_argument("--seconds", type=float, default=25.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = harness.load_cell(ROOT, args.workload)
    if cell.traffic["kind"] != "batched_prefill":
        raise SystemExit(f"{cell.name} serves no requests")
    ctx = harness.Context(cell, args.seed, args.seconds, False, torch.device("cuda"),
                          time.perf_counter())
    prog = bp.Program(ctx)
    cfg, base = cell.config, cell.traffic
    first_pass = base["prompt_lengths"]
    for b in range(0, len(first_pass), base["batch"]):
        prog.serve(bp.prompts(cfg, first_pass[b:b + base["batch"]], args.seed,
                              traffic_gen.WARMUP, b))
    for cv in _floats(args.cvs):
        for rate in _floats(args.rates):
            tr = dict(base, arrival_rate=rate, arrival_cv=cv, arrival_burst=0)
            line = json.dumps({"cell": cell.name, "cv": cv, "rate": rate,
                               **point(prog, cfg, tr, args.seed, args.seconds)})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    prog.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())

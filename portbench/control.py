"""The readings a cell's limits are set from, on the card at the cell's own
size, in one process:

    python3 portbench/control.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds S] [--out <file>]

For each seed of ``--seeds`` the program's numbers: a run as the benchmark
drives it, with a window of ``--seconds`` (``run_seconds`` by default; a
train cell's window is one step), then the check.  For each of
``--control-seeds`` the control's: the reference computed in fp8
(``reference.model.Precision``) in the program's place, on as many prompts
as a run's check takes.  For each of ``--fault-seeds`` each fault of
``faults.py`` planted in the program.  Each reading is judged by the
harness's own comparison against the cell's limits.  One JSON line a
reading, with its verdict, on standard output and appended to ``--out``.
Exits 1 if a program reading is not correct or a control or fault reading
is.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import itertools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from portbench import faults, harness  # noqa: E402
from portbench.drivers import batched_prefill  # noqa: E402
from portbench.reference.judge import (  # noqa: E402
    prefill_numbers,
    prefill_outputs,
    train_numbers,
    train_outputs,
)
from portbench.reference.model import Precision  # noqa: E402


def program(cell, seed: int, seconds: float, device) -> dict:
    """The program's numbers: a run with a window of ``seconds`` (a train
    cell's: one step)."""
    tr = cell.traffic
    seconds = seconds if "arrival_rate" in tr else 0.0
    ctx = harness.Context(cell, seed, seconds, False, device, time.perf_counter())
    return importlib.import_module(f"portbench.drivers.{tr['kind']}").run(ctx)["checks"]


def control(cell, seed: int, seconds: float, device) -> dict:
    """The control's numbers: the reference in fp8 in the program's place.
    For serving, on the full batches of the requests due in ``seconds``
    that the check's ``Sample`` keeps, as many prompt tokens as a run's
    check takes."""
    cfg, tr = cell.config, cell.traffic
    if tr["kind"] == "packed_train":
        ref = train_outputs(cfg, tr, seed, tr["check_steps"], device, Precision("fp32"))
        low = train_outputs(cfg, tr, seed, tr["check_steps"], device, Precision("fp8"))
        return train_numbers(low, ref)
    n, B = len(batched_prefill.arrivals(tr, seconds)), tr["batch"]
    sample, ids = batched_prefill.Sample(tr, seed), []
    for k in range(0, n, B):
        lengths = [batched_prefill.length_of(tr, i) for i in range(k, min(k + B, n))]
        if sample.keep(k, lengths):
            ids.append([batched_prefill.prompts(cfg, [m], seed, k + i)[0]
                        for i, m in enumerate(lengths)])
    return prefill_numbers(cfg, prefill_outputs(cfg, ids, seed, device, Precision("fp8")),
                           seed, device)


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None, *, root: Path = ROOT, device=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = harness.load_cell(root, args.workload, spec)
    seconds = spec["run_seconds"] if args.seconds is None else args.seconds
    device = torch.device(device or "cuda")
    kind = cell.traffic["kind"]
    jobs = ([("program", s, None) for s in _seeds(args.seeds)]
            + [("control", s, None) for s in _seeds(args.control_seeds)]
            + [("fault", s, f) for s, f in itertools.product(_seeds(args.fault_seeds),
                                                            faults.FAULTS[kind])])
    wrong = []
    for what, seed, fault in jobs:
        t = time.perf_counter()
        if what == "program":
            numbers = program(cell, seed, seconds, device)
        elif what == "control":
            numbers = control(cell, seed, seconds, device)
        else:
            with faults.planted(kind, fault):
                numbers = program(cell, seed, seconds, device)
        correct, _ = harness._checks(numbers, cell.limits)
        if correct != (what == "program"):
            wrong.append((what, fault, seed))
        line = json.dumps({"cell": cell.name, "reading": what, "fault": fault, "seed": seed,
                           "numbers": numbers, "correct": correct,
                           "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(f"control: {len(jobs)} readings of {cell.name} against its limits; "
          f"judged wrongly: {wrong or 'none'}", file=sys.stderr)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())

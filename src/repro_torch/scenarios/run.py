"""Scenario CLI: ``PYTHONPATH=src python -m repro_torch.scenarios.run``.

One entry point for every registered workload:

  # list the catalogue
  python -m repro_torch.scenarios.run --list

  # the paper's synthetic experiment under First-Fit (same metrics the
  # fig3/4/5 benchmarks record)
  python -m repro_torch.scenarios.run synthetic --policy first-fit

  # sweep the whole Any-Fit family on the microscopy use case
  python -m repro_torch.scenarios.run microscopy --policy all

  # seconds-long deterministic smoke run (CI)
  python -m repro_torch.scenarios.run bursty --smoke

  # the same scenario on the live asyncio master/worker runtime
  python -m repro_torch.scenarios.run microscopy --smoke --backend live --time-scale 0.01

  # workers as OS processes behind pickled command/data queues
  python -m repro_torch.scenarios.run microscopy --smoke --backend multiproc

  # the same stream through the continuous-batching serving backend
  python -m repro_torch.scenarios.run bursty --backend serving --smoke

  # one Hopper grouped-matmul launch per message (needs a CUDA card)
  python -m repro_torch.scenarios.run microscopy --backend live --payload torch

``--out DIR`` writes the per-tick time series (scheduled/measured CPU per
worker, error, queue length, worker counts — the exact columns the paper's
figure benchmarks dump) as CSV plus a JSON summary per policy.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
from typing import Dict, List, Optional

from ..runtime.payloads import PAYLOADS
from .engine import (
    POLICIES,
    VECTOR_POLICIES,
    ScenarioResult,
    policies_for,
    run_scenario,
    sweep_policies,
)
from .registry import get_scenario, list_scenarios


def _dump_tick_csv(path: str, result: ScenarioResult) -> None:
    res = result.final
    W = res.scheduled_cpu.shape[1]
    header = (
        ["t"]
        + [f"sched_w{i}" for i in range(W)]
        + [f"meas_w{i}" for i in range(W)]
        + [f"err_w{i}" for i in range(W)]
        + ["queue_len", "active_workers", "target_workers", "ideal_bins",
           "pe_count"]
    )
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        err = res.error
        for i, t in enumerate(res.times):
            w.writerow(
                [float(t)]
                + [float(x) for x in res.scheduled_cpu[i]]
                + [float(x) for x in res.measured_cpu[i]]
                + [float(x) for x in err[i]]
                + [
                    float(res.queue_len[i]),
                    int(res.active_workers[i]),
                    int(res.target_workers[i]),
                    int(res.ideal_bins[i]),
                    int(res.pe_count[i]),
                ]
            )


def _print_summary(result: ScenarioResult) -> None:
    backend = "" if result.backend == "sim" else f" · backend {result.backend!r}"
    print(f"\n=== scenario {result.scenario!r} · policy {result.policy!r}"
          f"{backend} ===")
    for k, v in result.summary.items():
        if isinstance(v, float):
            print(f"  {k}: {v:.4g}")
        else:
            print(f"  {k}: {v}")
    if result.expectations:
        print("  expectations:")
        for name, ok in result.expectations.items():
            print(f"    [{'PASS' if ok else 'FAIL'}] {name}")


def _smoke_note(scn) -> None:
    print(
        f"(smoke run: {scn.smoke_overrides}; expectations are calibrated "
        "for the full-scale scenario and may not all hold at smoke scale)"
    )


def _list(args: argparse.Namespace) -> int:
    print(
        f"{'name':<14} {'runs':>4}  {'dims':<10} {'policies':<8} "
        f"{'backends':<27} {'tags':<24} description"
    )
    print("-" * 120)
    for scn in list_scenarios():
        tags = ",".join(scn.tags)
        dims = getattr(scn.sim_config(), "resource_dims", ("cpu",))
        family = "vector" if len(dims) > 1 else "any-fit"
        backends = ",".join(scn.backends)
        print(
            f"{scn.name:<14} {scn.n_runs:>4}  {'+'.join(dims):<10} "
            f"{family:<8} {backends:<27} {tags:<24} {scn.description}"
        )
        if args.verbose:
            for e in scn.expectations:
                print(f"{'':20}  expects: {e.name} — {e.description}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.scenarios.run",
        description="Run a registered workload scenario through the IRM.",
    )
    ap.add_argument("scenario", nargs="?", help="scenario name (see --list)")
    ap.add_argument("--list", action="store_true", help="list scenarios")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="with --list: also print expectations")
    ap.add_argument(
        "--policy", default=None,
        help="packing policy, comma-separated for a sweep, or 'all' — the "
        f"scenario's policy family: scalar ({', '.join(POLICIES)}) or, for "
        f"multi-resource scenarios, vector ({', '.join(VECTOR_POLICIES)}); "
        "default: the scenario's configured policy",
    )
    ap.add_argument("--backend",
                    choices=("sim", "live", "multiproc", "serving"),
                    default="sim",
                    help="cluster sim (paper testbed), live asyncio "
                    "master/worker runtime, the same runtime with workers "
                    "as OS processes (multiproc), or serving engine")
    ap.add_argument("--time-scale", type=float, default=0.02,
                    help="live backends: wall seconds per scenario second "
                    "(smaller = faster run, more concurrency jitter)")
    ap.add_argument("--payload", default="sleep",
                    choices=tuple(sorted(PAYLOADS)),
                    help="live backends: per-message PE payload")
    ap.add_argument("--measurement", choices=("emulated", "os"),
                    default="emulated",
                    help="multiproc backend: feed the profiler the sim's "
                    "emulated CPU draws (parity with the other backends) or "
                    "real per-message OS measurements from the worker "
                    "processes")
    ap.add_argument("--fail-worker", default=None, metavar="IDX:T",
                    help="inject a worker failure: kill worker IDX at "
                    "scenario time T seconds (sim and live backends; "
                    "in-flight messages requeue at the head, at-least-once)")
    ap.add_argument("--engine", choices=("object", "numpy", "auto"),
                    default=None,
                    help="packing engine override: per-bin object packers, "
                    "the array-backed numpy engine (decision-identical; "
                    "fast on large fleets), or auto (numpy above the "
                    "fleet-size threshold); default: the scenario's "
                    "allocator config")
    ap.add_argument("--seed", type=int, default=0, help="base stream seed")
    ap.add_argument("--runs", type=int, default=None,
                    help="override the scenario's run count")
    ap.add_argument("--t-max", type=float, default=None,
                    help="override the simulated-time cap (seconds)")
    ap.add_argument("--jobs", type=int, default=None,
                    help="worker processes for multi-policy sweeps (one "
                    "process per policy; default: min(#policies, CPUs); "
                    "1 forces the serial path)")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-long run via the scenario's smoke overrides")
    ap.add_argument("--out", default=None,
                    help="directory for per-tick CSV + summary JSON")
    ap.add_argument("--obs-out", default=None, metavar="DIR",
                    help="enable the observability plane and export the "
                    "event log (events.jsonl), Prometheus text "
                    "(metrics.prom) and run summary (summary.json) to DIR; "
                    "single-policy runs only")
    ap.add_argument("--obs-level", choices=("lifecycle", "full"),
                    default="full",
                    help="with --obs-out: 'lifecycle' skips IRM "
                    "decision-audit events (irm.pack); 'full' records "
                    "everything")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero if any expectation fails")
    args = ap.parse_args(argv)

    if args.list or not args.scenario:
        return _list(args)

    try:
        scn = get_scenario(args.scenario)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    stream_overrides = None
    t_max = args.t_max
    n_runs = args.runs
    if args.smoke:
        stream_overrides = scn.smoke_overrides
        if t_max is None:
            t_max = scn.smoke_t_max
        if n_runs is None:
            n_runs = 1
        _smoke_note(scn)

    if args.backend == "serving":
        from .serving import run_serving_scenario

        for flag, value in (("--policy", args.policy), ("--runs", args.runs),
                            ("--fail-worker", args.fail_worker),
                            ("--engine", args.engine),
                            ("--obs-out", args.obs_out),
                            ("--check", args.check or None)):
            if value is not None:
                print(f"note: {flag} does not apply to the serving backend "
                      "(admission is vector First-Fit; no sim expectations)",
                      file=sys.stderr)
        serving_kwargs = {}
        if t_max is not None:
            serving_kwargs["t_max"] = float(t_max)
        summary = run_serving_scenario(
            scn, seed=args.seed, stream_overrides=stream_overrides,
            **serving_kwargs,
        )
        eng = summary.pop("engine")
        print(f"\n=== scenario {scn.name!r} · backend serving ===")
        for k, v in summary.items():
            print(f"  {k}: {v:.4g}" if isinstance(v, float) else f"  {k}: {v}")
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            cols = ["t", "queue", "replicas", "target", "mean_slot_load",
                    "mean_page_load", "completed"]
            with open(os.path.join(args.out, f"{scn.name}_serving.csv"),
                      "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(cols)
                for m in eng.metrics:
                    w.writerow([m[c] for c in cols])
            with open(os.path.join(args.out, f"{scn.name}_serving.json"), "w") as f:
                json.dump(summary, f, indent=2)
            print(f"\nartifacts written to {args.out}")
        return 0

    if args.policy in (None, ""):
        policies = [None]
    elif args.policy == "all":
        # the scenario's policy family: vector packers for multi-resource
        # clusters, the scalar Any-Fit group otherwise
        policies = list(policies_for(scn))
    else:
        policies = [p.strip() for p in args.policy.split(",") if p.strip()]

    sim_overrides = None
    if args.fail_worker is not None:
        try:
            idx_s, _, t_s = args.fail_worker.partition(":")
            idx, when = int(idx_s), float(t_s)
            if idx < 0:
                raise ValueError(idx)
            sim_overrides = {"fail_worker_at": (idx, when)}
        except ValueError:
            print(f"error: --fail-worker expects IDX:T with IDX >= 0, got "
                  f"{args.fail_worker!r}", file=sys.stderr)
            return 2

    run_kwargs = dict(base_seed=args.seed, n_runs=n_runs,
                      stream_overrides=stream_overrides, t_max=t_max,
                      backend=args.backend, sim_overrides=sim_overrides,
                      engine=args.engine)
    if args.obs_out is not None:
        if len(policies) > 1:
            print("error: --obs-out requires a single policy (the event "
                  "log is per-run)", file=sys.stderr)
            return 2
        from ..obs import ObsConfig

        run_kwargs["obs"] = ObsConfig(out=args.obs_out, level=args.obs_level)
    if args.backend in ("live", "multiproc"):
        from ..runtime.live import RuntimeConfig

        run_kwargs["runtime"] = RuntimeConfig(
            time_scale=args.time_scale,
            payload=args.payload,
            transport="multiproc" if args.backend == "multiproc" else "inproc",
            measurement=args.measurement,
        )
    elif args.measurement != "emulated":
        print("note: --measurement applies to the multiproc backend only",
              file=sys.stderr)
    try:
        if len(policies) > 1 and None not in policies:
            # policy sweep: one process per policy (IRM state is per-policy)
            results = sweep_policies(
                scn, policies, jobs=args.jobs, **run_kwargs
            )
        else:
            results = {p: run_scenario(scn, policy=p, **run_kwargs)
                       for p in policies}
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    failed = False
    all_summaries: Dict[str, Dict] = {}
    for result in results.values():
        _print_summary(result)
        failed |= not result.ok
        all_summaries[result.policy] = {
            "summary": result.summary,
            "expectations": result.expectations,
        }
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            _dump_tick_csv(
                os.path.join(args.out, f"{scn.name}_{result.policy}.csv"),
                result,
            )
    if args.out:
        with open(os.path.join(args.out, f"{scn.name}_summary.json"), "w") as f:
            json.dump(all_summaries, f, indent=2)
        print(f"\nartifacts written to {args.out}")

    if args.check and failed:
        print("\nFAILED: one or more expectations did not hold", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

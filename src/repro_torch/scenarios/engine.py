"""Scenario runner: drive a registered scenario through the IRM.

One entry point — ``run_scenario`` — replaces the hand-rolled driver loops
the benchmarks used to carry: it builds the scenario's stream(s), applies a
packing policy (any ``make_packer`` name), keeps the IRM profiler alive
across the scenario's runs (the paper's 10-run persistence), and reduces
the recorded time series to the same summary metrics the paper's figures
report (utilization, scheduled-vs-measured error, worker targets).

Three interchangeable execution backends share this runner: the
discrete-event simulator (``backend="sim"``, the default — deterministic,
tick-exact), the live asyncio runtime (``backend="live"`` — real
concurrent master/worker execution in scaled wall-clock time,
``runtime``), and the same runtime over OS-process workers
(``backend="multiproc"`` — each worker is an ``mp.Process`` behind the
pickled command/data queues of ``runtime.transport.MultiprocTransport``).
All return ``SimResult``-shaped records, so the summaries, expectation
checks, and policy sweeps below are backend-blind.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..core.binpack import make_packer
from ..core.irm import IRM
from ..core.sim import SimResult, simulate
from ..obs import EventBus, ObsConfig, finalize_run
from .registry import Scenario, get_scenario

__all__ = ["ScenarioResult", "run_scenario", "sweep_policies",
           "summarize_result", "policies_for", "POLICIES", "VECTOR_POLICIES",
           "ACTIVE_THRESHOLD"]

# Packing policies the CLI sweeps; every name resolves via make_packer and
# supports the IRM's pre-filled open bins.  ``harmonic`` is deliberately
# absent: it has no pre-filled-bins mode (the allocator rejects it — see
# test_packing_rejects_non_anyfit) and exists for the algorithm-comparison
# microbenchmarks only.
POLICIES = ("first-fit", "first-fit-tree", "best-fit", "worst-fit", "next-fit")

# Vector policies for multi-resource scenarios (``SimConfig.resource_dims``
# beyond "cpu").  All support pre-filled vector bins; ``vector-ffd``
# reorders each packing run's drained batch largest-dominant-share first.
VECTOR_POLICIES = ("vector-first-fit", "vector-best-fit", "vector-next-fit",
                   "dominant-fit", "vector-ffd")


def policies_for(scenario: Union[str, "Scenario"]) -> Sequence[str]:
    """The policy family a scenario sweeps: vector policies when its
    cluster has more than one resource dimension, else the Any-Fit group."""
    scn = get_scenario(scenario) if isinstance(scenario, str) else scenario
    dims = getattr(scn.sim_config(), "resource_dims", ("cpu",))
    return VECTOR_POLICIES if len(dims) > 1 else POLICIES

# Activity threshold shared with the seed benchmarks and the library's
# expectation checks (a worker counts as scheduled when its packed load
# exceeds 5% of capacity).
ACTIVE_THRESHOLD = 0.05


@dataclasses.dataclass
class ScenarioResult:
    """Outcome of running one scenario under one packing policy."""

    scenario: str
    policy: str
    runs: List[SimResult]
    makespans: List[float]
    summary: Dict[str, float]
    expectations: Dict[str, bool]
    backend: str = "sim"
    # the observability bus of the *final* run (``run_scenario(obs=...)``);
    # ``None`` when observability was off
    obs: Optional[EventBus] = None

    @property
    def final(self) -> SimResult:
        """The last run — what the paper plots (its Figs. 8-10 use run 10)."""
        return self.runs[-1]

    @property
    def ok(self) -> bool:
        return all(self.expectations.values())


def summarize_result(res: SimResult, dt: float) -> Dict[str, float]:
    """Reduce one run's time series to the figures' summary metrics."""
    active = res.scheduled_cpu > ACTIVE_THRESHOLD
    err = res.error  # percentage points, (T, W)
    err_active = err[active]
    per_worker_load = res.scheduled_cpu.sum(axis=0) * dt  # worker-seconds
    w = len(per_worker_load)
    low = float(per_worker_load[: w // 2 + 1].sum())
    high = float(per_worker_load[w // 2 + 1:].sum())
    out = {
        "completed": int(res.completed),
        "total": int(res.total),
        "makespan_s": float(res.makespan),
        "mean_scheduled_utilization_active": float(
            res.scheduled_cpu[active].mean()
        ) if active.any() else 0.0,
        "mean_busy_utilization": res.mean_busy_utilization(),
        "mean_error_pp": float(err_active.mean()) if err_active.size else 0.0,
        "mean_abs_error_pp": float(np.abs(err_active).mean())
        if err_active.size else 0.0,
        "p95_abs_error_pp": float(np.percentile(np.abs(err_active), 95))
        if err_active.size else 0.0,
        "per_worker_load_s": [float(x) for x in per_worker_load],
        "low_index_load_fraction": low / max(low + high, 1e-9),
        "max_active_workers": int(res.active_workers.max()),
        "max_target_workers": int(res.target_workers.max()),
        "peak_queue_len": int(res.queue_len.max()),
        "peak_pe_count": int(res.pe_count.max()),
        "requeued": int(res.requeued),
    }
    if res.scheduled_res is not None:
        # per-dimension mean scheduled utilization over active cells
        for j, dim in enumerate(res.resource_dims):
            vals = res.scheduled_res[:, :, j][active]
            out[f"mean_scheduled_{dim}_active"] = (
                float(vals.mean()) if vals.size else 0.0
            )
        dom = res.scheduled_res.sum(axis=(0, 1)).argmax()
        out["bottleneck_dim"] = res.resource_dims[int(dom)]
    return out


def run_scenario(
    scenario: Union[str, Scenario],
    *,
    policy: Optional[str] = None,
    base_seed: int = 0,
    n_runs: Optional[int] = None,
    stream_overrides: Optional[Dict[str, object]] = None,
    t_max: Optional[float] = None,
    irm: Optional[IRM] = None,
    backend: str = "sim",
    runtime: Optional[object] = None,
    sim_overrides: Optional[Dict[str, object]] = None,
    engine: Optional[str] = None,
    obs: Optional[ObsConfig] = None,
) -> ScenarioResult:
    """Run a scenario end to end and evaluate its expectations.

    ``policy`` overrides the packing algorithm inside the scenario's IRM
    config (any ``make_packer`` name); ``None`` keeps the scenario default.
    ``engine`` overrides the allocator's packing engine (``"object"``,
    ``"numpy"``, or ``"auto"``); the numpy engine is decision-identical to
    the object packers (pinned by tests/test_packer_equivalence.py), so
    this only changes who computes the placements.
    Runs ``n_runs`` back-to-back simulations with stream seeds
    ``base_seed + i``, reusing one IRM so the profiler state persists across
    runs exactly as in the paper's repeated-run experiment.  ``t_max`` and
    ``stream_overrides`` shrink or grow the experiment (smoke runs, sweeps).
    ``sim_overrides`` replaces fields on the scenario's ``SimConfig`` —
    e.g. ``{"fail_worker_at": (0, 25.0)}`` injects a worker failure, which
    both the sim and live backends honor identically.

    ``backend`` selects the execution engine: ``"sim"`` (discrete-event,
    deterministic), ``"live"`` (the asyncio master/worker runtime; pass a
    ``runtime.RuntimeConfig`` as ``runtime`` to control time scale
    and payload), or ``"multiproc"`` (the live runtime with each worker
    promoted to an OS process — ``runtime.transport`` is forced to
    ``"multiproc"`` on the runtime config).  The same IRM code schedules
    all three.

    ``obs`` (an :class:`obs.ObsConfig`) enables the observability
    plane: each run records into a fresh :class:`obs.EventBus` with
    an identical schema across all three backends; the *final* run's bus
    is finalized (metrics folded, transport stats merged, exported to
    ``obs.out`` when set) and returned on ``ScenarioResult.obs``.
    """
    if backend not in ("sim", "live", "multiproc"):
        raise ValueError(
            f"unknown backend {backend!r}; expected 'sim', 'live' or "
            "'multiproc'"
        )
    if runtime is not None and backend == "sim":
        raise ValueError(
            "runtime config only applies to backend='live'/'multiproc'"
        )
    scn = get_scenario(scenario) if isinstance(scenario, str) else scenario
    if backend not in scn.backends:
        raise ValueError(
            f"scenario {scn.name!r} does not support backend {backend!r}; "
            f"supported: {scn.backends}"
        )
    irm_cfg = scn.irm_config()
    if policy is not None:
        if irm is not None:
            raise ValueError(
                "policy and irm are mutually exclusive: a pre-built IRM "
                "carries its own packing configuration"
            )
        make_packer(policy)  # validate the name before mutating the config
        irm_cfg.allocator.algorithm = policy
    if engine is not None:
        if irm is not None:
            raise ValueError(
                "engine and irm are mutually exclusive: a pre-built IRM "
                "carries its own packing configuration"
            )
        if engine not in ("object", "numpy", "auto"):
            raise ValueError(
                f"unknown engine {engine!r}; expected 'object', 'numpy' "
                "or 'auto'"
            )
        irm_cfg.allocator.engine = engine
    if irm is None:
        irm = IRM(irm_cfg)
    else:
        irm_cfg = irm.config

    sim_cfg = scn.sim_config()
    if t_max is not None:
        sim_cfg = dataclasses.replace(sim_cfg, t_max=float(t_max))
    if sim_overrides:
        sim_cfg = dataclasses.replace(sim_cfg, **sim_overrides)

    if backend in ("live", "multiproc"):
        from ..runtime.live import RuntimeConfig, run_live

        rt = runtime if runtime is not None else RuntimeConfig()
        if backend == "multiproc" and rt.transport != "multiproc":
            rt = dataclasses.replace(rt, transport="multiproc")
    runs: List[SimResult] = []
    makespans: List[float] = []
    n = n_runs if n_runs is not None else scn.n_runs
    overrides = stream_overrides or {}
    bus: Optional[EventBus] = None
    live_stats: Optional[Dict[str, object]] = None
    for i in range(n):
        stream = scn.make_stream(base_seed + i, **overrides)
        if obs is not None:
            bus = EventBus(level=obs.level)  # fresh bus per run
        if backend in ("live", "multiproc"):
            live_stats = {} if obs is not None else None
            res = run_live(stream, sim_cfg, irm=irm, runtime=rt,
                           stats=live_stats, bus=bus)
        else:
            res = simulate(stream, sim_cfg, irm=irm, bus=bus)
        runs.append(res)
        makespans.append(float(res.makespan))
    if bus is not None:
        tstats = live_stats.get("transport") if live_stats else None
        finalize_run(bus, out=obs.out, transport_stats=tstats,
                     extra={"scenario": scn.name,
                            "policy": policy or irm_cfg.allocator.algorithm,
                            "backend": backend})

    summary = summarize_result(runs[-1], sim_cfg.dt)
    summary["makespans_s"] = makespans
    if len(makespans) > 1:
        summary["run1_vs_best_profiled"] = float(
            makespans[0] / max(min(makespans[1:]), 1e-9)
        )
    expectations = {e.name: e.evaluate(runs[-1]) for e in scn.expectations}
    return ScenarioResult(
        scenario=scn.name,
        policy=policy or irm_cfg.allocator.algorithm,
        runs=runs,
        makespans=makespans,
        summary=summary,
        expectations=expectations,
        backend=backend,
        obs=bus,
    )


# ---------------------------------------------------------------------------
# Parallel policy sweeps
# ---------------------------------------------------------------------------


def _sweep_one(args: tuple) -> ScenarioResult:
    """Process-pool entry point: runs exactly one (scenario, policy) cell.

    Must be a module-level function (picklable); the scenario travels by
    *name* and is re-resolved from the registry in the child process.
    """
    name, policy, kwargs = args
    return run_scenario(name, policy=policy, **kwargs)


def sweep_policies(
    scenario: Union[str, Scenario],
    policies: Sequence[str] = POLICIES,
    *,
    jobs: Optional[int] = None,
    base_seed: int = 0,
    n_runs: Optional[int] = None,
    stream_overrides: Optional[Dict[str, object]] = None,
    t_max: Optional[float] = None,
    backend: str = "sim",
    runtime: Optional[object] = None,
    sim_overrides: Optional[Dict[str, object]] = None,
    engine: Optional[str] = None,
) -> Dict[str, ScenarioResult]:
    """Run one scenario under every policy, one process per policy.

    IRM state (profiler, queues, predictor) is constructed per policy inside
    ``run_scenario``, so the sweep cells are fully independent and the
    parallel results are identical to a serial loop — this is what makes
    broad policy evaluations (the many-cheap-runs methodology of the
    autoscaling-evaluation literature) practical on the fast sim core.

    ``jobs`` caps worker processes (default: ``min(len(policies), cpus)``);
    ``jobs=1`` — or an unregistered ad-hoc ``Scenario`` object, which cannot
    be re-resolved inside a child process — falls back to the serial loop.
    Results keep the order of ``policies``.
    """
    policies = list(policies)
    for p in policies:
        make_packer(p)  # validate every name before spawning workers
    kwargs = dict(base_seed=base_seed, n_runs=n_runs,
                  stream_overrides=stream_overrides, t_max=t_max,
                  backend=backend, runtime=runtime,
                  sim_overrides=sim_overrides, engine=engine)

    scn = get_scenario(scenario) if isinstance(scenario, str) else scenario
    try:
        registered = get_scenario(scn.name) is scn
    except KeyError:
        registered = False
    if jobs is None:
        jobs = min(len(policies), os.cpu_count() or 1)
    if jobs <= 1 or len(policies) <= 1 or not registered:
        return {p: run_scenario(scn, policy=p, **kwargs) for p in policies}

    import concurrent.futures as cf
    from concurrent.futures.process import BrokenProcessPool

    work = [(scn.name, p, kwargs) for p in policies]
    try:
        with cf.ProcessPoolExecutor(max_workers=jobs) as ex:
            results = list(ex.map(_sweep_one, work))
    except (KeyError, BrokenProcessPool):
        # Under the spawn start method (macOS/Windows) a child only sees
        # scenarios registered at import time; a dynamically registered one
        # raises KeyError there even though the parent resolved it.  Fall
        # back to the serial loop rather than crash.
        return {p: run_scenario(scn, policy=p, **kwargs) for p in policies}
    return {p: r for p, r in zip(policies, results, strict=True)}

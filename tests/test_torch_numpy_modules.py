"""The numpy/stdlib modules the port keeps its own copies of, against the
JAX package's: the Spark dynamic-allocation baseline, the ClusterView
conformance checker, the serving scenario adapter and the obs analyzer CLI.

Both packages run the same numpy code on the same inputs, so every result
must be equal, not close.  The last test is the paper's headline claim run
through the port alone: HarmonicIO's First-Fit bin-packing drains the
image stream well ahead of Spark's dynamic allocation.
"""

import asyncio
import contextlib
import io

import numpy as np
import pytest

from repro.core import SparkConfig as RefSparkConfig
from repro.core import simulate_spark as ref_simulate_spark
from repro.core import verify_cluster_view as ref_verify_cluster_view
from repro.obs.__main__ import main as ref_obs_main
from repro.scenarios import run_serving_scenario as ref_run_serving_scenario
from repro.scenarios import stream_to_requests as ref_stream_to_requests
from repro.scenarios.registry import get_scenario as ref_get_scenario
from repro_torch.core import (
    IRM,
    IRMConfig,
    SimConfig,
    SparkConfig,
    SparkResult,
    simulate,
    simulate_spark,
    usecase_workload,
    verify_cluster_view,
)
from repro_torch.core.resources import Resources
from repro_torch.core.sim import SimCluster
from repro_torch.obs import ObsConfig
from repro_torch.obs.__main__ import main as obs_main
from repro_torch.obs.exporters import write_jsonl
from repro_torch.scenarios import run as cli
from repro_torch.scenarios import run_serving_scenario, stream_to_requests
from repro_torch.scenarios.engine import run_scenario
from repro_torch.scenarios.registry import get_scenario
from repro_torch.scenarios.streams import Message
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

SPARK_ARRAYS = ("times", "executor_cores", "used_cores", "pending_tasks")


def _worker_seconds(res, cfg):
    """Executor time the run held, in worker (executor) seconds."""
    return float(res.executor_cores.sum()) * cfg.dt / cfg.executor_cores


# ---------------------------------------------------------------------------
# the Spark baseline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_simulate_spark_matches_jax_on_the_microscopy_stream(smoke):
    kw = ref_get_scenario("microscopy").smoke_overrides if smoke else {}
    ref = ref_simulate_spark(ref_get_scenario("microscopy").make_stream(0, **kw),
                             RefSparkConfig())
    res = simulate_spark(get_scenario("microscopy").make_stream(0, **kw), SparkConfig())
    assert isinstance(res, SparkResult)
    for field in SPARK_ARRAYS:
        np.testing.assert_array_equal(getattr(res, field), getattr(ref, field),
                                      err_msg=field)
    assert res.scale_downs == ref.scale_downs
    assert (res.completed, res.total, res.makespan) == (
        ref.completed, ref.total, ref.makespan)
    assert res.completed == res.total > 0
    assert _worker_seconds(res, SparkConfig()) == _worker_seconds(ref, RefSparkConfig())


def test_paper_headline_hio_beats_spark_through_the_port():
    """Section VI-B, as ``tests/test_system.py`` asserts it for the JAX
    package: HIO+IRM drains 200 images in well under Spark's wall time."""
    hio = simulate(
        usecase_workload(seed=0, n_images=200),
        SimConfig(dt=0.5, cores_per_worker=8, max_workers=5,
                  worker_boot_delay=10.0, pe_start_delay=2.0, t_max=3000.0),
    )
    spark = simulate_spark(usecase_workload(seed=0, n_images=200),
                           SparkConfig(t_max=3000.0))
    assert hio.completed == hio.total
    assert spark.completed == spark.total
    assert spark.makespan > 1.3 * hio.makespan


# ---------------------------------------------------------------------------
# ClusterView conformance: the checks of tests/test_view_conformance.py on
# the port's views.  A view whose returns hold no ``Resources`` is also held
# to the JAX package's checker (which type-checks against its own class).
# ---------------------------------------------------------------------------


def _check(view, vector=False):
    """The port's checker's findings, equal to the JAX package's where the
    view holds no ``Resources``."""
    problems = verify_cluster_view(view)
    if not vector:
        assert problems == ref_verify_cluster_view(view)
    return problems


def _make_live_cluster(cfg, irm):
    from repro_torch.runtime.clock import ScaledClock
    from repro_torch.runtime.lifecycle import Lifecycle
    from repro_torch.runtime.live import LiveCluster
    from repro_torch.runtime.master import Master
    from repro_torch.runtime.payloads import SleepPayload
    from repro_torch.runtime.worker import WorkerPool

    clock = ScaledClock(0.005)
    master = Master()
    pool = WorkerPool(cfg, master, clock, SleepPayload(), poll_interval=0.5)
    lifecycle = Lifecycle(pool, cfg, clock)
    return LiveCluster(cfg, irm, master, pool, lifecycle), master, clock


@pytest.mark.parametrize("dims", [None, ("cpu", "mem")], ids=["scalar", "vector"])
def test_sim_view_conforms(dims):
    cfg = SimConfig() if dims is None else SimConfig(resource_dims=dims)
    cluster = SimCluster(cfg, IRM(IRMConfig()))
    vector = dims is not None
    assert _check(cluster, vector) == []
    cluster._push_back(Message(image="a", duration=5.0, resources={"mem": 0.3}
                               if dims else None))
    cluster._push_back(Message(image="b", duration=5.0))
    cluster.scale_workers(2)
    assert _check(cluster, vector) == []
    if dims:
        assert isinstance(cluster.backlog_resource_demand(), Resources)


@pytest.mark.timeout(30)
@pytest.mark.parametrize("dims", [None, ("cpu", "mem")], ids=["scalar", "vector"])
def test_live_view_conforms(dims):
    async def go():
        cfg = SimConfig() if dims is None else SimConfig(resource_dims=dims)
        cluster, master, clock = _make_live_cluster(cfg, IRM(IRMConfig()))
        clock.start()
        vector = dims is not None
        assert _check(cluster, vector) == []
        master.push_back(Message(image="a", duration=5.0,
                                 resources={"mem": 0.3} if dims else None))
        cluster.scale_workers(2)
        assert _check(cluster, vector) == []
        if dims:
            assert isinstance(cluster.backlog_resource_demand(), Resources)
        return True

    assert asyncio.run(go())


def test_serving_view_conforms_and_its_actuators_drive_the_engine():
    from repro_torch.core.queues import HostRequest

    eng = ServingEngine(EngineConfig())
    view = eng.cluster_view()  # its loads are Resources
    assert _check(view, vector=True) == []
    eng.submit(Request(prompt_len=64, max_new_tokens=32, req_class="a"))
    eng.submit(Request(prompt_len=64, max_new_tokens=32, req_class="b"))
    assert _check(view, vector=True) == []
    assert isinstance(view.backlog_resource_demand(), Resources)
    view.scale_workers(2)
    assert eng._target == 2
    assert view.try_start_pe(HostRequest(image="a", size_estimate=0.1, target_worker=0))
    assert not view.try_start_pe(
        HostRequest(image="zzz", size_estimate=0.1, target_worker=0))


@pytest.mark.timeout(60)
def test_sim_views_conform_mid_run():
    """The port's simulator stays conformant in the middle of a real
    workload (``test_registered_scenarios_views_conform_mid_run``)."""
    scn = get_scenario("synthetic")
    cfg = scn.sim_config()
    cfg.t_max = 30.0  # stop mid-stream
    checked = []

    class CheckingIRM(IRM):
        def step(self, t, view):
            if len(checked) < 5:
                assert _check(view) == []
                checked.append(t)
            return super().step(t, view)

    simulate(scn.make_stream(0, **scn.smoke_overrides), cfg, irm=CheckingIRM(IRMConfig()))
    assert len(checked) == 5


def test_checker_flags_missing_and_malformed_views_as_jax_does():
    class MissingActuators:
        def queue_length(self):
            return 0.0

        def queue_image_mix(self):
            return {}

        def worker_scheduled_loads(self):
            return []

    class Malformed:
        def queue_length(self):
            return -1.0

        def queue_image_mix(self):
            return {"a": 0.4, "b": 0.4}

        def worker_scheduled_loads(self):
            return ["not-a-load"]

        def try_start_pe(self, req):
            return False

        def scale_workers(self, target):
            pass

        def backlog_resource_demand(self):
            return 42

    missing = _check(MissingActuators())
    assert any("try_start_pe" in p for p in missing)
    assert any("scale_workers" in p for p in missing)
    bad = _check(Malformed())
    for what in ("non-negative", "sum to 1", "float or Resources",
                 "backlog_resource_demand"):
        assert any(what in p for p in bad), what


# ---------------------------------------------------------------------------
# the serving scenario adapter and the CLI's serving backend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["bursty", "microscopy-mem"])
def test_serving_backend_drains_the_scenario_stream_as_jax_does(name):
    """``test_scenarios.py::test_serving_backend_drains_scenario_stream`` and
    ``test_vector_scenarios.py::test_serving_backend_drains_vector_scenario``
    through the port, each summary equal to the JAX package's."""
    scn, ref_scn = get_scenario(name), ref_get_scenario(name)
    summary = run_serving_scenario(scn, stream_overrides=scn.smoke_overrides,
                                   t_max=600.0)
    ref = ref_run_serving_scenario(ref_scn, stream_overrides=ref_scn.smoke_overrides,
                                   t_max=600.0)
    assert summary["completed"] == summary["submitted"] > 0
    assert summary["peak_replicas"] >= 1
    eng, ref_eng = summary.pop("engine"), ref.pop("engine")
    assert summary == ref
    assert eng.metrics == ref_eng.metrics


def test_stream_to_requests_matches_jax():
    kw = get_scenario("microscopy-mem").smoke_overrides
    sched = stream_to_requests(get_scenario("microscopy-mem").make_stream(0, **kw))
    ref = ref_stream_to_requests(ref_get_scenario("microscopy-mem").make_stream(0, **kw))
    assert len(sched) == len(ref) > 0
    for (t, r), (rt, rr) in zip(sched, ref, strict=True):
        assert t == rt
        assert (r.prompt_len, r.max_new_tokens, r.req_class) == (
            rr.prompt_len, rr.max_new_tokens, rr.req_class)


def test_cli_serving_backend_writes_its_artifacts(tmp_path, capsys):
    assert cli.main(["bursty", "--backend", "serving", "--smoke",
                     "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "backend serving" in out and "completed: " in out
    assert (tmp_path / "bursty_serving.csv").exists()
    assert (tmp_path / "bursty_serving.json").exists()


# ---------------------------------------------------------------------------
# the obs analyzer CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def event_logs(tmp_path_factory):
    """Two event logs of the port's simulator on the microscopy smoke stream,
    one with a worker failure, for ``diff``."""
    scn = get_scenario("microscopy")
    logs = []
    for name, overrides in (("run", None), ("fault", {"fail_worker_at": (0, 20.5)})):
        res = run_scenario("microscopy", backend="sim", policy="first-fit",
                           base_seed=0, n_runs=1, stream_overrides=scn.smoke_overrides,
                           t_max=scn.smoke_t_max, sim_overrides=overrides,
                           obs=ObsConfig(level="full"))
        path = tmp_path_factory.mktemp("obs") / f"{name}.jsonl"
        write_jsonl(path, res.obs.events)
        logs.append((path, res.obs.events))
    return logs


def _run_cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = main(argv)
    return code, out.getvalue(), err.getvalue()


def test_obs_cli_subcommands_match_jax(event_logs, tmp_path):
    """``test_obs.py::test_cli_subcommands`` through the port's CLI, each
    subcommand's exit code and output equal to the JAX package's."""
    (log, events), (other, _) = event_logs
    enqueued = [e["msg_id"] for e in events if e["ev"] == "msg.enqueued"]
    bad = tmp_path / "bad.jsonl"
    broken = [dict(e) for e in events]
    broken[0]["mystery"] = True
    write_jsonl(bad, broken)
    cases = [
        (["schema-check", str(log)], 0),
        (["latency", str(log), "--json"], 0),
        (["latency", str(log)], 0),
        (["trace", str(log), "--msg", str(min(enqueued))], 0),
        (["trace", str(log), "--msg", str(max(enqueued) + 10_000)], 1),
        (["audit", str(log)], 0),
        (["diff", str(log), str(other)], 0),
        (["summary", str(log)], 0),
        (["schema-check", str(bad)], 1),
    ]
    for argv, want in cases:
        got = _run_cli(obs_main, argv)
        assert got[0] == want, (argv, got)
        assert got == _run_cli(ref_obs_main, argv), argv

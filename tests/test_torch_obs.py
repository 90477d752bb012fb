"""The port's observability plane: one payload schema per event type.

The runtime half of rule R6 of ``python -m repro_torch.analysis``: the
rule checks the port's ``bus.emit`` call sites statically against
``src/repro_torch/obs/event_manifest.json``, whose ``schema_test`` this
file is; here the port's three backends run and must produce identical
payload schemas, as ``tests/test_obs.py`` holds the JAX package's.  The
runs are the microscopy smoke scenario under first-fit with the ``sleep``
payload on the CPU.  Each schema is also held to the JAX sim backend's on
the same scenario.

The multiproc runs go into a fresh interpreter: the transport forks its
workers, and a process that ran torch ops before the fork can hang them.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.obs import ObsConfig as RefObsConfig
from repro.obs.analyze import load_manifest as ref_load_manifest
from repro.obs.analyze import schema_of as ref_schema_of
from repro.scenarios.engine import run_scenario as ref_run_scenario
from repro_torch.analysis.protocol import load_committed_manifest, replay_events
from repro_torch.obs import ObsConfig
from repro_torch.obs.analyze import load_manifest, schema_of, validate_events
from repro_torch.obs.exporters import load_events
from repro_torch.runtime import RuntimeConfig
from repro_torch.scenarios.engine import run_scenario
from repro_torch.scenarios.registry import get_scenario

ROOT = Path(__file__).resolve().parents[1]

#: Every event type the manifest pins — listed literally so both this
#: test and the R6 "exercised" check can see each one.
EXPECTED_TYPES = (
    "msg.enqueued",
    "msg.pulled",
    "msg.started",
    "msg.completed",
    "msg.requeued",
    "worker.boot",
    "worker.active",
    "worker.deactivate",
    "worker.kill",
    "pe.spawn",
    "pe.exit",
    "irm.pack",
)

#: worker 0 killed at 20.5 s of the stream, as tests/test_obs.py kills it
FAULT = {"fail_worker_at": (0, 20.5)}


def _kwargs(sim_overrides=None):
    scn = get_scenario("microscopy")
    return dict(policy="first-fit", base_seed=0, n_runs=1,
                stream_overrides=scn.smoke_overrides, t_max=scn.smoke_t_max,
                sim_overrides=sim_overrides)


def _run(backend, *, sim_overrides=None, time_scale=0.01):
    kwargs = _kwargs(sim_overrides)
    if backend != "sim":
        kwargs["runtime"] = RuntimeConfig(time_scale=time_scale)
    res = run_scenario("microscopy", backend=backend, obs=ObsConfig(level="full"), **kwargs)
    assert res.obs is not None
    return res.obs.events


# both multiproc runs (clean at 0.02, the kill at 0.05 wall s per stream s,
# as tests/test_obs.py runs them), each bus written to a directory argv[1]
MP_RUNS = r"""
import sys
from pathlib import Path
from repro_torch.obs import ObsConfig
from repro_torch.obs.exporters import write_jsonl
from repro_torch.runtime import RuntimeConfig
from repro_torch.scenarios.engine import run_scenario
from repro_torch.scenarios.registry import get_scenario

scn = get_scenario("microscopy")
for name, scale, overrides in (("multiproc", 0.02, None),
                               ("multiproc+kill", 0.05, {"fail_worker_at": (0, 20.5)})):
    res = run_scenario("microscopy", backend="multiproc", policy="first-fit", base_seed=0,
                       n_runs=1, stream_overrides=scn.smoke_overrides, t_max=scn.smoke_t_max,
                       sim_overrides=overrides, obs=ObsConfig(level="full"),
                       runtime=RuntimeConfig(time_scale=scale))
    write_jsonl(Path(sys.argv[1]) / f"{name}.jsonl", res.obs.events)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The events of every run: the port's sim, live and multiproc
    backends, and the sim and multiproc ones with worker 0 killed."""
    out = tmp_path_factory.mktemp("mp")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-c", MP_RUNS, str(out)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=100)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {
        "sim": _run("sim"),
        "live": _run("live"),
        "sim+kill": _run("sim", sim_overrides=FAULT),
        **{name: load_events(out / f"{name}.jsonl")
           for name in ("multiproc", "multiproc+kill")},
    }


@pytest.mark.timeout(120)
def test_schema_identical_across_backends(runs):
    """All three backends emit identical payload schemas on the shared
    scenario, and every observed type conforms to the manifest."""
    schemas = {}
    for name in ("sim", "live", "multiproc"):
        assert validate_events(runs[name]) == [], name
        schemas[name] = schema_of(runs[name])
    common = set(schemas["sim"]) & set(schemas["live"]) & set(schemas["multiproc"])
    # the happy path must produce the full lifecycle on every backend
    assert {"msg.enqueued", "msg.pulled", "msg.started", "msg.completed",
            "worker.boot", "worker.active", "pe.spawn", "pe.exit",
            "irm.pack"} <= common
    for ev in common:
        pinned = json.dumps(schemas["sim"][ev], sort_keys=True)
        assert json.dumps(schemas["live"][ev], sort_keys=True) == pinned
        assert json.dumps(schemas["multiproc"][ev], sort_keys=True) == pinned


@pytest.mark.timeout(120)
def test_fault_runs_cover_the_remaining_types(runs):
    """worker.kill / msg.requeued only appear under faults; with those
    runs included, the union of observed types is the entire manifest."""
    observed = set()
    for name in ("sim+kill", "multiproc+kill"):
        assert validate_events(runs[name]) == [], name
        observed |= {e["ev"] for e in runs[name]}
    assert {"worker.kill", "msg.requeued", "worker.deactivate"} <= observed


@pytest.mark.timeout(120)
def test_event_logs_conform_to_the_protocol_machines(runs):
    """Every backend's log, clean runs and kill runs alike, replays
    against the port's protocol machines with no violation."""
    manifest = load_committed_manifest()
    for name, events in runs.items():
        summary = replay_events(events, manifest)
        assert summary.ok, (name, [str(v) for v in summary.violations])
        assert summary.completed > 0, name
    # the kill runs must exercise the requeue edge, or this test would pass
    # on logs that never saw a failure
    assert replay_events(runs["sim+kill"], manifest).requeued > 0
    assert replay_events(runs["multiproc+kill"], manifest).requeued > 0


@pytest.mark.timeout(120)
def test_manifest_matches_expected_types(runs):
    assert set(load_manifest()["events"]) == set(EXPECTED_TYPES)
    observed = {e["ev"] for e in runs["sim"]} | {e["ev"] for e in runs["sim+kill"]}
    assert observed == set(EXPECTED_TYPES)


@pytest.mark.timeout(120)
def test_schemas_match_the_jax_sim_backend(runs):
    """Each backend's schema per event type is the JAX sim backend's on the
    same scenario, and the port's manifest pins the JAX manifest's fields."""
    assert load_manifest()["events"] == ref_load_manifest()["events"]
    ref = {}
    for sim_overrides in (None, FAULT):
        res = ref_run_scenario("microscopy", backend="sim", obs=RefObsConfig(level="full"),
                               **_kwargs(sim_overrides))
        ref.update(ref_schema_of(res.obs.events))
    assert set(ref) == set(EXPECTED_TYPES)
    for name, events in runs.items():
        for ev, schema in schema_of(events).items():
            assert json.dumps(schema, sort_keys=True) == json.dumps(ref[ev], sort_keys=True), \
                (name, ev)

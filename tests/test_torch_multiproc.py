"""The port's multiproc backend with the ``torch`` payload, on the CPU.

Workers are forked, and torch CPU ops run in a process before ``fork``
can hang the forked workers' thread pools.  The tests of one file share a
process, and that process may have run other files' tests first, so the
run goes into a fresh interpreter that imports torch and runs no op of
it before its workers fork.  The result is held to the parity bands of
``repro.core.sim.simulate`` on the same stream.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core.irm import IRM as RefIRM
from repro.core.sim import simulate as ref_simulate
from repro.scenarios.engine import summarize_result as ref_summarize
from repro.scenarios.registry import get_scenario as ref_get_scenario

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("completed", "total", "makespan_s",
        "mean_scheduled_utilization_active", "max_target_workers")

RUN = r"""
import json, sys
from repro_torch.core.irm import IRM
from repro_torch.runtime import RuntimeConfig, run_live
from repro_torch.scenarios.engine import summarize_result
from repro_torch.scenarios.registry import get_scenario

scn = get_scenario("microscopy")
cfg = scn.sim_config()
cfg.t_max = scn.smoke_t_max
ic = scn.irm_config()
ic.allocator.algorithm = "first-fit"
stats = {}
res = run_live(
    scn.make_stream(0, **scn.smoke_overrides), cfg, irm=IRM(ic),
    runtime=RuntimeConfig(time_scale=float(sys.argv[1]), payload="torch",
                          payload_kwargs={"device": "cpu"},
                          transport="multiproc"),
    stats=stats,
)
s = summarize_result(res, cfg.dt)
print(json.dumps({**{k: s[k] for k in sys.argv[2].split(",")},
                  "final_target": int(res.target_workers[-1]),
                  "workers_spawned": stats["transport"]["workers_spawned"],
                  "launches": stats["transport"]["payload_kernel_launches"],
                  "device_ms": stats["payload_device_ms"]}))
"""

# a payload whose workers report one launch and 1.5 device ms per message,
# on top of 2 set-up launches per process: what the master must sum
COUNTING = r"""
import json
from repro_torch.runtime import RuntimeConfig, run_live
from repro_torch.runtime.payloads import PAYLOADS, SleepPayload
from repro_torch.scenarios.registry import get_scenario

class Counting(SleepPayload):
    def __init__(self):
        self.n = 2
    def run_sync(self, msg, time_scale):
        super().run_sync(msg, time_scale)
        self.n += 1
        return 1.5
    def kernel_launches(self):
        return self.n

PAYLOADS["counting"] = Counting
scn = get_scenario("microscopy")
cfg = scn.sim_config()
cfg.t_max = scn.smoke_t_max
stats = {}
res = run_live(scn.make_stream(0, **scn.smoke_overrides), cfg,
               runtime=RuntimeConfig(time_scale=0.02, payload="counting",
                                     transport="multiproc"),
               stats=stats)
print(json.dumps({"completed": res.completed,
                  "workers_spawned": stats["transport"]["workers_spawned"],
                  "launches": stats["transport"]["payload_kernel_launches"],
                  "device_ms": stats["payload_device_ms"]}))
"""


def _run(script, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-c", script, *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=200,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.timeout(240)
def test_multiproc_torch_payload_matches_reference_sim():
    live = _run(RUN, "0.05", ",".join(KEYS))

    scn = ref_get_scenario("microscopy")
    cfg = scn.sim_config()
    cfg.t_max = scn.smoke_t_max
    ic = scn.irm_config()
    ic.allocator.algorithm = "first-fit"
    ref = ref_simulate(scn.make_stream(0, **scn.smoke_overrides), cfg,
                       irm=RefIRM(ic))
    sim = ref_summarize(ref, cfg.dt)

    assert live["completed"] == live["total"] == 40
    assert live["workers_spawned"] >= 1
    # the plain CPU version launches no kernel and takes no device time
    assert live["launches"] == 0 and live["device_ms"] == []
    assert sim["completed"] >= 0.9 * sim["total"]
    assert live["mean_scheduled_utilization_active"] == pytest.approx(
        sim["mean_scheduled_utilization_active"], abs=0.15)
    assert abs(live["max_target_workers"] - sim["max_target_workers"]) <= 2
    assert abs(live["final_target"] - int(ref.target_workers[-1])) <= 2
    assert sim["makespan_s"] / 1.6 <= live["makespan_s"] \
        <= 1.6 * sim["makespan_s"]


@pytest.mark.timeout(120)
def test_multiproc_sums_the_workers_payload_reports():
    got = _run(COUNTING)
    assert got["completed"] == 40
    assert got["workers_spawned"] >= 2
    assert got["launches"] == 40 + 2 * got["workers_spawned"]
    assert got["device_ms"] == [1.5] * 40

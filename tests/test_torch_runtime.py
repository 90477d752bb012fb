"""The port's streaming path on the CPU against the JAX package's.

- ``TorchPayload`` takes the JAX payload's draws and reproduces its output;
- the port's ``run_live`` with the ``torch`` payload (plain version, on the
  CPU) completes the stream and stays inside the parity bands of
  ``repro.core.sim.simulate``;
- the port's verbatim numpy copies (IRM, sim) give time series identical
  to the reference's;
- nothing in the port imports JAX or the JAX package.

The multiproc run has a file of its own (``test_torch_multiproc.py``).
"""

import ast
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core.irm import IRM as RefIRM
from repro.core.sim import simulate as ref_simulate
from repro.kernels.grouped_matmul.ops import gmm as jax_gmm
from repro.runtime.payloads import JaxPayload
from repro.scenarios.engine import summarize_result as ref_summarize
from repro.scenarios.registry import get_scenario as ref_get_scenario
from repro.scenarios.registry import scenario_names as ref_scenario_names
from repro_torch.core.irm import IRM
from repro_torch.core.sim import simulate
from repro_torch.runtime import RuntimeConfig, TorchPayload, make_payload, run_live
from repro_torch.runtime.payloads import PAYLOADS, SleepPayload
from repro_torch.scenarios import run as cli
from repro_torch.scenarios.engine import summarize_result
from repro_torch.scenarios.registry import get_scenario

ROOT = Path(__file__).resolve().parents[1]
CPU = {"device": "cpu"}
RESULT_ARRAYS = ("times", "measured_cpu", "scheduled_cpu", "queue_len",
                 "active_workers", "target_workers", "ideal_bins",
                 "pe_count", "measured_res", "scheduled_res")


def assert_parity(ref_res, ref_dt, res, dt, *, util_tol=0.15, target_tol=2,
                  makespan_ratio=1.6):
    """``tests/test_backend_parity.py``'s bands: the port's live run
    against the reference's simulator."""
    s, l = ref_summarize(ref_res, ref_dt), summarize_result(res, dt)
    assert l["completed"] >= 0.9 * l["total"]
    assert s["completed"] >= 0.9 * s["total"]
    assert l["mean_scheduled_utilization_active"] == pytest.approx(
        s["mean_scheduled_utilization_active"], abs=util_tol)
    assert abs(l["max_target_workers"] - s["max_target_workers"]) <= target_tol
    assert abs(int(res.target_workers[-1])
               - int(ref_res.target_workers[-1])) <= target_tol
    assert s["makespan_s"] / makespan_ratio <= l["makespan_s"] \
        <= makespan_ratio * s["makespan_s"]


def _first_fit(scn):
    ic = scn.irm_config()
    ic.allocator.algorithm = "first-fit"
    return ic


def _smoke(get):
    scn = get("microscopy")
    cfg = scn.sim_config()
    cfg.t_max = scn.smoke_t_max
    return scn, cfg


# ---------------------------------------------------------------------------
# the payload
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [{}, dict(experts=3, rows=5, dim=7)])
def test_torch_payload_takes_the_jax_payload_draws(kwargs):
    jp = JaxPayload(**kwargs)
    tp = TorchPayload(**kwargs, device="cpu")
    assert tp._x.dtype == torch.float32 and tp._w.dtype == torch.float32
    np.testing.assert_array_equal(tp._x.numpy(), np.asarray(jp._x))
    np.testing.assert_array_equal(tp._w.numpy(), np.asarray(jp._w))
    np.testing.assert_array_equal(tp._sizes.numpy(), np.asarray(jp._sizes))


def test_torch_payload_from_numpy_reproduces_jax_output():
    jp = JaxPayload()
    tp = TorchPayload.from_numpy(np.asarray(jp._x), np.asarray(jp._w),
                                 np.asarray(jp._sizes), device="cpu")
    want = np.asarray(jax_gmm(jp._x, jp._w, jp._sizes, use_kernel=False))
    got = tp._compute().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert tp.device_ms == []  # device times are taken on the card only


def test_payloads_off_the_card_report_no_device_work():
    msg = SimpleNamespace(duration=0.0)
    for payload in (SleepPayload(), TorchPayload(device="cpu")):
        assert payload.run_sync(msg, 0.01) is None
        assert payload.kernel_launches() == 0


def test_make_payload_torch_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_payload("torch")


def test_payload_registry_is_the_ports_own():
    assert set(PAYLOADS) == {"sleep", "torch"}
    with pytest.raises(ValueError, match="unknown payload"):
        make_payload("jax")


# ---------------------------------------------------------------------------
# the live runtime with the torch payload (in-process)
# ---------------------------------------------------------------------------


@pytest.mark.timeout(120)
def test_live_torch_payload_runs_each_message():
    scn, cfg = _smoke(get_scenario)
    res = run_live(
        scn.make_stream(0, n_images=8, duration_range=(4.0, 8.0)), cfg,
        runtime=RuntimeConfig(time_scale=0.01, payload="torch",
                              payload_kwargs=CPU),
    )
    assert res.completed == res.total == 8
    for m in res.messages:
        assert m.done_t - m.start_t >= m.duration - 0.5


@pytest.mark.timeout(180)
def test_live_torch_payload_matches_reference_sim():
    ref_scn, ref_cfg = _smoke(ref_get_scenario)
    ref = ref_simulate(ref_scn.make_stream(0, **ref_scn.smoke_overrides),
                       ref_cfg, irm=RefIRM(_first_fit(ref_scn)))
    scn, cfg = _smoke(get_scenario)
    stats = {}
    res = run_live(
        scn.make_stream(0, **scn.smoke_overrides), cfg,
        irm=IRM(_first_fit(scn)),
        runtime=RuntimeConfig(time_scale=0.02, payload="torch",
                              payload_kwargs=CPU),
        stats=stats,
    )
    assert res.completed == res.total == 40
    assert stats["payload_device_ms"] == []
    assert_parity(ref, ref_cfg.dt, res, cfg.dt)
    assert summarize_result(res, cfg.dt)["low_index_load_fraction"] > 0.6


# ---------------------------------------------------------------------------
# the verbatim numpy copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ref_scenario_names())
def test_port_sim_is_identical_to_reference(name):
    """Same stream, same config, same IRM code: the same time series."""
    ref_scn, scn = ref_get_scenario(name), get_scenario(name)
    results = []
    for s, sim, irm_cls in ((ref_scn, ref_simulate, RefIRM),
                            (scn, simulate, IRM)):
        cfg = s.sim_config()
        cfg.t_max = s.smoke_t_max
        stream = s.make_stream(0, **(s.smoke_overrides or {}))
        results.append(sim(stream, cfg, irm=irm_cls(s.irm_config())))
    ref, res = results
    for field in RESULT_ARRAYS:
        a, b = getattr(ref, field), getattr(res, field)
        if a is None:
            assert b is None, field
        else:
            np.testing.assert_array_equal(b, a, err_msg=field)
    assert (res.completed, res.total, res.makespan, res.requeued) == (
        ref.completed, ref.total, ref.makespan, ref.requeued)


def test_cli_runs_a_smoke_scenario(capsys):
    assert cli.main(["microscopy", "--smoke"]) == 0
    assert "microscopy" in capsys.readouterr().out
    # the serving backend drains the scenario's stream
    assert cli.main(["microscopy", "--backend", "serving", "--smoke"]) == 0
    out = capsys.readouterr().out
    assert "backend serving" in out
    lines = dict(line.strip().split(": ", 1) for line in out.splitlines()
                 if line.strip().startswith(("completed:", "submitted:")))
    assert lines["completed"] == lines["submitted"] != "0"


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "repro")


def _absolute_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.lineno, node.args[0].value


def test_port_imports_nothing_of_jax_or_the_jax_package():
    port = ROOT / "src" / "repro_torch"
    files = sorted(port.rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    # every subpackage of the port is scanned, the serving slice's included
    scanned = {p.relative_to(port).parts[0] for p in files if port in p.parents}
    assert {"configs", "core", "kernels", "launch", "models", "obs", "runtime",
            "scenarios", "serving"} <= scanned
    assert port / "kernels" / "paged_attention" / "ops.py" in files
    for rel_path in ("models/moe.py", "core/spark_baseline.py",
                     "core/view_conformance.py", "scenarios/serving.py", "obs/__main__.py",
                     "models/scan_utils.py", "models/ssm.py", "models/xlstm.py",
                     "models/encdec.py"):
        assert port / rel_path in files, rel_path
    bad = [
        f"{p.relative_to(ROOT)}:{line} imports {mod}"
        for p in files
        for line, mod in _absolute_imports(p)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_target_at_last_dispatch_reads_the_tick_after_the_last_start():
    """``chip_smoke.py``'s full-stream check reads the worker target at the
    first control tick at or after the last message's start on a PE."""
    cs = _load(ROOT / "chip_smoke.py")

    def result(starts):
        return SimpleNamespace(
            times=np.arange(0.0, 10.0, 0.5), target_workers=np.arange(20) + 100,
            messages=[SimpleNamespace(start_t=s) for s in starts])

    assert cs._target_at_last_dispatch(result([0.2, 3.1, 2.0, -1.0])) == 107
    assert cs._target_at_last_dispatch(result([3.5, 1.0])) == 107  # on a tick
    assert cs._target_at_last_dispatch(result([12.0])) == 119       # past the end


def test_witness_tool_resolves_its_chip_smoke_names_and_planted_irms():
    """``tools/final_target_witness.py`` borrows ``chip_smoke``'s stream
    and check as ``cs.<name>``, and plants packers the port has."""
    from repro_torch.core.binpack import make_packer

    tool_path = ROOT / "tools" / "final_target_witness.py"
    tool = _load(tool_path)
    assert callable(tool.main) and callable(tool.one_run)
    names = {node.attr for node in ast.walk(ast.parse(tool_path.read_text()))
             if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
             and node.value.id == "cs"}
    assert {"_microscopy", "_target_at_last_dispatch", "TARGET_TOL"} <= names
    cs = _load(ROOT / "chip_smoke.py")
    assert not [n for n in sorted(names) if not hasattr(cs, n)]
    for kind in tool.PLANTED:
        if kind != "no-scale-down":
            make_packer(kind, capacity=1.0)

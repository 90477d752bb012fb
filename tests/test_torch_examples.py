"""The port's examples (``examples/torch_*.py``) on the CPU against the JAX
package's (``examples/*.py``), at tiny sizes.

  - ``torch_quickstart.py`` prints what ``quickstart.py`` prints (both run
    as subprocesses), up to the names of the next examples to run;
  - ``torch_serve_microscopy.py``: part 1's two engine summaries equal the
    JAX example's exactly, and so does its printout; part 2, on the JAX
    package's weights carried across with ``params_from_numpy`` (fp32), the
    prefill's greedy tokens are JAX's, and every decode step's logits are
    within 2e-5 of JAX's ``decode_step`` on its prefill cache zero-padded
    for the generated tokens, the serving tests' oracle.  The JAX example's
    own hand-off (its prefill cache, as long as the prompt) drops the new
    tokens' K/V already at the first step, which moves its logits by more
    than 0.05 (ROADMAP queue 3): the port does not copy that;
  - ``torch_fault_tolerance.py``: scenario 3 on ``sim`` gives the JAX
    example's requeued, completed and makespan, scenario 4 its attempts,
    scenario 1 one restart and final step 12 (what the JAX example prints),
    scenario 2 the saved weights back as DTensors on a (1, 1) mesh;
  - ``torch_train_stream.py`` at a tiny width: the restart, the final step,
    the pipeline and no kernel launch on the CPU;
  - the mirror of ``tests/test_system.py::test_end_to_end_stream_train``:
    olmo-1b at smoke size over the same pipeline and seed, 9 steps, each
    loss within 1e-4 relative of JAX's (``tests/test_torch_training.py``'s
    driver tolerance; both compute in fp32, where the JAX test's default is
    bf16);
  - every example that needs the card raises without one unless given
    ``--device cpu``.
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
LOGIT_TOL = dict(rtol=2e-5, atol=2e-5)
LOSS_RTOL = 1e-4


def load(name):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


def test_quickstart_prints_what_the_jax_example_prints():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")

    def stdout(name):
        res = subprocess.run([sys.executable, str(EXAMPLES / f"{name}.py")], env=env,
                             capture_output=True, text=True, timeout=120, cwd=ROOT)
        assert res.returncode == 0, res.stderr[-2000:]
        return res.stdout

    want = stdout("quickstart").replace("examples/", "examples/torch_")
    assert stdout("torch_quickstart") == want
    assert "Done. Next: examples/torch_train_stream.py" in want


# ---------------------------------------------------------------------------
# serve_microscopy
# ---------------------------------------------------------------------------


def _recording(engine_cls, into):
    class Recording(engine_cls):
        def summary(self):
            s = super().summary()
            into.append(s)
            return s

    return Recording


def test_serve_part1_summaries_equal_the_jax_examples(monkeypatch, capsys):
    jax_ex, port_ex = load("serve_microscopy"), load("torch_serve_microscopy")
    want = []
    monkeypatch.setattr(jax_ex, "ServingEngine", _recording(jax_ex.ServingEngine, want))
    jax_ex.part1_engine()
    want_out = capsys.readouterr().out
    got = port_ex.part1_engine()
    assert capsys.readouterr().out == want_out
    assert len(got) == len(want) == 2
    assert got == want


def test_serve_part2_follows_jax_on_its_weights():
    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro.models import init_params as jax_init_params

    cfg = jax_get_config("qwen3-8b").smoke()
    jm = jax_build_model(cfg)
    jp = jax_init_params(jm.param_specs(), jax.random.PRNGKey(0))
    got = load("torch_serve_microscopy").part2_real_model(
        "cpu", torch.float32, params=params_from_numpy(jax.tree.map(np.asarray, jp)))

    # the JAX example's inputs: 4 prompts of 12 tokens from the same rng
    rng = np.random.default_rng(1)
    B, L = 4, 12
    batch = {"tokens": jnp.asarray(rng.integers(1, cfg.vocab_size, size=(B, L)), jnp.int32),
             "segment_ids": jnp.ones((B, L), jnp.int32),
             "positions": jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32), (B, L))}
    logits, jcache = jm.prefill(jp, batch)
    np.testing.assert_allclose(got["prefill_logits"].numpy(), np.asarray(logits),
                               **LOGIT_TOL)
    toks = got["tokens"].numpy()
    np.testing.assert_array_equal(toks[:, 0], np.asarray(jnp.argmax(logits, axis=-1)))

    steps = len(got["step_logits"])
    pad = [(0, 0), (0, 0), (0, steps), (0, 0), (0, 0)]
    padded = {"blocks": jax.tree.map(lambda a: jnp.pad(a, pad), jcache["blocks"]),
              "len": jcache["len"]}
    for i, step in enumerate(got["step_logits"]):
        tok = {"tokens": jnp.asarray(toks[:, i:i + 1])}
        want, padded = jm.decode_step(jp, tok, padded)
        np.testing.assert_allclose(step.numpy(), np.asarray(want), **LOGIT_TOL)
        if i == 0:  # the JAX example's own hand-off loses the token's K/V
            dropped, _ = jm.decode_step(jp, tok, jcache)
            assert np.abs(np.asarray(dropped) - np.asarray(want)).max() > 0.05
    np.testing.assert_array_equal(toks[:, 1:], np.stack(
        [s.numpy().argmax(-1) for s in got["step_logits"]], axis=1))
    assert got["used_pages"] == got["watermark"] == B * (L + steps) // 4
    assert got["launches"] == {"packed_fwd": 0, "paged": 0}  # the CPU path


# ---------------------------------------------------------------------------
# fault_tolerance
# ---------------------------------------------------------------------------


def test_fault_tolerance_streaming_scenarios_match_the_jax_examples(monkeypatch, capsys):
    jax_ex, port_ex = load("fault_tolerance"), load("torch_fault_tolerance")
    results = []

    def recorded(*args, **kwargs):
        res = jax_simulate(*args, **kwargs)
        results.append(res)
        return res

    jax_simulate = jax_ex.simulate
    monkeypatch.setattr(jax_ex, "simulate", recorded)
    jax_ex.scenario_3_worker_failure(("sim",))
    jax_ex.scenario_4_ttl_requeue()
    want_out = capsys.readouterr().out
    (run,) = port_ex.scenario_3_worker_failure(("sim",))
    ttl = port_ex.scenario_4_ttl_requeue()
    assert capsys.readouterr().out == want_out
    (res,) = results
    assert (run["requeued"], run["completed"], run["total"], run["makespan"]) == (
        res.requeued, res.completed, res.total, res.makespan)
    assert run["requeued"] > 0 and run["completed"] == run["total"]
    assert ttl == {"attempts": [3, 2, 1], "dropped": 0}


def test_fault_tolerance_training_scenarios_on_the_cpu(tmp_path):
    port_ex = load("torch_fault_tolerance")
    summary = port_ex.scenario_1_crash_restart(str(tmp_path), "cpu")
    # the JAX example prints "restarts: 1, completed step 12 anyway"
    assert (summary["restarts"], summary["final_step"]) == (1, 12)
    assert summary["launches"] == {"packed_fwd": 0, "packed_bwd": 0}
    restored = port_ex.scenario_2_elastic_restore(str(tmp_path), "cpu")
    assert restored["mesh"] == {"data": 1, "model": 1} and restored["equal"]
    assert all(p.is_replicate() for p in restored["placements"])


# ---------------------------------------------------------------------------
# train_stream
# ---------------------------------------------------------------------------


def test_train_stream_restarts_and_finishes_on_the_cpu(tmp_path):
    ex = load("torch_train_stream")
    cfg = dataclasses.replace(ex.LM_100M, n_layers=2, d_model=64, n_heads=4,
                              n_kv_heads=4, d_ff=128, vocab_size=512)
    run = ex.train_stream(cfg, steps=12, seq_len=64, batch_size=2,
                          ckpt_dir=str(tmp_path), device="cpu", fail_at=8,
                          compute_dtype=torch.float32)
    assert (run["restarts"], run["final_step"]) == (1, 12)
    # no checkpoint is due before the failure (one every 50 steps), so the
    # controller goes on from step 8 with the weights it holds
    assert len(run["losses"]) == 12 and np.isfinite(run["losses"]).all()
    assert run["pipeline"]["rows_out"] > 0 and run["launches"] == {
        "packed_fwd": 0, "packed_bwd": 0}


@pytest.mark.parametrize("name,argv", [
    ("torch_train_stream", ["--steps", "1"]),
    ("torch_serve_microscopy", []),
    ("torch_fault_tolerance", []),
])
def test_examples_need_a_card_unless_told_cpu(name, argv):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    res = subprocess.run([sys.executable, str(EXAMPLES / f"{name}.py"), *argv],
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode != 0
    assert "no CUDA card: pass --device cpu" in res.stderr


# ---------------------------------------------------------------------------
# the pipeline wired end to end, mirrored from tests/test_system.py
# ---------------------------------------------------------------------------


def test_end_to_end_stream_train_matches_jax():
    from repro.configs import get_config as jax_get_config
    from repro.data import StreamingPipeline as JaxPipeline
    from repro.data import synthetic_documents as jax_documents
    from repro.models import build_model as jax_build_model
    from repro.models import init_params as jax_init_params
    from repro.training import OptimizerConfig as JaxOptimizerConfig
    from repro.training import init_opt_state as jax_init_opt_state
    from repro.training import make_train_step as jax_make_train_step
    from repro_torch.configs import get_config
    from repro_torch.data import StreamingPipeline, synthetic_documents
    from repro_torch.models import build_model
    from repro_torch.training import OptimizerConfig, init_opt_state, make_train_step

    keys = ("tokens", "labels", "segment_ids", "positions")
    jcfg = jax_get_config("olmo-1b").smoke()
    jm = jax_build_model(jcfg)
    jp = jax_init_params(jm.param_specs(), jax.random.PRNGKey(0))
    jopt = jax_init_opt_state(jp)
    jstep = jax.jit(jax_make_train_step(jm, JaxOptimizerConfig(learning_rate=1e-3),
                                        compute_dtype=jnp.float32))
    want = []
    pipe = JaxPipeline(jax_documents(jcfg.vocab_size, mean_len=80, max_len=256, seed=0,
                                     limit=200), seq_len=128, batch_size=2, prefetch=2)
    for i, pb in enumerate(pipe):
        jp, jopt, m = jstep(jp, jopt, {k: jnp.asarray(getattr(pb, k)) for k in keys})
        want.append(float(m["loss"]))
        if i >= 8:
            break

    cfg = get_config("olmo-1b").smoke()
    params = params_from_numpy(jax.tree.map(np.asarray, jax_init_params(
        jm.param_specs(), jax.random.PRNGKey(0))))
    opt = init_opt_state(params)
    step = make_train_step(build_model(cfg), OptimizerConfig(learning_rate=1e-3),
                           compute_dtype=torch.float32)
    got = []
    pipe = StreamingPipeline(synthetic_documents(cfg.vocab_size, mean_len=80, max_len=256,
                                                 seed=0, limit=200),
                             seq_len=128, batch_size=2, prefetch=2)
    for i, pb in enumerate(pipe):
        params, opt, m = step(params, opt, {k: torch.from_numpy(getattr(pb, k))
                                            for k in keys})
        got.append(float(m["loss"]))
        if i >= 8:
            break
    assert len(got) == len(want) == 9
    assert all(np.isfinite(got)) and int(opt["step"]) >= 8
    for a, b in zip(got, want, strict=True):
        assert rel(a, b) <= LOSS_RTOL

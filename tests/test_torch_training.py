"""The port's training path on the CPU against the JAX package's.

The JAX package's own parameters (``init_params(PRNGKey(0))``) are carried
into the port through numpy (``params_from_numpy``), so both packages train
the same weights on the same First-Fit packed batches, in f32, at
``olmo-1b.smoke()`` (MHA, non-parametric LayerNorm, tied embeddings) and
``qwen3-8b.smoke()`` (GQA, qk-RMSNorm).

Tolerances.  Loss and grad norm within 1e-5 relative: both packages compute
in f32 and differ only in summation order (the largest gap measured here is
a few 1e-7).  Gradients are compared through AdamW's first moment after one
step, m = (1 - b1) x clip x g, each leaf within 1e-4 of its largest
magnitude: the updated parameters are not compared, since AdamW's first
update is nearly sign(g) and turns float noise in a near-zero gradient into
a full step of lr.  Three steps of the training driver: losses within 1e-4
relative.  The data pipeline is numpy in both packages and is compared bit
for bit.
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.data import StreamingPipeline as JaxPipeline
from repro.data import synthetic_documents as jax_documents
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.training import OptimizerConfig as JaxOptimizerConfig
from repro.training import init_opt_state as jax_init_opt_state
from repro.training import lr_at as jax_lr_at
from repro.training import make_train_step as jax_make_train_step
from repro.training.optimizer import adamw_update as jax_adamw_update
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import StreamingPipeline, synthetic_documents
from repro_torch.distributed import GradCompressor
from repro_torch.launch import train
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.training import (
    OptimizerConfig,
    init_opt_state,
    lr_at,
    make_train_step,
)
from repro_torch.training.controller import TrainController, TrainControllerConfig
from repro_torch.training.optimizer import adamw_update

ARCHS = ["olmo-1b", "qwen3-8b"]
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(arch):
        if arch not in cache:
            jm = jax_build_model(jax_get_config(arch).smoke())
            jp = jax_init_params(jm.param_specs(), jax.random.PRNGKey(0))
            cfg = get_config(arch).smoke()
            cache[arch] = (cfg, jm, jp, build_model(cfg))
        return cache[arch]

    return get


def port_params(jp):
    return params_from_numpy(to_np(jp))


def packed_batches(vocab, seq_len, batch, n, seed=0):
    """The first ``n`` batches the port's pipeline packs, as numpy dicts."""
    pipe = StreamingPipeline(
        synthetic_documents(vocab, mean_len=seq_len // 3, max_len=4 * seq_len,
                            seed=seed),
        seq_len=seq_len, batch_size=batch, prefetch=0)
    out = []
    for pb in pipe:
        out.append({k: getattr(pb, k) for k in
                    ("tokens", "labels", "segment_ids", "positions")})
        if len(out) == n:
            return out
    raise AssertionError("the stream ended early")


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefetch", [0, 2])
def test_pipeline_matches_jax_bit_for_bit(prefetch):
    seq_len, B = 128, 4

    def first8(pipe_cls, docs):
        pipe = pipe_cls(docs(256, mean_len=seq_len // 3, max_len=4 * seq_len, seed=0),
                        seq_len=seq_len, batch_size=B, prefetch=prefetch)
        out = []
        for pb in pipe:
            out.append(pb)
            if len(out) == 8:
                break
        return out, pipe

    mine, pipe = first8(StreamingPipeline, synthetic_documents)
    theirs, jpipe = first8(JaxPipeline, jax_documents)
    assert len(mine) == len(theirs) == 8
    for a, b in zip(mine, theirs, strict=True):
        for k in ("tokens", "labels", "segment_ids", "positions"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
            assert getattr(a, k).dtype == getattr(b, k).dtype
    if prefetch == 0:
        assert pipe.stats() == jpipe.stats()
        assert pipe.scaling_events == jpipe.scaling_events
    # First-Fit rows hold several documents each
    assert np.mean([pb.segment_ids.max(axis=1).mean() for pb in mine]) > 1.5


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(built, arch):
    cfg, jm, jp, tm = built(arch)
    batch = packed_batches(cfg.vocab_size, 64, 2, 1)[0]
    assert batch["segment_ids"].max() > 1  # a packed row
    jl, jmet = jm.loss(jp, to_jax(batch), remat_policy=None)
    with torch.no_grad():
        tl, tmet = tm.loss(port_params(jp), to_torch(batch), remat_policy=None)
    assert rel(tl, jl) <= LOSS_RTOL
    for k in ("ce", "tokens", "moe_load_balance", "moe_z_loss"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= LOSS_RTOL * max(1.0, abs(float(jmet[k])))


def test_hidden_states_match_jax(built):
    cfg, jm, jp, tm = built("qwen3-8b")
    batch = packed_batches(cfg.vocab_size, 64, 2, 1, seed=3)[0]
    jh, _ = jm.hidden_states(jp, to_jax(batch), remat_policy=None)
    with torch.no_grad():
        th, _ = tm.hidden_states(port_params(jp), to_torch(batch), remat_policy=None)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-5, atol=2e-5)


def test_packed_vs_separate_loss_equivalence(built):
    """Two documents packed into one row give the same loss as two rows —
    the correctness contract of First-Fit packing + segment masking."""
    cfg, _, jp, tm = built("olmo-1b")
    params = port_params(jp)
    rng = np.random.default_rng(4)
    d1 = rng.integers(1, cfg.vocab_size, size=24).astype(np.int32)
    d2 = rng.integers(1, cfg.vocab_size, size=40).astype(np.int32)
    S = 64

    def row(docs):
        t = np.zeros(S, np.int32)
        lab = np.full(S, -1, np.int32)
        s = np.zeros(S, np.int32)
        p = np.zeros(S, np.int32)
        off = 0
        for seg_id, doc in enumerate(docs, start=1):
            n = len(doc)
            t[off:off + n] = doc
            lab[off:off + n - 1] = doc[1:]
            s[off:off + n] = seg_id
            p[off:off + n] = np.arange(n)
            off += n
        return t, lab, s, p

    def batch(rows):
        keys = ("tokens", "labels", "segment_ids", "positions")
        return {k: torch.from_numpy(np.stack([r[i] for r in rows]))
                for i, k in enumerate(keys)}

    with torch.no_grad():
        packed, _ = tm.loss(params, batch([row([d1, d2])]))
        separate, _ = tm.loss(params, batch([row([d1]), row([d2])]))
    assert float(packed) == pytest.approx(float(separate), rel=1e-5)


@pytest.mark.parametrize("arch,pos", [("jamba-v0.1-52b", 0), ("xlstm-125m", 0),
                                      ("xlstm-125m", 5)], ids=["M", "l", "s"])
def test_recurrent_block_through_apply_block_train_matches_jax(built, arch, pos):
    """A Mamba block (with its MLP), an mLSTM block and an sLSTM block
    through ``_apply_block_train``: output and the aux losses carried
    through, against the JAX package's."""
    cfg, jm, jp, tm = built(arch)
    char = cfg.pattern[pos]
    batch = packed_batches(cfg.vocab_size, 32, 2, 1, seed=6)[0]
    x = np.random.default_rng(9).normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    carried = {"moe_load_balance": 0.5, "moe_z_loss": 0.25, "moe_drop_fraction": 0.125}
    jblock = jax.tree.map(lambda t: t[0], jp["blocks"][str(pos)])
    want, jaux = jm._apply_block_train(
        char, jblock, jm.cfg, jnp.asarray(x), jnp.asarray(batch["segment_ids"]),
        jnp.asarray(batch["positions"]),
        {k: jnp.float32(v) for k, v in carried.items()})
    with torch.no_grad():
        got, aux = tm._apply_block_train(
            char, port_params(to_np(jblock)), torch.from_numpy(x),
            torch.from_numpy(batch["segment_ids"]), torch.from_numpy(batch["positions"]),
            {k: torch.tensor(v) for k, v in carried.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    for k in carried:
        assert rel(aux[k], jaux[k]) <= LOSS_RTOL, k
    assert ("ffn" in jblock) == (char == "M")


def test_moe_block_through_apply_block_train_matches_jax(built):
    """A qwen3-moe block (attention, then the MoE layer) through
    ``_apply_block_train``: its output and the aux losses it adds to the
    ones carried in, against the JAX package's."""
    cfg, jm, jp, tm = built("qwen3-moe-30b-a3b")
    batch = packed_batches(cfg.vocab_size, 32, 2, 1, seed=5)[0]
    x = np.random.default_rng(8).normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    carried = {"moe_load_balance": 0.5, "moe_z_loss": 0.25, "moe_drop_fraction": 0.125}
    jblock = jax.tree.map(lambda t: t[0], jp["blocks"]["0"])
    want, jaux = jm._apply_block_train(
        "A", jblock, jm.cfg, jnp.asarray(x), jnp.asarray(batch["segment_ids"]),
        jnp.asarray(batch["positions"]),
        {k: jnp.float32(v) for k, v in carried.items()})
    with torch.no_grad():
        got, aux = tm._apply_block_train(
            "A", port_params(to_np(jblock)), torch.from_numpy(x),
            torch.from_numpy(batch["segment_ids"]), torch.from_numpy(batch["positions"]),
            {k: torch.tensor(v) for k, v in carried.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    for k in carried:
        assert rel(aux[k], jaux[k]) <= LOSS_RTOL, k
    assert float(aux["moe_load_balance"]) > carried["moe_load_balance"]


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(0)
    shapes = {"a": (8, 16), "b": {"c": (16,), "d": (3, 4, 5)}}

    def draw(scale):
        return tree_map(lambda s: (rng.normal(size=s) * scale).astype(np.float32), shapes)

    params, grads, m, v = draw(1.0), draw(0.7), draw(0.05), draw(0.01)
    v = tree_map(np.abs, v)
    cfg = OptimizerConfig(learning_rate=1e-3, warmup_steps=10, decay_steps=100,
                          grad_clip_norm=1.0)
    jcfg = JaxOptimizerConfig(learning_rate=1e-3, warmup_steps=10, decay_steps=100,
                              grad_clip_norm=1.0)
    for step in (0, 4, 57):
        tstate = {"m": params_from_numpy(m), "v": params_from_numpy(v),
                  "step": torch.tensor(step, dtype=torch.int32)}
        jstate = {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
                  "step": jnp.asarray(step, jnp.int32)}
        tp, ts, tmet = adamw_update(params_from_numpy(params), params_from_numpy(grads),
                                    tstate, cfg)
        jp, js, jmet = jax_adamw_update(jax.tree.map(jnp.asarray, params),
                                        jax.tree.map(jnp.asarray, grads), jstate, jcfg)
        for a, b in zip(tree_leaves(tp) + tree_leaves(ts["m"]) + tree_leaves(ts["v"]),
                        jax.tree.leaves(jp) + jax.tree.leaves(js["m"])
                        + jax.tree.leaves(js["v"]), strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for k in ("grad_norm", "lr"):
            assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-6)


def test_lr_at_matches_jax():
    cfg = OptimizerConfig(learning_rate=1e-3, warmup_steps=10, decay_steps=100)
    jcfg = JaxOptimizerConfig(learning_rate=1e-3, warmup_steps=10, decay_steps=100)
    for step in (0, 1, 50, cfg.warmup_steps, cfg.decay_steps):
        a = float(lr_at(cfg, torch.tensor(step)))
        b = float(jax_lr_at(jcfg, jnp.asarray(step)))
        assert a == pytest.approx(b, rel=1e-6, abs=1e-12)


def test_lr_schedule_shape():
    cfg = OptimizerConfig(learning_rate=1e-3, warmup_steps=10, decay_steps=100,
                          min_lr_ratio=0.1)
    lrs = [float(lr_at(cfg, torch.tensor(s))) for s in range(0, 120, 5)]
    assert lrs[0] == 0.0
    assert max(lrs) == pytest.approx(1e-3, rel=1e-2)
    assert lrs[-1] == pytest.approx(1e-4, rel=5e-2)  # min_lr floor
    warm = [float(lr_at(cfg, torch.tensor(s))) for s in range(11)]
    assert all(b >= a for a, b in zip(warm, warm[1:], strict=False))


def test_grad_clipping_caps_update(built):
    _, _, jp, _ = built("olmo-1b")
    params = port_params(jp)
    grads = tree_map(lambda p: 100.0 * torch.ones_like(p), params)
    _, _, metrics = adamw_update(params, grads, init_opt_state(params),
                                 OptimizerConfig(grad_clip_norm=1.0))
    assert float(metrics["grad_norm"]) > 1.0  # the pre-clip norm is reported


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


STEP_CASES = [("nothing", 1), ("dots", 1), ("everything", 1), ("nothing", 2)]


@pytest.mark.parametrize("remat,micro", STEP_CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(built, arch, remat, micro):
    cfg, jm, jp, tm = built(arch)
    batch = packed_batches(cfg.vocab_size, 64, 2, 1, seed=1)[0]
    jstep = jax_make_train_step(jm, JaxOptimizerConfig(), remat_policy=remat,
                                microbatches=micro, compute_dtype=jnp.float32)
    _, jopt, jmet = jstep(jp, jax_init_opt_state(jp), to_jax(batch))
    params = port_params(jp)
    tstep = make_train_step(tm, OptimizerConfig(), remat_policy=remat,
                            microbatches=micro, compute_dtype=torch.float32)
    _, topt, tmet = tstep(params, init_opt_state(params), to_torch(batch))
    assert rel(tmet["loss"], jmet["loss"]) <= LOSS_RTOL
    assert rel(tmet["grad_norm"], jmet["grad_norm"]) <= LOSS_RTOL
    # first moment after one step: (1 - b1) x clip x g
    jm_leaves = jax.tree.leaves(jopt["m"])
    tm_leaves = tree_leaves(topt["m"])
    assert len(jm_leaves) == len(tm_leaves)
    for a, b in zip(tm_leaves, jm_leaves, strict=True):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= GRAD_REL * np.abs(b).max()


def test_train_step_bf16_compute_runs(built):
    """The default path (bf16 compute, gradients through the bf16 copy)
    keeps fp32 masters and moments and a finite loss."""
    cfg, _, jp, tm = built("qwen3-8b")
    params = port_params(jp)
    batch = to_torch(packed_batches(cfg.vocab_size, 64, 2, 1)[0])
    step = make_train_step(tm, OptimizerConfig())
    new, opt, met = step(params, init_opt_state(params), batch)
    assert torch.isfinite(met["loss"]) and torch.isfinite(met["grad_norm"])
    assert all(t.dtype == torch.float32 for t in tree_leaves(new))
    assert all(t.dtype == torch.float32 for t in tree_leaves(opt["m"]))


def test_loss_decreases_over_steps(built):
    cfg, _, jp, tm = built("olmo-1b")
    params = port_params(jp)
    step = make_train_step(tm, OptimizerConfig(learning_rate=3e-3, warmup_steps=2,
                                               decay_steps=50))
    opt = init_opt_state(params)
    fixed = to_torch(packed_batches(cfg.vocab_size, 64, 2, 1)[0])
    losses = []
    for _ in range(12):
        params, opt, m = step(params, opt, fixed)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9


def test_microbatching_matches_full_batch(built):
    """Gradient accumulation over 4 microbatches == the single-shot batch."""
    cfg, _, jp, tm = built("olmo-1b")
    params = port_params(jp)
    rng = np.random.default_rng(0)
    batch = {
        "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 64)).astype(np.int32)),
        "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 64)).astype(np.int32)),
        "segment_ids": torch.ones((8, 64), dtype=torch.int32),
        "positions": torch.arange(64, dtype=torch.int32).expand(8, 64),
    }
    step1 = make_train_step(tm, OptimizerConfig(), microbatches=1,
                            compute_dtype=torch.float32)
    step4 = make_train_step(tm, OptimizerConfig(), microbatches=4,
                            compute_dtype=torch.float32)
    p1, o1, m1 = step1(params, init_opt_state(params), batch)
    p4, o4, m4 = step4(params, init_opt_state(params), batch)
    # CE is a mean over tokens; the microbatches hold equal token counts
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    for a, b in zip(tree_leaves(o1["m"]), tree_leaves(o4["m"]), strict=True):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


def test_microbatch_indivisible_raises(built):
    cfg, _, jp, tm = built("olmo-1b")
    params = port_params(jp)
    batch = to_torch(packed_batches(cfg.vocab_size, 64, 2, 1)[0])
    step = make_train_step(tm, OptimizerConfig(), microbatches=3)
    with pytest.raises(ValueError):
        step(params, init_opt_state(params), batch)


def test_compressor_path_runs(built):
    """The compressor quantizes the gradients before AdamW and keeps its
    error feedback in ``opt_state["ef"]``, out of the AdamW core."""
    cfg, _, jp, tm = built("olmo-1b")
    params = port_params(jp)
    batch = to_torch(packed_batches(cfg.vocab_size, 64, 2, 1)[0])
    step = make_train_step(tm, OptimizerConfig(), compute_dtype=torch.float32,
                           compressor=GradCompressor(stochastic=False))
    plain = make_train_step(tm, OptimizerConfig(), compute_dtype=torch.float32)
    new, opt, met = step(params, init_opt_state(params), batch)
    _, opt0, met0 = plain(params, init_opt_state(params), batch)
    assert float(met["loss"]) == float(met0["loss"])  # compression acts after the loss
    assert set(opt) == {"m", "v", "step", "ef"} and set(opt0) == {"m", "v", "step"}
    # the error feedback is the compressor's on the step's gradients
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, _ = tm.loss(tree_unflatten(params, leaves), batch)
    grads = tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))
    _, ef = GradCompressor(stochastic=False).apply(grads, None)
    for a, b, g in zip(tree_leaves(opt["ef"]), tree_leaves(ef), tree_leaves(grads)):
        assert torch.equal(a, b)
        # half a step, and fp32's two roundings of it (chip_smoke QUANT_SLACK)
        assert float(a.abs().max()) <= float(g.abs().max()) / 127.0 * (0.5 + 127 * 2.0 ** -22)
    _, opt2, _ = step(new, opt, batch)  # the error feedback is carried
    assert not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(opt2["ef"]), tree_leaves(opt["ef"])))


# ---------------------------------------------------------------------------
# Checkpointing and the controller
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path, built):
    _, _, jp, _ = built("olmo-1b")
    params = port_params(jp)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(10, {"p": params})
    restored = mgr.restore(10, {"p": params})
    for a, b in zip(tree_leaves(params), tree_leaves(restored["p"]), strict=True):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_checkpoint_bf16_roundtrip(tmp_path):
    t = torch.randn(4, 8).to(torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": t})
    assert torch.equal(mgr.restore(1, {"w": t})["w"], t)


def test_checkpoint_gc_keeps_latest(tmp_path, built):
    _, _, jp, _ = built("olmo-1b")
    params = port_params(jp)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"p": params})
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_async_save(tmp_path, built):
    _, _, jp, _ = built("olmo-1b")
    params = port_params(jp)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(7, {"p": params})
    mgr.wait()
    assert mgr.latest_step() == 7
    assert mgr.last_save["step"] == 7 and mgr.last_save["write_s"] >= 0
    restored = mgr.restore(7, {"p": params})
    assert tree_map(lambda t: t.shape, restored) == tree_map(lambda t: t.shape, {"p": params})


def test_checkpoint_checksum_detects_corruption(tmp_path, built):
    _, _, jp, _ = built("olmo-1b")
    params = port_params(jp)
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(1, {"p": params})
    victim = next(f for f in sorted(os.listdir(path)) if f.endswith(".npy"))
    arr = np.load(os.path.join(path, victim))
    arr.ravel()[0] += 1.0
    np.save(os.path.join(path, victim), arr)
    with pytest.raises(IOError):
        mgr.restore(1, {"p": params})


def test_checkpoint_interop_with_jax(tmp_path, built):
    """A checkpoint written by either package restores in the other."""
    _, _, jp, _ = built("qwen3-8b")
    jopt = jax_init_opt_state(jp)
    jopt = {"m": jax.tree.map(lambda x: x + 0.5, jp), "v": jopt["v"],
            "step": jnp.asarray(3, jnp.int32)}
    JaxCheckpointManager(str(tmp_path / "jax")).save(3, {"p": jp, "o": jopt})
    target = {"p": port_params(jp), "o": init_opt_state(port_params(jp))}
    got = CheckpointManager(str(tmp_path / "jax")).restore(3, target)
    for a, b in zip(tree_leaves(got), jax.tree.leaves({"p": jp, "o": jopt}), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got["o"]["step"].dtype == torch.int32 and int(got["o"]["step"]) == 3

    CheckpointManager(str(tmp_path / "torch")).save(3, got)
    back = JaxCheckpointManager(str(tmp_path / "torch")).restore(3, {"p": jp, "o": jopt})
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves({"p": jp, "o": jopt}),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _tiny_batches(cfg, n):
    for b in packed_batches(cfg.vocab_size, 64, 2, n):
        yield to_torch(b)


def test_controller_restarts_after_injected_failure(tmp_path, built):
    cfg, _, jp, tm = built("olmo-1b")
    params = port_params(jp)
    step = make_train_step(tm, OptimizerConfig(learning_rate=1e-3))
    ctl = TrainController(step, TrainControllerConfig(
        checkpoint_dir=str(tmp_path), checkpoint_every=3, async_checkpoint=False))
    _, o, summary = ctl.run(params, init_opt_state(params), _tiny_batches(cfg, 30),
                            num_steps=10, fail_at=7)
    assert summary["restarts"] == 1
    assert summary["final_step"] == 10
    assert int(o["step"]) >= 9  # restarted from the step-6 checkpoint, refinished


def test_controller_cold_start_and_resume(tmp_path, built):
    cfg, _, jp, tm = built("olmo-1b")
    params = port_params(jp)
    step = make_train_step(tm, OptimizerConfig())
    cfg_ctl = TrainControllerConfig(checkpoint_dir=str(tmp_path), checkpoint_every=5,
                                    async_checkpoint=False)
    ctl = TrainController(step, cfg_ctl)
    p, _, _ = ctl.run(params, init_opt_state(params), _tiny_batches(cfg, 10),
                      num_steps=5)
    # a new controller (a fresh process) resumes from the checkpoint
    ctl2 = TrainController(step, cfg_ctl)
    p2, o2, start = ctl2.init_state(lambda: (params, init_opt_state(params)))
    assert start == 5 and int(o2["step"]) == 5
    assert torch.equal(tree_leaves(p)[0], tree_leaves(p2)[0])


# ---------------------------------------------------------------------------
# The slice as a whole: the training driver
# ---------------------------------------------------------------------------


def _train_args(tmp_path, *extra):
    return train.parse_args(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                             "--steps", "3", "--seq-len", "128", "--batch-size", "2",
                             "--ckpt-dir", str(tmp_path), *extra])


def test_launch_train_matches_jax_over_three_steps(tmp_path, built):
    """``launch.train.run`` from the JAX package's initial weights gives the
    losses of JAX ``make_train_step`` over the same three packed batches."""
    cfg, jm, jp, _ = built("olmo-1b")
    stats = train.run(_train_args(tmp_path), params=port_params(jp),
                      compute_dtype=torch.float32)
    jstep = jax.jit(jax_make_train_step(
        jm, JaxOptimizerConfig(decay_steps=100), compute_dtype=jnp.float32))
    p, o = jp, jax_init_opt_state(jp)
    want = []
    for b in packed_batches(cfg.vocab_size, 128, 2, 3):
        p, o, m = jstep(p, o, to_jax(b))
        want.append(float(m["loss"]))
    assert len(stats["losses"]) == 3
    for a, b in zip(stats["losses"], want, strict=True):
        assert rel(a, b) <= 1e-4
    assert stats["launches_fwd"] == stats["launches_bwd"] == 0  # the CPU path
    assert stats["final_step"] == 3 and stats["segments_per_row"] > 1
    assert 0 < stats["token_fill"] <= 1
    assert CheckpointManager(str(tmp_path)).latest_step() == 3


def test_launch_train_default_run_on_cpu(tmp_path):
    stats = train.run(_train_args(tmp_path))
    assert stats["device"] == "cpu" and stats["peak_device_mem_gib"] is None
    assert all(np.isfinite(stats["losses"])) and all(np.isfinite(stats["grad_norms"]))
    assert stats["checkpoint"]["step"] == 3 and stats["checkpoint"]["bytes"] > 0


def test_launch_train_needs_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = argparse.Namespace(**vars(_train_args(tmp_path)))
    args.device = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train.run(args)

"""The hybrid, recurrent, encoder-decoder and vision families on the CPU
against the JAX package: jamba-v0.1-52b (Mamba + attention, MoE),
xlstm-125m (mLSTM/sLSTM), seamless-m4t-medium (encoder-decoder) and
internvl2-1b (vision-embedding prefix), at ``cfg.smoke()``, B = 2, S = 64,
in f32.

The JAX package's own parameters (``init_params(PRNGKey(0))``) are carried
into the port through numpy (``params_from_numpy``), and both packages get
the same batch (``make_batch``, the same numpy draws).  These are
``tests/test_arch_smoke.py``'s three checks, held to JAX's numbers:

  - loss and metrics within ``LOSS_RTOL`` 1e-5 relative (measured: at most
    3.4e-7);
  - one train step's loss within 1e-5 and grad norm within ``FLOOR``;
  - prefill, then two decode steps, against JAX ``decode_step`` on the
    prefill's cache with its attention K/V zero-padded to hold the new
    tokens (JAX's own unpadded hand-off drops them; ROADMAP queue 3),
    within rtol 2e-5 (the f32 TOLS of ``tests/test_kernels.py``) and the
    atol of ``FLOOR``.

``FLOOR``: these random-weight models are far less well conditioned than
the dense decoders.  ``tools/jax_noise_floor.py`` moves every JAX weight by
2^-24 relative (one fp32 rounding) and reads how far JAX's own numbers
move: the grad norm by up to 3.1e-4 (jamba), 3.6e-4 (xlstm), 9.1e-5
(seamless) and 2.1e-5 (internvl2) relative, against 7.8e-8 for qwen3-8b;
the serving logits by up to 1.6e-4, 2.6e-5, 6.8e-5 and 6.0e-6 absolute,
against 9.5e-7.  The port sums in another order, so it cannot be held
below that floor: each limit is twice the floor rounded up to one digit,
or the 1e-5 / 2e-5 above where those clear it.  The port's gaps measured
here: grad norm 3.8e-4, 7.2e-5, under 1e-5 and 2.3e-5; logits 1.1e-4,
2.3e-5, 4.4e-5 and under 2e-5.

Teacher-forced decode is held to JAX's prefill of the whole prompt for the
recurrent families.  The recurrent mixers ignore segment ids in both
packages, so a right-padded prompt's state runs over its padding alike.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import run_local as jax_run_local
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.models import make_batch as jax_make_batch
from repro.models.layers import flash_attention as jax_flash
from repro.training import OptimizerConfig as JaxOptimizerConfig
from repro.training import init_opt_state as jax_init_opt_state
from repro.training import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.launch import serve
from repro_torch.models import EncDecLM, build_model, make_batch, params_from_numpy
from repro_torch.models.layers import flash_attention
from repro_torch.models.params import tree_leaves, tree_paths
from repro_torch.serving.kv_cache import PagedCacheLayout
from repro_torch.training import OptimizerConfig, init_opt_state, make_train_step

ARCHS = ["jamba-v0.1-52b", "xlstm-125m", "seamless-m4t-medium", "internvl2-1b"]
RECURRENT = ["jamba-v0.1-52b", "xlstm-125m"]
B, S = 2, 64
LOSS_RTOL = 1e-5
TOL = dict(rtol=2e-5, atol=2e-5)
# (grad norm rtol, logit atol) per architecture; see the module docstring
FLOOR = {"jamba-v0.1-52b": (7e-4, 4e-4), "xlstm-125m": (8e-4, 6e-5),
         "seamless-m4t-medium": (2e-4, 2e-4), "internvl2-1b": (5e-5, 2e-5)}


def logit_tol(arch):
    return dict(rtol=2e-5, atol=FLOOR[arch][1])


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(arch):
        if arch not in cache:
            jm = jax_build_model(jax_get_config(arch).smoke())
            jp = jax_init_params(jm.param_specs(), jax.random.PRNGKey(0))
            cfg = get_config(arch).smoke()
            cache[arch] = (cfg, jm, jp, build_model(cfg), params_from_numpy(to_np(jp)))
        return cache[arch]

    return get


def paged_cache(model, cfg, num_pages=64, page_size=4):
    layout = PagedCacheLayout(num_pages=num_pages, page_size=page_size,
                              n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_,
                              max_pages_per_seq=32)
    return model.init_paged_cache(layout, dtype=torch.float32)


def serve_batch(cfg, rng, lens, width):
    """Prompts of ``lens`` tokens right-padded to ``width``, with the
    family's stub frontend inputs (numpy)."""
    n = len(lens)
    tokens = np.zeros((n, width), np.int32)
    seg = np.zeros((n, width), np.int32)
    for b, m in enumerate(lens):
        tokens[b, :m] = rng.integers(1, cfg.vocab_size, size=m)
        seg[b, :m] = 1
    batch = {"tokens": tokens, "segment_ids": seg,
             "positions": np.broadcast_to(np.arange(width, dtype=np.int32),
                                          (n, width)).copy()}
    if cfg.encdec:
        enc_seg = np.ones((n, 24), np.int32)
        enc_seg[-1, 17:] = 0  # a shorter encoder input
        batch["enc_embeds"] = (rng.normal(size=(n, 24, cfg.d_model)) * 0.02).astype(
            np.float32)
        batch["enc_segment_ids"] = enc_seg
    if cfg.frontend == "vision":
        batch["vision_embeds"] = (rng.normal(size=(n, cfg.frontend_tokens, cfg.d_model))
                                  * 0.02).astype(np.float32)
    return batch


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def jax_padded_cache(jcache, extra):
    """JAX's prefill cache with every attention layer's K/V zero-padded by
    ``extra`` slots along the sequence (the recurrent states as they are)."""
    def pad(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = pad(v)
            elif k in ("k", "v"):  # (layers, B, S, KVH, D)
                out[k] = jnp.pad(v, [(0, 0), (0, 0), (0, extra), (0, 0), (0, 0)])
            else:
                out[k] = v
        return out

    return dict(jcache, blocks=pad(jcache["blocks"]))


# ---------------------------------------------------------------------------
# building
# ---------------------------------------------------------------------------


def test_build_model_picks_the_jax_class():
    for arch in ARCHS:
        model = build_model(get_config(arch))
        assert type(model).__name__ == type(jax_build_model(jax_get_config(arch))).__name__
    assert isinstance(build_model(get_config("seamless-m4t-medium")), EncDecLM)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_draws_the_jax_numbers(arch):
    cfg = get_config(arch).smoke()
    want = jax_make_batch(jax_get_config(arch).smoke(), "train", B, S, seed=1)
    got = make_batch(cfg, "train", B, S, seed=1)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == {"int32": torch.int32, "float32": torch.float32}[
            str(want[k].dtype)], k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_params_carry_the_recurrent_and_encdec_leaves(built):
    """``params_from_numpy`` carries the enc_blocks/dec_blocks trees and the
    recurrent leaves (A_log, D, dt_bias, the gate biases) unchanged."""
    for arch, paths in (("jamba-v0.1-52b", [("blocks", "0", "mixer", k)
                                            for k in ("A_log", "D", "dt_bias")]),
                        ("xlstm-125m", [("blocks", "0", "mixer", "bf"),
                                        ("blocks", "5", "mixer", "b")]),
                        ("seamless-m4t-medium", [("enc_blocks", "self_attn", "wq"),
                                                 ("dec_blocks", "cross_attn", "wo")])):
        _, _, jp, _, tp = built(arch)
        for path in paths:
            j, t = jp, tp
            for k in path:
                j, t = j[k], t[k]
            assert np.array_equal(t.numpy(), np.asarray(j)), (arch, path)
        assert {p: tuple(t.shape) for p, t in tree_paths(tp)} == {
            p: np.shape(a) for p, a in tree_paths(to_np(jp))}


# ---------------------------------------------------------------------------
# test_arch_smoke's three checks, held to JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_metrics_match_jax(arch, built):
    cfg, jm, jp, tm, tp = built(arch)
    jbatch = jax_make_batch(jm.cfg, "train", B, S, seed=1)
    want, wmet = jm.loss(jp, jbatch)
    with torch.no_grad():
        got, met = tm.loss(tp, make_batch(cfg, "train", B, S, seed=1))
    assert rel(got, want) <= LOSS_RTOL
    assert sorted(met) == sorted(wmet)
    for k in wmet:
        assert rel(met[k], wmet[k]) <= LOSS_RTOL or abs(float(wmet[k])) < 1e-12, k


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_jax(arch, built):
    cfg, jm, jp, tm, tp = built(arch)
    jstep = jax_make_train_step(jm, JaxOptimizerConfig(learning_rate=1e-3),
                                compute_dtype=jnp.float32)
    _, jopt, jmet = jstep(jp, jax_init_opt_state(jp),
                          jax_make_batch(jm.cfg, "train", B, S, seed=1))
    tstep = make_train_step(tm, OptimizerConfig(learning_rate=1e-3),
                            compute_dtype=torch.float32)
    new, topt, tmet = tstep(tp, init_opt_state(tp), make_batch(cfg, "train", B, S, seed=1))
    assert rel(tmet["loss"], jmet["loss"]) <= LOSS_RTOL
    assert rel(tmet["grad_norm"], jmet["grad_norm"]) <= FLOOR[arch][0]
    assert int(topt["step"]) == int(jopt["step"]) == 1
    assert all(torch.isfinite(t).all() for t in tree_leaves(new))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_on_a_padded_cache(arch, built):
    cfg, jm, jp, tm, tp = built(arch)
    rng = np.random.default_rng(2)
    lens, steps = [20, 13], 2
    batch = serve_batch(cfg, rng, lens, 20)
    want, jcache = jm.prefill(jp, to_jax(batch))
    jcache = jax_padded_cache(jcache, steps)
    got, cache = tm.prefill(tp, to_torch(batch), paged_cache(tm, cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **logit_tol(arch))
    before = paged_ops.launches
    for _ in range(steps):
        tok = rng.integers(1, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        want, jcache = jm.decode_step(jp, {"tokens": jnp.asarray(tok)}, jcache)
        got, cache = tm.decode_step(tp, {"tokens": torch.from_numpy(tok)}, cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **logit_tol(arch))
    assert cache["len"].tolist() == [n + steps for n in lens]
    assert paged_ops.launches == before  # the CPU takes the plain version


@pytest.mark.parametrize("arch", RECURRENT)
def test_teacher_forced_decode_matches_jax_prefill(arch, built):
    """The prompt's first 4 tokens through prefill and the other 10 through
    decode, against JAX's prefill of all 14.  (A prefill shorter than the
    conv window less one, 3 tokens, fails in both packages; at 4 tokens
    jamba's MoE bins hold every token both ways, where a 9-token prefill's
    8-row bins drop some.)"""
    cfg, jm, jp, tm, tp = built(arch)
    T, P = 14, 4
    batch = serve_batch(cfg, np.random.default_rng(3), [T], T)
    want, _ = jm.prefill(jp, to_jax(batch))
    _, cache = tm.prefill(tp, to_torch({k: v[:, :P] for k, v in batch.items()}),
                          paged_cache(tm, cfg))
    for t in range(P, T):
        got, cache = tm.decode_step(
            tp, {"tokens": torch.from_numpy(batch["tokens"][:, t:t + 1].copy())}, cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **logit_tol(arch))


def test_paged_cache_holds_pools_for_attention_layers_only(built):
    """jamba's pattern MMMMAMMM over two periods: 2 K/V pools, and a state
    for each of its 14 Mamba layers in layer order after prefill."""
    cfg, _, _, tm, tp = built("jamba-v0.1-52b")
    cache = paged_cache(tm, cfg)
    assert cache["k"].shape[0] == cache["v"].shape[0] == 2 and cache["state"] == []
    batch = serve_batch(cfg, np.random.default_rng(4), [6, 6], 6)
    _, cache = tm.prefill(tp, to_torch(batch), cache)
    assert len(cache["state"]) == 14
    assert all(set(st) == {"conv", "ssm"} for st in cache["state"])
    xl_cfg, _, _, xl, _ = built("xlstm-125m")
    assert paged_cache(xl, xl_cfg)["k"].shape[0] == 0


# ---------------------------------------------------------------------------
# the encoder-decoder and cross attention
# ---------------------------------------------------------------------------


def test_encode_matches_jax(built):
    cfg, jm, jp, tm, tp = built("seamless-m4t-medium")
    batch = serve_batch(cfg, np.random.default_rng(5), [8, 8], 8)
    want = jm.encode(jp, jnp.asarray(batch["enc_embeds"]),
                     jnp.asarray(batch["enc_segment_ids"]), remat_policy=None)
    with torch.no_grad():
        got = tm.encode(tp, torch.from_numpy(batch["enc_embeds"]),
                        torch.from_numpy(batch["enc_segment_ids"]), remat_policy=None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encdec_cross_pages_hold_the_encoder_length(built):
    cfg, _, _, tm, tp = built("seamless-m4t-medium")
    batch = serve_batch(cfg, np.random.default_rng(6), [5, 9], 9)
    _, cache = tm.prefill(tp, to_torch(batch), paged_cache(tm, cfg))
    assert cache["enc_len"].tolist() == [24, 17]
    assert [cache["cross_alloc"].seq_len(b) for b in range(2)] == [24, 17]
    assert [cache["alloc"].seq_len(b) for b in range(2)] == [5, 9]


@pytest.mark.parametrize("causal", [False, True])
def test_cpu_cross_attention_matches_jax(causal):
    """``flash_attention`` with Sq != Skv and separate segment ids, over KV
    chunks of 8."""
    rng = np.random.default_rng(7)
    Bq, Sq, Skv, H, KVH, D = 2, 12, 40, 4, 2, 16
    q = rng.normal(size=(Bq, Sq, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(Bq, Skv, KVH, D)).astype(np.float32) for _ in range(2))
    seg_q = np.ones((Bq, Sq), np.int32)
    seg_q[1, 10:] = 0
    seg_kv = np.ones((Bq, Skv), np.int32)
    seg_kv[0, 33:] = 0
    kw = dict(causal=causal, chunk_q=8, chunk_kv=8)
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v, seg_q, seg_kv)), **kw)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v, seg_q, seg_kv)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got[1, 10:] == 0).all()


# ---------------------------------------------------------------------------
# the vision prefix and the entry point
# ---------------------------------------------------------------------------


def test_vision_rows_longer_than_the_prompt_raise_as_in_jax(built):
    """internvl2's full-width run_local: 256 patch rows against a 16-token
    prompt.  The JAX package raises a ValueError there; so does the port."""
    cfg, jm, jp, tm, tp = built("internvl2-1b")
    batch = serve_batch(cfg, np.random.default_rng(8), [16], 16)
    batch["vision_embeds"] = np.zeros((1, 256, cfg.d_model), np.float32)
    with pytest.raises(ValueError):
        jm.prefill(jp, to_jax(batch))
    with pytest.raises(ValueError, match="256 vision embedding rows .* 16 tokens"):
        tm.prefill(tp, to_torch(batch), paged_cache(tm, cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_run_local_on_the_cpu_prints_the_jax_line(arch, capsys):
    argv = ["--backend", "local", "--smoke", "--arch", arch, "--requests", "3",
            "--gen-tokens", "4", "--pages", "32"]
    before = paged_ops.launches
    stats = serve.run_local(serve.parse_args(argv + ["--device", "cpu"]))
    got = capsys.readouterr().out
    ns = argparse.Namespace(backend="local", requests=3, replicas=5, slots=8, pages=32,
                            arch=arch, smoke=True, gen_tokens=4)
    jax_run_local(ns)
    want = capsys.readouterr().out
    head = "served 3 sequences x 4 tokens in "
    assert got.startswith(head) and want.startswith(head)
    assert got.rstrip().endswith("tok/s on cpu)") and want.rstrip().endswith("tok/s on cpu)")
    assert stats["tokens"].shape == (3, 5) and stats["logits_finite"]
    assert paged_ops.launches == before


def test_run_local_cuts_the_depth():
    stats = serve.run_local(serve.parse_args(
        ["--backend", "local", "--smoke", "--device", "cpu", "--arch", "jamba-v0.1-52b",
         "--n-layers", "8", "--requests", "2", "--gen-tokens", "2", "--pages", "8"]))
    assert stats["tokens"].shape == (2, 3) and stats["logits_finite"]


# ---------------------------------------------------------------------------
# three train steps, as each family trains on the card (chip_smoke phase 15)
# ---------------------------------------------------------------------------

# the losses of three driver steps, as test_torch_training.py holds them
STEPS_RTOL = 1e-4


def _pipeline_batches(vocab, seq_len, batch, n):
    """The first ``n`` batches ``launch.train.run``'s pipeline packs, as
    numpy dicts (the port's pipeline: bit for bit the JAX package's)."""
    from repro_torch.data import StreamingPipeline, synthetic_documents

    pipe = StreamingPipeline(synthetic_documents(vocab, mean_len=seq_len // 3,
                                                 max_len=4 * seq_len, seed=0),
                             seq_len=seq_len, batch_size=batch, prefetch=0)
    out = []
    for pb in pipe:
        out.append({k: getattr(pb, k) for k in ("tokens", "labels", "segment_ids",
                                                "positions")})
        if len(out) == n:
            return out
    raise AssertionError("the stream ended early")


@pytest.mark.parametrize("arch", RECURRENT)
def test_launch_train_matches_jax_over_three_steps(arch, built, tmp_path):
    """``launch.train.run`` (no mesh, f32) from the JAX package's initial
    weights gives the losses of JAX ``make_train_step`` over the same three
    packed batches, as the token families train on the card."""
    from repro_torch.launch import train

    cfg, jm, jp, _, _ = built(arch)
    stats = train.run(train.parse_args(
        ["--arch", arch, "--smoke", "--device", "cpu", "--mesh", "none", "--steps", "3",
         "--seq-len", "64", "--batch-size", "2", "--ckpt-dir", str(tmp_path)]),
        params=params_from_numpy(to_np(jp)), compute_dtype=torch.float32)
    jstep = jax.jit(jax_make_train_step(jm, JaxOptimizerConfig(decay_steps=100),
                                        compute_dtype=jnp.float32))
    p, o, want = jp, jax_init_opt_state(jp), []
    for b in _pipeline_batches(cfg.vocab_size, 64, 2, 3):
        p, o, m = jstep(p, o, to_jax(b))
        want.append(float(m["loss"]))
    assert stats["steps"] == 3 and stats["launches_fwd"] == stats["launches_bwd"] == 0
    for a, b in zip(stats["losses"], want, strict=True):
        assert rel(a, b) <= STEPS_RTOL


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-1b"])
def test_three_train_steps_on_make_batch_match_jax(arch, built):
    """``make_train_step`` (f32) over three ``make_batch`` batches, as the
    JAX package's tests train the encoder-decoder and the vision model:
    each step's loss within STEPS_RTOL of JAX's."""
    cfg, jm, jp, tm, tp = built(arch)
    jstep = jax.jit(jax_make_train_step(jm, JaxOptimizerConfig(), compute_dtype=jnp.float32))
    tstep = make_train_step(tm, OptimizerConfig(), compute_dtype=torch.float32)
    jstate, tstate = (jp, jax_init_opt_state(jp)), (tp, init_opt_state(tp))
    for seed in range(3):
        *jstate, jmet = jstep(*jstate, jax_make_batch(jm.cfg, "train", B, S, seed=seed))
        *tstate, tmet = tstep(*tstate, make_batch(cfg, "train", B, S, seed=seed))
        assert rel(tmet["loss"], jmet["loss"]) <= STEPS_RTOL, seed

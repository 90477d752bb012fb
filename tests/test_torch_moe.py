"""The port's MoE layer and MoE decoders on the CPU against the JAX package's.

The JAX package's own parameters (``init_params(PRNGKey(...))``) are carried
into the port through numpy (``params_from_numpy``), so both packages run
the same weights, in f32, at ``qwen3-moe-30b-a3b.smoke()`` (SwiGLU experts,
4 of them, top-2; GQA with qk-RMSNorm) and ``grok-1-314b.smoke()`` (gelu
experts).

Off the card both packages take the batched-product route with 8-aligned
bins, so they route the same tokens to the same bins and drop the same
overflow; a test with a small capacity factor makes tokens overflow.

Tolerances.  Outputs and logits: ``tests/test_kernels.py``'s f32 TOLS
(2e-5), on values of order 1; both packages compute in f32 and differ only
in summation order (the combine here sums each token's K contributions,
the JAX package scatter-adds them).  Losses and aux losses: 1e-5 relative,
as ``test_torch_training.py``.  Gradients: each leaf within 1e-4 of its
largest magnitude, as ``test_torch_training.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.grouped_matmul.ops import expert_ffn_swiglu as jax_expert_ffn_swiglu
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.models.moe import _top_k_iterative as jax_top_k
from repro.models.moe import expert_capacity as jax_expert_capacity
from repro.models.moe import moe_layer as jax_moe_layer
from repro.models.moe import moe_specs as jax_moe_specs
from repro_torch.configs import get_config
from repro_torch.kernels.grouped_matmul import ops
from repro_torch.launch import serve
from repro_torch.models import build_model, init_params, params_from_numpy
from repro_torch.models import params as params_mod
from repro_torch.models.moe import _top_k_iterative, expert_capacity, moe_layer
from repro_torch.models.params import Spec, tree_leaves
from repro_torch.serving.kv_cache import PagedCacheLayout

TOL = dict(rtol=2e-5, atol=2e-5)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
ARCHS = ["qwen3-moe-30b-a3b", "grok-1-314b"]
AUX = ("moe_load_balance", "moe_z_loss", "moe_drop_fraction")


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def with_capacity(cfg, factor):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


def layer_pair(arch, factor, seed=1):
    """(JAX cfg, port cfg, JAX params, port params) of one smoke MoE layer."""
    jcfg = with_capacity(jax_get_config(arch).smoke(), factor)
    cfg = with_capacity(get_config(arch).smoke(), factor)
    jp = jax_init_params(jax_moe_specs(jcfg), jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, params_from_numpy(to_np(jp))


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def test_expert_capacity_matches_jax_over_a_grid():
    for T in (1, 7, 8, 30, 60, 1024, 6512, 8192):
        for E, K in ((4, 1), (4, 2), (8, 2), (128, 8)):
            for factor in (0.5, 1.0, 1.25, 2.0):
                for align in (8, 128):
                    assert expert_capacity(T, E, K, factor, align) == \
                        jax_expert_capacity(T, E, K, factor, align), (T, E, K, factor, align)
    # qwen3-moe-30b-a3b on the card: a decode step of 8 sequences, a prefill
    # of 8 x 1024 tokens; and the decode step's bin off the card
    assert expert_capacity(8, 128, 8, 1.25) == 128
    assert expert_capacity(8 * 1024, 128, 8, 1.25) == 640
    assert expert_capacity(8, 128, 8, 1.25, align=8) == 8


def test_top_k_iterative_matches_jax_on_ties():
    probs = np.array([
        [0.25, 0.25, 0.25, 0.25],
        [0.1, 0.4, 0.4, 0.1],
        [0.3, 0.2, 0.3, 0.2],
        [0.0, 0.5, 0.0, 0.5],
        [0.7, 0.1, 0.1, 0.1],
    ], np.float32)
    rng = np.random.default_rng(0)
    probs = np.concatenate([probs, rng.integers(0, 3, size=(16, 4)).astype(np.float32) / 4])
    for k in (1, 2, 3, 4):
        vals, idx = _top_k_iterative(torch.from_numpy(probs), k)
        jvals, jidx = jax_top_k(jnp.asarray(probs), k)
        assert idx.dtype == torch.int32
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    # ties go to the lower expert, in descending order of value
    _, idx = _top_k_iterative(torch.from_numpy(probs[:4]), 2)
    assert idx.tolist() == [[0, 1], [1, 2], [0, 2], [1, 3]]


def test_expert_ffn_swiglu_plain_matches_the_pallas_kernel():
    """The port's CPU path (three plain grouped matmuls) against the JAX
    package's Pallas kernel in interpret mode, on ragged and empty bins."""
    rng = np.random.default_rng(2)
    E, C, d, f = 3, 128, 64, 128
    gs = np.array([128, 37, 0], np.int32)
    x = (rng.normal(size=(E, C, d)) * (np.arange(C)[None, :] < gs[:, None])[..., None]
         ).astype(np.float32)
    wg, wu = (rng.normal(size=(E, d, f)).astype(np.float32) * 0.1 for _ in range(2))
    wd = rng.normal(size=(E, f, d)).astype(np.float32) * 0.1
    want = jax_expert_ffn_swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd, gs)),
                                 use_kernel=True, interpret=True)
    before = ops.launches
    got = ops.expert_ffn_swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd, gs)))
    assert ops.launches == before  # the CPU takes the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got[1, 37:] == 0).all() and (got[2] == 0).all()


def test_jax_kernel_route_has_no_gradient():
    """The reference-side behaviour the port keeps: ``jax.grad`` through the
    JAX package's grouped matmul on its kernel route (``pallas_call``, here
    in interpret mode) raises ``NotImplementedError``, since ``pallas_call``
    has no transpose and ``ops.gmm`` no ``custom_vjp``.  So the JAX package
    trains no MoE layer on one TPU either (``moe.py`` takes the kernel route
    where G == 1), and the port's kernel route raises under autograd on the
    card (ROADMAP queue 1 item 12, not ported by design)."""
    from repro.kernels.grouped_matmul.ops import gmm as jax_gmm

    rng = np.random.default_rng(5)
    E, C, d, f = 2, 128, 64, 128
    x = jnp.asarray(rng.normal(size=(E, C, d)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(E, d, f)).astype(np.float32))
    gs = jnp.asarray(np.array([128, 40], np.int32))
    with pytest.raises(NotImplementedError):
        jax.grad(lambda w: jax_gmm(x, w, gs, use_kernel=True, interpret=True).sum())(w)
    # the reference route it trains through instead has one
    g = jax.grad(lambda w: jax_gmm(x, w, gs, use_kernel=False).sum())(w)
    assert np.isfinite(np.asarray(g)).all()


@pytest.mark.parametrize("factor", [1.25, 0.5], ids=["fits", "overflows"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_jax(arch, factor):
    jcfg, cfg, jp, tp = layer_pair(arch, factor)
    x = np.random.default_rng(3).normal(size=(3, 10, cfg.d_model)).astype(np.float32)
    x[2, 6:] = 0.0  # padding-like rows are routed and take capacity too
    want, jaux = jax_moe_layer(jp, jcfg, jnp.asarray(x))
    got, aux = moe_layer(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("moe_load_balance", "moe_z_loss"):
        assert rel(aux[k], jaux[k]) <= LOSS_RTOL, k
    assert float(aux["moe_drop_fraction"]) == float(jaux["moe_drop_fraction"])
    if factor < 1:  # 8-slot bins for 60 assignments over 4 experts
        assert float(aux["moe_drop_fraction"]) > 0.3
    else:
        assert float(aux["moe_drop_fraction"]) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_gradients_match_jax(arch):
    """Training off the card goes through the plain route: its gradients,
    through the dispatch, the dropped tokens and the aux losses, are the JAX
    package's."""
    jcfg, cfg, jp, tp = layer_pair(arch, 0.5)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)

    def jax_obj(p, xx):
        out, aux = jax_moe_layer(p, jcfg, xx)
        return jnp.sum(out * g) + aux["moe_load_balance"] + aux["moe_z_loss"]

    jgp, jgx = jax.grad(jax_obj, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: t.requires_grad_(True) for k, t in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe_layer(tp, cfg, xt)
    (torch.sum(out * torch.from_numpy(g)) + aux["moe_load_balance"]
     + aux["moe_z_loss"]).backward()
    for name, want in (*((k, jgp[k]) for k in sorted(tp)), ("x", jgx)):
        got = (tp[name] if name != "x" else xt).grad.numpy()
        want = np.asarray(want)
        assert np.abs(got - want).max() <= GRAD_REL * np.abs(want).max(), name


def test_moe_layer_repeats_bit_for_bit():
    _, cfg, _, tp = layer_pair("qwen3-moe-30b-a3b", 0.5)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4, 9, cfg.d_model)).astype(np.float32))
    a, aux_a = moe_layer(tp, cfg, x)
    b, aux_b = moe_layer(tp, cfg, x)
    assert torch.equal(a, b)
    assert all(torch.equal(aux_a[k], aux_b[k]) for k in AUX)


# ---------------------------------------------------------------------------
# the MoE decoders at smoke size
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = get_config(arch).smoke()
            jm = jax_build_model(jax_get_config(arch).smoke())
            jp = jax_init_params(jm.param_specs(), jax.random.PRNGKey(0))
            cache[arch] = (cfg, jm, jp, build_model(cfg), params_from_numpy(to_np(jp)))
        return cache[arch]

    return get


def ragged_batch(rng, vocab, lens, width):
    B = len(lens)
    tokens = np.zeros((B, width), np.int32)
    seg = np.zeros((B, width), np.int32)
    for b, n in enumerate(lens):
        tokens[b, :n] = rng.integers(1, vocab, size=n)
        seg[b, :n] = 1
    pos = np.broadcast_to(np.arange(width, dtype=np.int32), (B, width)).copy()
    return {"tokens": tokens, "segment_ids": seg, "positions": pos}


def paged_cache(model, cfg):
    layout = PagedCacheLayout(num_pages=64, page_size=4, n_kv_heads=cfg.n_kv_heads,
                              head_dim=cfg.head_dim_, max_pages_per_seq=16)
    return model.init_paged_cache(layout, dtype=torch.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_and_paged_decode_match_jax(arch, built):
    """Prefill of ragged prompts, then paged decode, against JAX ``prefill``
    and JAX ``decode_step`` on its prefill cache zero-padded for the new
    tokens (the oracle of ``test_torch_serving.py``)."""
    cfg, jm, jp, model, tp = built(arch)
    rng = np.random.default_rng(6)
    lens, steps = [20, 13, 7], 3
    batch = ragged_batch(rng, cfg.vocab_size, lens, 20)
    want, jcache = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    pad = [(0, 0), (0, 0), (0, steps), (0, 0), (0, 0)]
    jcache = {"blocks": jax.tree.map(lambda a: jnp.pad(a, pad), jcache["blocks"]),
              "len": jcache["len"]}
    before = ops.launches
    got, cache = model.prefill(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                               paged_cache(model, cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for _ in range(steps):
        tok = rng.integers(1, cfg.vocab_size, size=(3, 1)).astype(np.int32)
        want, jcache = jm.decode_step(jp, {"tokens": jnp.asarray(tok)}, jcache)
        got, cache = model.decode_step(tp, {"tokens": torch.from_numpy(tok)}, cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert cache["len"].tolist() == [n + steps for n in lens]
    assert ops.launches == before  # the CPU takes the plain version


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_loss_and_aux_match_jax(arch, built):
    cfg, jm, jp, model, tp = built(arch)
    batch = ragged_batch(np.random.default_rng(7), cfg.vocab_size, [24, 17], 24)
    batch["labels"] = np.where(batch["segment_ids"] > 0,
                               np.roll(batch["tokens"], -1, axis=1), -1).astype(np.int32)
    jl, jmet = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                       remat_policy=None)
    with torch.no_grad():
        tl, tmet = model.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                              remat_policy=None)
    assert rel(tl, jl) <= LOSS_RTOL
    for k in ("ce", "moe_load_balance", "moe_z_loss"):
        assert rel(tmet[k], jmet[k]) <= LOSS_RTOL, k
    assert float(tmet["moe_drop_fraction"]) == pytest.approx(
        float(jmet["moe_drop_fraction"]), abs=1e-7)
    assert float(tmet["moe_load_balance"]) > 0 and float(tmet["moe_z_loss"]) > 0


def test_run_local_serves_qwen3_moe_on_the_cpu(capsys):
    before = ops.launches
    stats = serve.run_local(serve.parse_args(
        ["--backend", "local", "--arch", "qwen3-moe-30b-a3b", "--smoke",
         "--device", "cpu", "--requests", "3", "--gen-tokens", "4", "--pages", "32"]))
    assert capsys.readouterr().out.startswith("served 3 sequences x 4 tokens in ")
    assert stats["tokens"].shape == (3, 5) and stats["logits_finite"]
    assert ops.launches == before


# ---------------------------------------------------------------------------
# the bounded-memory parameter draw
# ---------------------------------------------------------------------------


def test_sliced_draws_are_dtype_independent_and_bounded(monkeypatch):
    """Each leaf is drawn in fp32 slices of at most ``DRAW_SLICE_BYTES``:
    a bf16 request gets the fp32 draw cast, and the statistics hold."""
    monkeypatch.setattr(params_mod, "DRAW_SLICE_BYTES", 4 * 1000)
    drawn = []
    real_randn = torch.randn

    def randn(*args, **kwargs):
        out = real_randn(*args, **kwargs)
        drawn.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", randn)
    specs = {"w": Spec((6, 400, 7), ("experts", "embed", "mlp"), init="scaled"),
             "e": Spec((2000, 3), ("vocab", None), init="normal", scale=0.5),
             "z": Spec((5,), (None,), init="zeros")}
    f32 = init_params(specs, torch.Generator().manual_seed(0), torch.float32)
    bf16 = init_params(specs, torch.Generator().manual_seed(0), torch.bfloat16)
    assert max(drawn) == 1000 and len(drawn) == 2 * (17 + 6)
    for a, b in zip(tree_leaves(f32), tree_leaves(bf16)):
        assert b.dtype == torch.bfloat16
        assert torch.equal(b, a.to(torch.bfloat16))
    for t, std in ((f32["w"], 1 / 400 ** 0.5), (f32["e"], 0.5)):
        assert abs(t.mean().item()) < 3 * std / t.numel() ** 0.5
        assert t.std().item() == pytest.approx(std, rel=0.05)
    assert (f32["z"] == 0).all()
    # consecutive slices are consecutive draws, not one draw repeated
    w = f32["w"].flatten()
    assert not torch.equal(w[:1000], w[1000:2000])

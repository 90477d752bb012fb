"""float32 through the port's packed attention, and a sliding window through
its paged decode, on the CPU against the JAX package.

- The packed operators' CPU route in float32 (the Hopper kernels' float32
  arithmetic in plain PyTorch: no residual, delta from the output itself)
  against the JAX package's Pallas kernel in interpret mode and ``jax.grad``
  of its chunked flash path, at ``tests/test_kernels.py``'s f32 ``TOLS``
  (2e-5): both sides run fp32 and differ in summation order only.
- The windowed paged references (``paged_attention_ref`` and the kernel's
  split algorithm, ``paged_attention_split_ref``) against JAX's
  ``decode_attention`` with its window, at the same ``TOLS``.
- qwen3-8b ``.smoke()`` with ``sliding_window`` set: the port's prefill and
  paged decode (the plain paged path) against JAX's ``decode_step`` on its
  prefill's cache zero-padded for the new tokens, at 2e-5 (the JAX
  package's own weights carried across; see ``tests/test_torch_serving.py``).
- The operators' FLOP and byte counts in float32 and with a window, read on
  meta stand-ins as the dry-run reads them.

The Hopper kernels themselves run only on a card (``tests/test_torch_cuda.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jax_get_config
from repro.kernels.packed_attention.kernel import packed_flash_attention as jax_kernel
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.models.layers import decode_attention as jax_decode_attention
from repro.models.layers import flash_attention as jax_flash
from repro_torch.configs import get_config
from repro_torch.kernels.custom_ops import BYTES
from repro_torch.kernels.packed_attention import ops as packed_ops
from repro_torch.kernels.paged_attention import kernel as paged_kernel
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref,
    paged_attention_split_ref,
)
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serving.kv_cache import PagedCacheLayout

TOLS = dict(rtol=2e-5, atol=2e-5)  # tests/test_kernels.py's f32 TOLS
FWD = torch.ops.repro_torch.packed_attention_fwd
BWD = torch.ops.repro_torch.packed_attention_bwd
PAGED = torch.ops.repro_torch.paged_attention


def _segments(rng, B, S, max_segs=3):
    """Contiguous documents, then padding, as the First-Fit packer emits."""
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        n_real = int(S * (0.8 + 0.2 * rng.random()))
        cuts = np.sort(rng.choice(np.arange(1, n_real), size=max_segs - 1, replace=False))
        for i, (a, e) in enumerate(zip([0, *cuts], [*cuts, n_real])):
            seg[b, a:e] = i + 1
    return seg


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# float32 through the packed operators
# ---------------------------------------------------------------------------


# (B, S, H, KVH, D, causal, window): every head dim the kernels take, GQA,
# a window, non-causal
F32_CASES = [(2, 256, 4, 4, 64, True, 0), (2, 192, 4, 2, 16, True, 0),
             (1, 256, 4, 1, 32, True, 0), (2, 256, 2, 2, 128, True, 0),
             (1, 256, 2, 2, 32, True, 64), (2, 128, 4, 2, 64, False, 0)]


def _f32_inputs(case):
    B, S, H, KVH, D, causal, window = case
    rng = np.random.default_rng(B + S + H + KVH + D + window)
    q, k, v, g = (rng.normal(size=shape).astype(np.float32) for shape in (
        (B, S, H, D), (B, S, KVH, D), (B, S, KVH, D), (B, S, H, D)))
    seg = _segments(rng, B, S)
    seg[-1, S // 2:] = 0  # a padded tail
    return q, k, v, g, seg


@pytest.mark.parametrize("case", F32_CASES, ids=lambda c: "x".join(map(str, c)))
def test_f32_forward_writes_no_residual_and_matches_the_pallas_kernel(case):
    """The forward's CPU route in float32 with the residual asked for: the
    residual comes back empty (the kernel writes none) and the output is the
    Pallas kernel's (interpret mode, KV heads repeated for it)."""
    B, S, H, KVH, D, causal, window = case
    q, k, v, _, seg = _f32_inputs(case)
    st = torch.from_numpy(seg)
    out, lse, out_lo = FWD(_t(q), _t(k), _t(v), st, st, causal, window, True)
    assert out.dtype == torch.float32 and out_lo.numel() == 0
    assert lse.shape == (B, H, S) and bool(torch.isinf(lse[-1, :, S // 2:]).all())
    rep = H // KVH

    def heads_first(x, r=1):
        return jnp.asarray(np.repeat(x, r, axis=2).swapaxes(1, 2))

    want = jax_kernel(heads_first(q), heads_first(k, rep), heads_first(v, rep),
                      jnp.asarray(seg), jnp.asarray(seg), causal=causal, window=window,
                      block_q=64, block_kv=64, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want).swapaxes(1, 2), **TOLS)


@pytest.mark.parametrize("case", F32_CASES, ids=lambda c: "x".join(map(str, c)))
def test_f32_backward_takes_delta_from_the_output_and_matches_jax_grad(case):
    """The backward's CPU route in float32 from the forward's empty residual
    (delta = rowsum(dO * out)) against ``jax.grad`` of the JAX package's
    chunked flash path, the gradient its train step takes."""
    B, S, H, KVH, D, causal, window = case
    q, k, v, g, seg = _f32_inputs(case)
    st = torch.from_numpy(seg)
    out, lse, out_lo = FWD(_t(q), _t(k), _t(v), st, st, causal, window, True)
    grads = BWD(_t(q), _t(k), _t(v), st, st, out, out_lo, _t(g), lse, causal, window)

    def f(q_, k_, v_):
        o = jax_flash(q_, k_, v_, jnp.asarray(seg), jnp.asarray(seg), causal=causal,
                      window=window, chunk_q=64, chunk_kv=64)
        return jnp.sum(o * jnp.asarray(g))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    for name, got, w in zip(("dq", "dk", "dv"), grads, want, strict=True):
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), np.asarray(w), err_msg=name, **TOLS)
    pad = torch.from_numpy(seg == 0)
    assert all(bool((x[pad] == 0).all()) for x in grads)


def test_f32_autograd_path_matches_the_operators():
    """``ops.packed_attention`` on CPU float32 tensors (the plain version's
    autograd) and the operators' route agree, so the card's kernels, held to
    the former on the card, are held to the arithmetic tested above."""
    case = F32_CASES[1]
    B, S, H, KVH, D, causal, window = case
    q, k, v, g, seg = _f32_inputs(case)
    st = torch.from_numpy(seg)
    ts = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = packed_ops.packed_attention(*ts, st, st, causal=causal, window=window)
    out.backward(_t(g))
    o, lse, lo = FWD(_t(q), _t(k), _t(v), st, st, causal, window, True)
    grads = BWD(_t(q), _t(k), _t(v), st, st, o, lo, _t(g), lse, causal, window)
    torch.testing.assert_close(out.detach(), o, **TOLS)
    for a, b in zip((t.grad for t in ts), grads, strict=True):
        torch.testing.assert_close(a, b, **TOLS)


# ---------------------------------------------------------------------------
# the windowed paged references against JAX's decode_attention
# ---------------------------------------------------------------------------


def _paged_inputs(rng, B, H, KVH, D, lens, page_size, num_pages):
    max_pages = max(-(-n // page_size) for n in lens) + 1
    perm = rng.permutation(num_pages)
    table = np.full((B, max_pages), -1, np.int32)
    off = 0
    for b, n in enumerate(lens):
        m = -(-n // page_size)
        table[b, :m] = perm[off:off + m]
        off += m
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kp, vp = (rng.normal(size=(num_pages, page_size, KVH, D)).astype(np.float32)
              for _ in range(2))
    return q, kp, vp, table, np.asarray(lens, np.int32)


@pytest.mark.parametrize("window", [1, 5, 16, 17, 33, 200])
@pytest.mark.parametrize("H,KVH", [(8, 2), (4, 4)])
def test_windowed_paged_refs_match_jax_decode_attention(H, KVH, window):
    """Windows inside one page, of exactly a page, one past it, across
    several pages and longer than every sequence; lengths shorter than the
    window.  (A length of 0 gives 0, as the kernels and the Pallas kernel
    give it; JAX's dense ``decode_attention`` averages every slot there.)"""
    rng = np.random.default_rng(window + H)
    B, D, ps = 5, 32, 16
    lens = [37, 3, 100, 5, 64]
    q, kp, vp, table, lens = _paged_inputs(rng, B, H, KVH, D, lens, ps, 40)
    dense = [a[np.clip(table, 0, None)].reshape(B, -1, KVH, D) for a in (kp, vp)]
    want = np.asarray(jax_decode_attention(
        jnp.asarray(q[:, None]), jnp.asarray(dense[0]), jnp.asarray(dense[1]),
        jnp.asarray(lens), window=window))[:, 0]
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, lens)]
    np.testing.assert_allclose(paged_attention_ref(*args, window=window).numpy(), want,
                               **TOLS)
    np.testing.assert_allclose(paged_ops.paged_attention(*args, window=window).numpy(),
                               want, **TOLS)
    chunk, slots = paged_kernel.split_plan(4, D, ps, table.shape[1], B, KVH, window)
    for chunk_pages, n_slots in ((chunk, slots), (1, 3), (2, 2), (1, 8)):
        got = paged_attention_split_ref(*args, chunk_pages, n_slots, window=window)
        np.testing.assert_allclose(got.numpy(), want, err_msg=str((chunk_pages, n_slots)),
                                   **TOLS)
    args[4] = torch.tensor([37, 0, 100, 5, 64], dtype=torch.int32)
    assert not paged_attention_ref(*args, window=window)[1].any()  # length 0
    assert not paged_attention_split_ref(*args, 1, 3, window=window)[1].any()


@pytest.mark.parametrize("window,page_size,want", [(0, 16, 128), (256, 16, 17),
                                                   (1, 16, 1), (16, 16, 2), (17, 16, 2),
                                                   (18, 16, 3), (5000, 16, 128), (7, 4, 3)])
def test_the_split_plan_covers_the_window_pages_only(window, page_size, want):
    """``window_pages``: the table slots ``window`` tokens can touch, which
    start anywhere in a page, at most the table; the split plan's chunks
    cover that many pages."""
    assert paged_kernel.window_pages(page_size, 128, window) == want
    chunk, slots = paged_kernel.split_plan(2, 128, page_size, 128, 8, 8, window)
    assert slots <= -(-want // chunk)


# ---------------------------------------------------------------------------
# windowed decode of qwen3-8b at smoke size against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen_smoke():
    jm = jax_build_model(jax_get_config("qwen3-8b").smoke())
    jp = jax_init_params(jm.param_specs(), jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _ragged(rng, vocab, lens):
    B, width = len(lens), max(lens)
    batch = {"tokens": np.zeros((B, width), np.int32),
             "segment_ids": np.zeros((B, width), np.int32),
             "positions": np.broadcast_to(np.arange(width, dtype=np.int32), (B, width)).copy()}
    for b, n in enumerate(lens):
        batch["tokens"][b, :n] = rng.integers(1, vocab, size=n)
        batch["segment_ids"][b, :n] = 1
    return batch


@pytest.mark.parametrize("window", [7, 1])
def test_windowed_decode_matches_jax_on_a_padded_cache(qwen_smoke, window):
    """Prefill of ragged prompts (the packed path's window) and 8 decode
    steps (the paged path's window, over pages of 4 tokens, so the window
    starts inside a page and spans three) against JAX's prefill and
    ``decode_step`` on its cache zero-padded for the new tokens."""
    jp, tp = qwen_smoke
    jcfg = dataclasses.replace(jax_get_config("qwen3-8b").smoke(), sliding_window=window)
    cfg = dataclasses.replace(get_config("qwen3-8b").smoke(), sliding_window=window)
    jm, model = jax_build_model(jcfg), build_model(cfg)
    rng = np.random.default_rng(window)
    lens, steps = [20, 13, 6], 8
    batch = _ragged(rng, cfg.vocab_size, lens)
    want, jcache = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    pad = [(0, 0), (0, 0), (0, steps), (0, 0), (0, 0)]
    jcache = {"blocks": jax.tree.map(lambda a: jnp.pad(a, pad), jcache["blocks"]),
              "len": jcache["len"]}
    layout = PagedCacheLayout(num_pages=64, page_size=4, n_kv_heads=cfg.n_kv_heads,
                              head_dim=cfg.head_dim_, max_pages_per_seq=16)
    got, cache = model.prefill(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                               model.init_paged_cache(layout, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOLS)
    before = paged_ops.launches
    toks = []
    for _ in range(steps):
        tok = rng.integers(1, cfg.vocab_size, size=(3, 1)).astype(np.int32)
        toks.append(torch.from_numpy(tok))
        want, jcache = jm.decode_step(jp, {"tokens": jnp.asarray(tok)}, jcache)
        got, cache = model.decode_step(tp, {"tokens": toks[-1]}, cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOLS)
    assert cache["len"].tolist() == [n + steps for n in lens]
    assert paged_ops.launches == before  # the CPU takes the plain version
    # a witness that the window acts: the same steps without it read apart
    full = build_model(get_config("qwen3-8b").smoke())
    _, cache = full.prefill(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                            full.init_paged_cache(layout, dtype=torch.float32))
    for tok in toks:
        unwindowed, cache = full.decode_step(tp, {"tokens": tok}, cache)
    assert (unwindowed - got).abs().max().item() > 1e-3


def test_cross_attention_decode_takes_no_window():
    """An encoder-decoder's cross attention decode attends to every encoder
    position whatever the config's window, as in the JAX package; the self
    attention's decode takes the window."""
    from repro_torch.models import init_params
    from repro_torch.models.layers import (
        attention_decode,
        attention_specs,
        cross_attention_decode,
    )

    cfg = get_config("seamless-m4t-medium").smoke()
    windowed = dataclasses.replace(cfg, sliding_window=3)
    p = init_params(attention_specs(cfg), torch.Generator().manual_seed(0), torch.float32)
    rng = np.random.default_rng(3)
    B, ps, KVH, D = 2, 4, cfg.n_kv_heads, cfg.head_dim_
    x = _t(rng.normal(size=(B, 1, cfg.d_model)))
    pools = [_t(rng.normal(size=(8, ps, KVH, D))) for _ in range(2)]
    table = torch.tensor([[0, 1, 2, -1], [3, 4, 5, 6]], dtype=torch.int32)
    lens = torch.tensor([10, 13], dtype=torch.int32)
    a = cross_attention_decode(p, cfg, x, *pools, table, lens)
    b = cross_attention_decode(p, windowed, x, *pools, table, lens)
    assert torch.equal(a, b)
    pos = lens.long() - 1
    a = attention_decode(p, cfg, x, pos, *(t.clone() for t in pools), table, lens)
    b = attention_decode(p, windowed, x, pos, *(t.clone() for t in pools), table, lens)
    assert (a - b).abs().max().item() > 1e-4


# ---------------------------------------------------------------------------
# the operators' counts in float32 and with a window
# ---------------------------------------------------------------------------


def _count(op, *args):
    """(FLOPs, bytes) of one call of the operator ``op``, as the dry-run
    counts them."""
    with FlopCounterMode(display=False) as fc:
        out = op(*args)
    return fc.get_total_flops(), BYTES[op](*args, out)


@pytest.mark.parametrize("residual", [True, False])
def test_packed_operator_counts_four_byte_elements_and_no_residual_in_f32(residual):
    B, S, H, KVH, D = 2, 512, 8, 2, 64
    meta = dict(device="meta")
    q = torch.empty((B, S, H, D), **meta)
    k = torch.empty((B, S, KVH, D), **meta)
    seg = torch.empty((B, S), dtype=torch.int32, **meta)
    flops, moved = _count(FWD, q, k, k, seg, seg, True, 0, residual)
    pairs = B * S * (S + 1) // 2
    assert flops == 4 * D * H * pairs
    q_el, kv_el = B * S * H * D, B * S * KVH * D
    lse_b, seg_b = B * H * S * 4, 2 * B * S * 4
    assert moved == (2 * q_el + 2 * kv_el) * 4 + lse_b + seg_b  # q, k, v, out; no out_lo
    out, lse, lo = FWD(q, k, k, seg, seg, True, 0, residual)
    assert lo.numel() == 0 and out.dtype == torch.float32
    flops, moved = _count(BWD, q, k, k, seg, seg, out, lo, q, lse, True, 0)
    assert flops == 10 * D * H * pairs
    assert moved == (4 * q_el + 4 * kv_el) * 4 + lse_b + seg_b  # q k v out dout dq dk dv
    # bf16 keeps its residual and 2-byte elements
    qb, kb = q.to(torch.bfloat16), k.to(torch.bfloat16)
    _, moved_b = _count(FWD, qb, kb, kb, seg, seg, True, 0, residual)
    assert moved_b == ((3 if residual else 2) * q_el + 2 * kv_el) * 2 + lse_b + seg_b


@pytest.mark.parametrize("window", [0, 100, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_operator_counts_the_window_tokens(window, dtype):
    """A sequence's work is min(table tokens, window) tokens: 4 H D FLOPs
    and a K and a V row each."""
    B, H, KVH, D, ps, maxp = 8, 32, 8, 128, 16, 128
    meta = dict(device="meta")
    q = torch.empty((B, H, D), dtype=dtype, **meta)
    pool = torch.empty((1024, ps, KVH, D), dtype=dtype, **meta)
    table = torch.empty((B, maxp), dtype=torch.int32, **meta)
    lens = torch.empty((B,), dtype=torch.int32, **meta)
    flops, moved = _count(PAGED, q, pool, pool, table, lens, window)
    tokens = min(maxp * ps, window) if window else maxp * ps
    item = torch.empty((), dtype=dtype).element_size()
    assert flops == 4 * B * tokens * H * D
    assert moved == (2 * B * tokens * KVH * D + 2 * B * H * D) * item + B * maxp * 4 + B * 4

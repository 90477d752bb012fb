"""The port's packed attention on the CPU against the JAX package's.

The port's plain version (``ref.packed_attention_ref`` and the model-layout
``ops.packed_attention`` on CPU tensors) is held to the JAX package's
``packed_attention_ref`` and to its Pallas kernel in interpret mode, on the
grid of ``tests/test_kernels.py`` with its tolerances (``TOLS``: 2e-5 in
f32, 2e-2 in bf16).  Its gradient, which the Hopper backward kernel is held
to on the card, is held to ``jax.grad`` of the JAX package's chunked flash
path, the gradient the JAX train step takes, as is the operators' CPU
route, the kernels' arithmetic in plain PyTorch (``ref.packed_attention_bwd_ref``:
delta from the bf16 output and its rounding residual).  Inputs are made
with numpy from a seed and handed to both packages.

The Hopper kernels themselves run only on a card (``tests/test_torch_cuda.py``);
their rule for which tiles they skip and which they compute unmasked,
``ref.tile_schedule``, is held here to the dense mask (the card test holds
the kernels' own count of their tiles to it).  ``tools/packed_attention_ab.py``,
which times the kernels of two checkouts on a card, is checked here to
resolve the ``chip_smoke`` helpers it borrows.
"""

import ast
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.packed_attention.kernel import packed_flash_attention as jax_kernel
from repro.kernels.packed_attention.ops import packed_attention as jax_packed
from repro.kernels.packed_attention.ref import packed_attention_ref as jax_ref
from repro.models.layers import flash_attention as jax_flash
from repro_torch.kernels.packed_attention import kernel, ops
from repro_torch.kernels.packed_attention.ref import (
    FULL,
    packed_attention_bwd_ref,
    packed_attention_ref,
    tile_counts,
    tile_schedule,
    tile_shares,
    visible_mask,
)
from repro_torch.models.layers import flash_attention

TOLS = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# the gradients: each within 2e-4 of its largest magnitude (f32; the two
# packages sum the products of the backward in different orders)
GRAD_REL = 2e-4


def random_packed_segments(rng, B, S, max_segs=4, pad_frac=0.2):
    """Segment ids like the First-Fit packer emits: contiguous, 0-padded
    (``tests/test_kernels.py``'s generator)."""
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        n_real = int(S * (1 - pad_frac * rng.random()))
        cuts = np.sort(rng.choice(np.arange(1, n_real), size=min(max_segs - 1,
                       n_real - 1), replace=False)) if n_real > 1 else []
        bounds = [0, *cuts, n_real]
        for i in range(len(bounds) - 1):
            seg[b, bounds[i]:bounds[i + 1]] = i + 1
    return seg


def qkv(rng, B, S, H, KVH, D):
    return (rng.normal(size=(B, S, H, D)), rng.normal(size=(B, S, KVH, D)),
            rng.normal(size=(B, S, KVH, D)))


def jx(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, np.float32), getattr(jnp, dtype))


def tt(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def heads_first(x):
    return np.ascontiguousarray(np.swapaxes(x, 1, 2))


@pytest.mark.parametrize("S,block", [(256, 128), (512, 256), (384, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_jax_kernel_and_ref(S, block, dtype):
    rng = np.random.default_rng(0)
    B, H, D = 2, 4, 64
    q, k, v = (heads_first(x) for x in qkv(rng, B, S, H, H, D))
    seg = random_packed_segments(rng, B, S)
    out = packed_attention_ref(tt(q, dtype), tt(k, dtype), tt(v, dtype),
                               tt(seg).int(), tt(seg).int())
    assert out.dtype == getattr(torch, dtype)
    jargs = (jx(q, dtype), jx(k, dtype), jx(v, dtype), jnp.asarray(seg), jnp.asarray(seg))
    want_kernel = jax_kernel(*jargs, causal=True, block_q=block, block_kv=block,
                             interpret=True)
    want_ref = jax_ref(*jargs, causal=True)
    np.testing.assert_allclose(f32(out), f32(want_kernel), **TOLS[dtype])
    np.testing.assert_allclose(f32(out), f32(want_ref), **TOLS[dtype])


@pytest.mark.parametrize("KVH", [1, 2, 4])
def test_gqa_wrapper_matches_jax(KVH):
    rng = np.random.default_rng(1)
    B, S, H, D = 1, 256, 4, 32
    q, k, v = qkv(rng, B, S, H, KVH, D)
    seg = random_packed_segments(rng, B, S)
    out = ops.packed_attention(tt(q), tt(k), tt(v), torch.from_numpy(seg),
                               torch.from_numpy(seg))
    want = jax_packed(jx(q), jx(k), jx(v), jnp.asarray(seg), jnp.asarray(seg),
                      interpret=True)
    np.testing.assert_allclose(f32(out), f32(want), **TOLS["float32"])


def test_sliding_window_matches_jax():
    rng = np.random.default_rng(2)
    B, S, H, D = 1, 256, 2, 32
    q, k, v = (heads_first(x) for x in qkv(rng, B, S, H, H, D))
    seg = np.ones((B, S), np.int32)
    out = packed_attention_ref(tt(q), tt(k), tt(v), torch.from_numpy(seg),
                               torch.from_numpy(seg), window=64)
    want = jax_kernel(jx(q), jx(k), jx(v), jnp.asarray(seg), jnp.asarray(seg),
                      causal=True, window=64, block_q=128, block_kv=128,
                      interpret=True)
    np.testing.assert_allclose(f32(out), f32(want), **TOLS["float32"])


def test_fully_padded_rows_are_zero():
    rng = np.random.default_rng(3)
    B, S, H, D = 2, 256, 2, 32
    q, k, v = qkv(rng, B, S, H, H, D)
    seg = np.zeros((B, S), np.int32)
    seg[0] = 1  # row 1 fully padded
    out = ops.packed_attention(tt(q), tt(k), tt(v), torch.from_numpy(seg),
                               torch.from_numpy(seg))
    assert torch.isfinite(out).all()
    assert (out[1] == 0).all()


def test_no_attention_across_segments():
    """Segment 1's output does not depend on segment 2's keys and values."""
    rng = np.random.default_rng(4)
    B, S, H, D = 1, 256, 2, 32
    q, k, v = qkv(rng, B, S, H, H, D)
    seg = torch.from_numpy(np.concatenate(
        [np.ones(128, np.int32), np.full(128, 2, np.int32)])[None])
    out1 = ops.packed_attention(tt(q), tt(k), tt(v), seg, seg)
    k2, v2 = k.copy(), v.copy()
    k2[:, 128:] = rng.normal(size=(1, 128, H, D))
    v2[:, 128:] = rng.normal(size=(1, 128, H, D))
    out2 = ops.packed_attention(tt(q), tt(k2), tt(v2), seg, seg)
    torch.testing.assert_close(out1[:, :128], out2[:, :128], rtol=0, atol=0)


def test_model_layout_wrapper_matches_jax_wrapper():
    """(B, S, H, D) with separate KV heads, a ragged length the JAX wrapper
    pads to a block multiple and the port does not."""
    rng = np.random.default_rng(5)
    B, S, H, KVH, D = 2, 200, 4, 2, 32
    q, k, v = qkv(rng, B, S, H, KVH, D)
    seg = random_packed_segments(rng, B, S)
    out = ops.packed_attention(tt(q), tt(k), tt(v), torch.from_numpy(seg),
                               torch.from_numpy(seg))
    assert out.shape == (B, S, H, D)
    for use_kernel in (True, False):
        want = jax_packed(jx(q), jx(k), jx(v), jnp.asarray(seg), jnp.asarray(seg),
                          use_kernel=use_kernel, interpret=True)
        np.testing.assert_allclose(f32(out), f32(want), **TOLS["float32"])


def test_model_flash_path_matches_the_wrapper():
    """The port's two plain versions, the chunked flash path the model runs
    on the CPU and the dense one the kernels are held to, agree."""
    rng = np.random.default_rng(6)
    B, S, H, KVH, D = 2, 256, 4, 2, 32
    q, k, v = qkv(rng, B, S, H, KVH, D)
    seg = torch.from_numpy(random_packed_segments(rng, B, S))
    a = flash_attention(tt(q), tt(k), tt(v), seg, seg, chunk_q=128, chunk_kv=128)
    b = ops.packed_attention(tt(q), tt(k), tt(v), seg, seg)
    torch.testing.assert_close(a, b, rtol=3e-5, atol=3e-5)


# ---------------------------------------------------------------------------
# The gradient: autograd of the plain version against jax.grad of the JAX
# package's flash path
# ---------------------------------------------------------------------------


GRAD_CASES = [
    # (B, S, H, KVH, D, window)
    (2, 256, 4, 2, 32, 0),
    (2, 192, 4, 1, 16, 0),
    (1, 256, 2, 2, 32, 64),
]


def _grad_inputs(case, seed):
    B, S, H, KVH, D, window = case
    rng = np.random.default_rng(seed)
    q, k, v = qkv(rng, B, S, H, KVH, D)
    seg = random_packed_segments(rng, B, S)
    seg[-1] = 0  # a fully padded row
    g = rng.normal(size=(B, S, H, D))
    return q, k, v, seg, g, window


def _jax_grads(q, k, v, seg, g, window):
    def f(q_, k_, v_):
        out = jax_flash(q_, k_, v_, jnp.asarray(seg), jnp.asarray(seg),
                        causal=True, window=window, chunk_q=64, chunk_kv=64)
        return jnp.sum(out * jnp.asarray(g, jnp.float32))

    return jax.grad(f, argnums=(0, 1, 2))(jx(q), jx(k), jx(v))


@pytest.mark.parametrize("plain", ["ops", "flash", "operator"])
@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_gradient_matches_jax_grad_of_flash(case, plain):
    """``operator``: the CPU route of ``repro_torch::packed_attention_fwd``
    (with the residual) and ``_bwd``, the kernels' arithmetic."""
    q, k, v, seg, g, window = _grad_inputs(case, seed=sum(case))
    ts = [tt(x).requires_grad_(True) for x in (q, k, v)]
    st = torch.from_numpy(seg)
    if plain == "operator":
        out, lse, out_lo = torch.ops.repro_torch.packed_attention_fwd(
            *(t.detach() for t in ts), st, st, True, window, True)
        grads = torch.ops.repro_torch.packed_attention_bwd(
            *(t.detach() for t in ts), st, st, out, out_lo, tt(g), lse, True, window)
    else:
        if plain == "ops":
            out = ops.packed_attention(*ts, st, st, window=window)
        else:
            out = flash_attention(*ts, st, st, window=window, chunk_q=64, chunk_kv=64)
        out.backward(tt(g))
        grads = [t.grad for t in ts]
    want = _jax_grads(q, k, v, seg, g, window)
    for name, got, w in zip(("dq", "dk", "dv"), grads, want, strict=True):
        w = f32(w)
        err = np.abs(f32(got) - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (name, err, np.abs(w).max())
    # the padded row gets no gradient, and neither do keys of segment 0
    pad = seg == 0
    for got in grads:
        assert (got[torch.from_numpy(pad)] == 0).all()


# Cross attention like seamless-m4t-medium's decoder over its encoder (Sq !=
# Skv, two documents a side) with keys that hold nearly all their energy in
# one mean per document (ratio ~64 to the noise: share >= 0.999), bf16
# inputs.  A row of dS sums to delta_exact - delta_used, so dQ carries
# scale x that x the keys' mean: the kernels' arithmetic holds to jax.grad
# (delta from its fp32 output) with the forward's rounding residual, and
# reads far from it with delta from the bf16 output alone.
MEAN_HEAVY = {"B": 2, "Sq": 96, "Skv": 160, "H": 4, "D": 64, "ratio": 64.0}
MEAN_HEAVY_REL = 1e-3     # relative l2 of dQ, dK, dV with the residual
MEAN_HEAVY_FAULT = 5e-2   # dQ must read above this with out_lo = 0


def _mean_heavy_inputs(KVH, seed):
    B, Sq, Skv, H, D = (MEAN_HEAVY[n] for n in ("B", "Sq", "Skv", "H", "D"))
    rng = np.random.default_rng(seed)
    seg_q, seg_kv = np.ones((B, Sq), np.int32), np.ones((B, Skv), np.int32)
    for b in range(B):
        seg_q[b, Sq * (b + 1) // (B + 2) + 10:] = 2
        seg_kv[b, Skv * (b + 1) // (B + 2) + 20:] = 2
    q, k, v = (rng.normal(size=shape) for shape in ((B, Sq, H, D), (B, Skv, KVH, D),
                                                     (B, Skv, KVH, D)))
    for b in range(B):
        for sid in (1, 2):
            k[b, seg_kv[b] == sid] += MEAN_HEAVY["ratio"] * rng.normal(size=(1, KVH, D))
    g = rng.normal(size=(B, Sq, H, D))
    # every input rounded to bf16 once: both packages take these values
    return [f32(tt(x, "bfloat16")) for x in (q, k, v, g)], seg_q, seg_kv


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("KVH", [1, 4])
def test_bwd_ref_takes_delta_from_the_unrounded_output(KVH, causal):
    (q, k, v, g), seg_q, seg_kv = _mean_heavy_inputs(KVH, seed=11 + KVH + int(causal))
    kf = k.astype(np.float64)
    centred = kf.copy()
    for b in range(kf.shape[0]):
        for sid in (1, 2):
            m = seg_kv[b] == sid
            centred[b, m] -= kf[b, m].mean(axis=0)
    assert 1.0 - (np.linalg.norm(centred) / np.linalg.norm(kf)) ** 2 >= 0.999

    def f(q_, k_, v_):
        out = jax_flash(q_, k_, v_, jnp.asarray(seg_q), jnp.asarray(seg_kv), causal=causal,
                        chunk_q=64, chunk_kv=64)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(f, argnums=(0, 1, 2))(jx(q), jx(k), jx(v))
    qb, kb, vb, gb = (tt(x, "bfloat16") for x in (q, k, v, g))
    sq, skv = torch.from_numpy(seg_q), torch.from_numpy(seg_kv)
    out, lse, out_lo = torch.ops.repro_torch.packed_attention_fwd(qb, kb, vb, sq, skv, causal,
                                                                  0, True)
    assert out_lo.abs().max() > 0
    readings = {}
    for name, lo in (("residual", out_lo), ("bf16 output", torch.zeros_like(out_lo))):
        got = packed_attention_bwd_ref(qb, kb, vb, sq, skv, out, lo, gb, lse, causal=causal)
        readings[name] = [float(_rel_l2(f32(a), w)) for a, w in zip(got, want, strict=True)]
    assert max(readings["residual"]) <= MEAN_HEAVY_REL, readings
    # the fault the residual repairs, pinned: delta from the bf16 output
    assert readings["bf16 output"][0] > MEAN_HEAVY_FAULT, readings


# ---------------------------------------------------------------------------
# The CPU path and the kernel wrappers
# ---------------------------------------------------------------------------


def test_cpu_path_launches_nothing():
    rng = np.random.default_rng(7)
    q, k, v = qkv(rng, 1, 64, 2, 2, 16)
    seg = torch.ones((1, 64), dtype=torch.int32)
    before = (ops.launches_fwd, ops.launches_bwd)
    ts = [tt(x).requires_grad_(True) for x in (q, k, v)]
    ops.packed_attention(*ts, seg, seg).sum().backward()
    assert (ops.launches_fwd, ops.launches_bwd) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros((1, 64, 2, 16))
    seg = torch.ones((1, 64), dtype=torch.int32)
    lse = torch.zeros((1, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.packed_flash_attention(q, q, q, seg, seg)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.packed_flash_attention(q, q, q, seg, seg, residual=True)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.packed_flash_attention_bwd(q, q, q, seg, seg, q, q, q, lse)


def test_kernel_source_is_built_for_sm90a():
    from repro_torch.kernels.nvcc import NVCC_FLAGS

    assert "arch=compute_90a,code=sm_90a" in NVCC_FLAGS
    src = kernel.SOURCE.read_text()
    for entry in ("packed_attn_fwd", "packed_attn_bwd", "packed_attn_error_string",
                  "packed_attn_tile_census"):
        assert f'extern "C"' in src and entry in src


# ---------------------------------------------------------------------------
# The kernels' tile schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bq,bk", [(128, 128), (64, 128), (128, 64)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 192), (False, 0),
                                           (False, 100)])
def test_tile_schedule_covers_the_mask(bq, bk, causal, window):
    """``tile_schedule`` (the rule the kernels apply) against the dense mask
    of ``packed_attention_ref``: every visible pair lies in a kept tile, and
    every pair of a full tile is visible (the kernels apply no mask there)."""
    rng = np.random.default_rng(bq + bk + window + int(causal))
    n_full = 0
    for S, max_segs in ((1000, 5), (512, 3), (300, 4), (700, 1)):
        seg = random_packed_segments(rng, 3, S, max_segs=max_segs)
        seg[0, :] = 1  # one document filling a row: mostly full tiles
        seg = torch.tensor(seg)
        mask = visible_mask(seg, seg, causal=causal, window=window)
        covered = torch.zeros_like(mask)
        schedule = tile_schedule(seg, seg, bq, bk, causal=causal, window=window)
        for b, row in enumerate(schedule):
            assert len(row) == -(-S // bq)
            for qt, kept in enumerate(row):
                qs = slice(qt * bq, (qt + 1) * bq)
                for kt, cls in kept:
                    ks = slice(kt * bk, (kt + 1) * bk)
                    covered[b, qs, ks] = True
                    if cls == FULL:
                        n_full += 1
                        tile = mask[b, qs, ks]
                        assert tile.shape == (bq, bk) and tile.all(), (b, qt, kt)
        assert not (mask & ~covered).any()
    if window == 0:  # a window narrower than two tiles leaves no tile full
        assert n_full > 0


@pytest.mark.parametrize("bq,bk", [(128, 128), (64, 128), (128, 64)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 192), (False, 0),
                                           (False, 100)])
def test_tile_counts_split_the_tiles_in_range(bq, bk, causal, window):
    """``tile_counts`` (what the kernels' tile census is held to on the
    card): skipped, masked and full add up to the tile pairs in the causal
    and window range, which are those holding a visible pair when the row
    is one document; and one document skips nothing."""
    rng = np.random.default_rng(7 * bq + bk + window + int(causal))
    for S in (1000, 300, 640):
        seg = torch.tensor(random_packed_segments(rng, 3, S))
        one = torch.ones_like(seg)
        in_range = visible_mask(one, one, causal=causal, window=window)
        pad = (-S % bq, -S % bk)
        tiles = torch.nn.functional.pad(in_range, (0, pad[1], 0, pad[0])).reshape(
            3, -(-S // bq), bq, -(-S // bk), bk).any(dim=(2, 4))
        counts = tile_counts(seg, seg, bq, bk, causal=causal, window=window)
        assert sum(counts.values()) == int(tiles.sum())
        assert tile_counts(one, one, bq, bk, causal=causal, window=window)["skipped"] == 0
        kept = sum(len(k) for row in tile_schedule(seg, seg, bq, bk, causal=causal,
                                                   window=window) for k in row)
        assert counts["full"] + counts["masked"] == kept
        shares = tile_shares(counts)
        assert shares["tiles"] == int(tiles.sum())
        assert abs(shares["skipped"] + shares["full"] + shares["masked"] - 1.0) < 1e-12


ROOT = Path(__file__).resolve().parents[1]


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_ab_tool_resolves_the_chip_smoke_names_it_uses():
    """``tools/packed_attention_ab.py`` borrows ``chip_smoke``'s phase-7
    shapes and helpers as ``cs.<name>``: each must exist there."""
    tool_path = ROOT / "tools" / "packed_attention_ab.py"
    tool = _load(tool_path)
    assert callable(tool.main) and callable(tool.child) and callable(tool.train_child)
    names = {node.attr for node in ast.walk(ast.parse(tool_path.read_text()))
             if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
             and node.value.id == "cs"}
    assert {"_time_ms", "_packed_bound", "train_phase", "TRAIN"} <= names
    chip_smoke = _load(ROOT / "chip_smoke.py")
    assert not [n for n in sorted(names) if not hasattr(chip_smoke, n)]


def test_delta_rounding_probe_orders_the_choices_of_delta():
    """``tools/delta_rounding_probe.py``, the fp64 model behind what the
    forward's residual carries: at a small cross attention whose keys hold
    most of their energy in one mean per document, delta from the bf16
    output parts dQ from the exact gradient far more than delta from the
    fp32 output does, and the fp32 output with P's rounded weights
    renormalised (the kernels' choice) less than that."""
    probe = _load(ROOT / "tools" / "delta_rounding_probe.py")
    got = probe.probe(B=1, Sq=64, Skv=256, H=2, D=32, seed=0)
    r = got["dq_rel_l2"]
    assert got["key_mean_energy_share"] > 0.9
    assert r["exact"] < r["renormalised"] < r["fp32 output"] < r["bf16 output"] / 5, r

"""The float32 packed kernels' arithmetic on the tensor cores, modelled on
the CPU: 3xTF32 (``ref.packed_attention_tf32`` and
``ref.packed_attention_bwd_tf32``).

- The rounding to TF32 (``ref.tf32_round``, as ``cvt.rna.tf32.f32`` rounds:
  to nearest with ties away from zero, 10 explicit mantissa bits) against a
  definition from the value itself, on chosen bit patterns (ties, negatives,
  values just under a power of two, subnormals, the largest finite value,
  infinities) and on random patterns.
- The 3-pass model (every product as lo.hi + hi.lo + hi.hi on split
  operands, summed in fp32) against the JAX package's Pallas kernel in
  interpret mode and ``jax.grad`` of its chunked flash path, at
  ``tests/test_kernels.py``'s f32 ``TOLS`` (2e-5), at
  ``tests/test_torch_fp32_window.py``'s ``F32_CASES`` (every head dim, GQA,
  a window, non-causal).
- The witness: the 1-pass model (plain TF32, hi.hi only) misses that
  tolerance in the output and in each gradient, so the tolerance tells the
  kernels' design from plain TF32.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 7b, which plants the 1-pass model as a fault).
"""

import functools
import math
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.packed_attention.kernel import packed_flash_attention as jax_kernel
from repro.models.layers import flash_attention as jax_flash
from repro_torch.kernels.packed_attention.ref import (
    packed_attention_bwd_tf32,
    packed_attention_tf32,
    tf32_round,
    tf32_split,
)
from test_torch_fp32_window import F32_CASES, TOLS, _f32_inputs


def _tf32_from_value(bits: int) -> int:
    """The float32 pattern ``bits`` rounded to TF32 from its value: to the
    nearest multiple of the TF32 spacing at its scale (11 significant bits;
    2^-136 for subnormals, whose fp32 spacing is 2^-149), ties away from
    zero, past the largest TF32 value to infinity; non-finite patterns and
    zeros kept."""
    x = struct.unpack("<f", struct.pack("<I", bits))[0]
    if not math.isfinite(x) or x == 0.0:
        return bits
    _, exp = math.frexp(abs(x))  # |x| = m 2^exp, m in [0.5, 1)
    spacing = 2.0 ** max(exp - 11, -136)
    r = math.floor(abs(x) / spacing + 0.5) * spacing
    if r >= 2.0 ** 128:
        return (bits & 0x80000000) | 0x7F800000
    return struct.unpack("<I", struct.pack("<f", math.copysign(r, x)))[0]


def _round_bits(bits):
    t = torch.tensor(np.asarray(bits, np.uint32).view(np.int32)).view(torch.float32)
    return tf32_round(t).view(torch.int32).numpy().view(np.uint32)


# (pattern, its TF32 rounding): 13 bits are dropped, so 0x1000 is half
CHOSEN = {
    "one": (0x3F800000, 0x3F800000),
    "tie up from even": (0x3F801000, 0x3F802000),    # nearest-even would keep 0x3F800000
    "tie at odd": (0x3F803000, 0x3F804000),
    "under a tie": (0x3F800FFF, 0x3F800000),
    "over a tie": (0x3F801001, 0x3F802000),
    "negative tie": (0xBF801000, 0xBF802000),
    "negative under a tie": (0xBF800FFF, 0xBF800000),
    "just under one": (0x3F7FFFFF, 0x3F800000),      # carries into the exponent
    "tie just under two": (0x3FFFF000, 0x40000000),
    "under two, kept": (0x3FFFEFFF, 0x3FFFE000),
    "negative just under a power": (0xC07FFFFF, 0xC0800000),
    "smallest subnormal": (0x00000001, 0x00000000),
    "subnormal tie": (0x00001000, 0x00002000),
    "subnormal under a tie": (0x00000FFF, 0x00000000),
    "largest subnormal": (0x007FFFFF, 0x00800000),   # rounds to the smallest normal
    "negative subnormal tie": (0x80001000, 0x80002000),
    "largest finite": (0x7F7FFFFF, 0x7F800000),      # past the largest TF32
    "largest TF32": (0x7F7FE000, 0x7F7FE000),
    "zero": (0x00000000, 0x00000000),
    "negative zero": (0x80000000, 0x80000000),
    "infinity": (0x7F800000, 0x7F800000),
    "negative infinity": (0xFF800000, 0xFF800000),
}


@pytest.mark.parametrize("name", sorted(CHOSEN))
def test_tf32_round_on_chosen_patterns(name):
    bits, want = CHOSEN[name]
    assert _tf32_from_value(bits) == want, "the value-side definition"
    got = int(_round_bits([bits])[0])
    assert got == want, f"{name}: {bits:#010x} -> {got:#010x}, want {want:#010x}"


def test_tf32_round_keeps_nan():
    got = _round_bits([0x7FC00000, 0xFFC00001])
    assert np.isnan(got.view(np.float32)).all()


def test_tf32_round_on_random_patterns():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, size=20000, dtype=np.uint64).astype(np.uint32)
    bits = bits[(bits & 0x7F800000) != 0x7F800000]  # finite
    got = _round_bits(bits)
    want = np.array([_tf32_from_value(int(b)) for b in bits], np.uint32)
    np.testing.assert_array_equal(got, want)
    assert not (got & 0x1FFF).any(), "the low 13 bits are zero"


def test_tf32_split_parts():
    """hi and lo are each TF32; x - hi is exact in fp32 and within half a
    TF32 step of x; lo is within half a TF32 step of x - hi, so hi + lo is
    within 2^-22 of |x|."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=4096) * 10.0 ** rng.uniform(-20, 20, size=4096),
                     dtype=torch.float32)
    hi, lo = tf32_split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    xd, hid, lod = (t.double() for t in (x, hi, lo))
    assert torch.equal((x - hi).double(), xd - hid), "the remainder is exact"
    assert bool(((xd - hid).abs() <= xd.abs() * 2.0 ** -11).all())
    assert bool(((xd - hid - lod).abs() <= xd.abs() * 2.0 ** -22).all())


@functools.lru_cache(maxsize=None)
def _jax_reference(case):
    """JAX's output (the Pallas kernel in interpret mode, KV heads repeated
    for it) and (dq, dk, dv) (jax.grad of the chunked flash path)."""
    B, S, H, KVH, D, causal, window = case
    q, k, v, g, seg = _f32_inputs(case)
    rep = H // KVH

    def heads_first(x, r=1):
        return jnp.asarray(np.repeat(x, r, axis=2).swapaxes(1, 2))

    out = jax_kernel(heads_first(q), heads_first(k, rep), heads_first(v, rep),
                     jnp.asarray(seg), jnp.asarray(seg), causal=causal, window=window,
                     block_q=64, block_kv=64, interpret=True)

    def f(q_, k_, v_):
        o = jax_flash(q_, k_, v_, jnp.asarray(seg), jnp.asarray(seg), causal=causal,
                      window=window, chunk_q=64, chunk_kv=64)
        return jnp.sum(o * jnp.asarray(g))

    grads = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out).swapaxes(1, 2), tuple(np.asarray(x) for x in grads)


def _model(case, passes):
    """The model's output and (dq, dk, dv), the backward from the model's own
    forward (out, lse), as the kernels chain them."""
    B, S, H, KVH, D, causal, window = case
    q, k, v, g, seg = _f32_inputs(case)
    t = [torch.from_numpy(np.asarray(a, np.float32)) for a in (q, k, v, g)]
    st = torch.from_numpy(seg)
    out, lse = packed_attention_tf32(*t[:3], st, st, causal=causal, window=window,
                                     passes=passes)
    grads = packed_attention_bwd_tf32(*t[:3], st, st, out, t[3], lse, causal=causal,
                                      window=window, passes=passes)
    return out.numpy(), tuple(x.numpy() for x in grads)


def _misses(got, want):
    return not np.allclose(got, want, **TOLS)


@pytest.mark.parametrize("case", F32_CASES, ids=lambda c: "x".join(map(str, c)))
def test_three_pass_forward_matches_the_pallas_kernel(case):
    want, _ = _jax_reference(case)
    got, _ = _model(case, passes=3)
    np.testing.assert_allclose(got, want, **TOLS)


@pytest.mark.parametrize("case", F32_CASES, ids=lambda c: "x".join(map(str, c)))
def test_three_pass_backward_matches_jax_grad(case):
    _, want = _jax_reference(case)
    _, got = _model(case, passes=3)
    for name, a, b in zip(("dq", "dk", "dv"), got, want, strict=True):
        np.testing.assert_allclose(a, b, err_msg=name, **TOLS)


@pytest.mark.parametrize("case", F32_CASES, ids=lambda c: "x".join(map(str, c)))
def test_one_pass_tf32_misses_the_tolerance(case):
    """The witness: plain TF32 parts the output and every gradient from JAX
    by more than TOLS."""
    want_out, want_grads = _jax_reference(case)
    out, grads = _model(case, passes=1)
    assert _misses(out, want_out), "out"
    for name, a, b in zip(("dq", "dk", "dv"), grads, want_grads, strict=True):
        assert _misses(a, b), name


def test_passes_other_than_one_or_three_raise():
    x = torch.zeros((1, 8, 1, 16))
    seg = torch.ones((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        packed_attention_tf32(x, x, x, seg, seg, passes=2)

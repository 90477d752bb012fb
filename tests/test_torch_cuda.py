"""The port's Hopper kernels against their plain versions, on a CUDA card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch; there, skip ``conftest.py`` (it imports
JAX):

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Without a card each test skips: a CUDA kernel has no CPU mode.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels.grouped_matmul import kernel as gmm_kernel
from repro_torch.kernels.grouped_matmul import ops
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref, tile_census
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention import kernel as paged_kernel
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref,
    paged_attention_split_ref,
)
from repro_torch.runtime import TorchPayload

# tests/test_kernels.py's shapes and tolerances, plus ragged shapes: d and f
# not multiples of 4 (the scalar loads), f a multiple of 4 but not of 8 (f32
# takes the 16-byte loads, bf16 the scalar ones), C not a multiple of the
# 128-row tile, d not a multiple of the 16-deep k tile
SHAPES = [(4, 256, 128, 256), (2, 128, 256, 128), (8, 128, 64, 64),
          (3, 100, 70, 90), (3, 200, 64, 36), (2, 129, 35, 17), (2, 300, 520, 136)]
TOLS = {
    torch.float32: dict(rtol=2e-4, atol=2e-4),
    torch.bfloat16: dict(rtol=5e-2, atol=5e-1),
}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernel_matches_plain_on_card(dtype):
    _need_card()
    rng = np.random.default_rng(6)
    for E, C, d, f in SHAPES:
        gs = rng.integers(0, C + 1, size=E)
        x = rng.normal(size=(E, C, d)) * (
            np.arange(C)[None, :] < gs[:, None])[..., None]
        xt = torch.tensor(x, device="cuda").to(dtype)
        wt = torch.tensor(rng.normal(size=(E, d, f)), device="cuda").to(dtype)
        gt = torch.tensor(gs, dtype=torch.int32, device="cuda")
        before = ops.launches
        out = ops.gmm(xt, wt, gt)
        torch.cuda.synchronize()
        assert ops.launches == before + 1
        ref = grouped_matmul_ref(xt, wt, gt)
        torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])
        pad = torch.arange(C, device="cuda")[None, :] >= gt[:, None]
        assert (out.float().abs()[pad] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernel_takes_unaligned_inputs(dtype):
    """Inputs that are not 16-byte aligned go through the scalar loads."""
    _need_card()
    rng = np.random.default_rng(9)
    E, C, d, f = 2, 64, 64, 64
    x = torch.tensor(rng.normal(size=E * C * d + 1), device="cuda").to(dtype)[1:]
    x = x.view(E, C, d)
    w = torch.tensor(rng.normal(size=(E, d, f)), device="cuda").to(dtype)
    gs = torch.tensor([64, 17], dtype=torch.int32, device="cuda")
    assert x.data_ptr() % 16 and x.is_contiguous()
    out = ops.gmm(x, w, gs)
    torch.testing.assert_close(out.float(), grouped_matmul_ref(x, w, gs).float(),
                               **TOLS[dtype])


@pytest.mark.cuda
def test_torch_payload_launches_the_kernel_and_times_it():
    _need_card()
    payload = TorchPayload()  # defaults to the card
    before = ops.launches
    out = payload._compute()
    assert ops.launches == before + 1
    assert out.is_cuda and len(payload.device_ms) == 1
    assert payload.device_ms[0] > 0
    want = grouped_matmul_ref(payload._x, payload._w, payload._sizes)
    torch.testing.assert_close(out, want, **TOLS[torch.float32])


@pytest.mark.cuda
def test_gmm_empty_output_counts_no_launch():
    _need_card()
    x = torch.zeros((2, 0, 8), device="cuda")
    w = torch.zeros((2, 8, 4), device="cuda")
    gs = torch.zeros((2,), dtype=torch.int32, device="cuda")
    before = ops.launches
    assert ops.gmm(x, w, gs).shape == (2, 0, 4)
    assert ops.launches == before


@pytest.mark.cuda
def test_torch_payload_reports_its_launches_and_device_ms():
    _need_card()
    payload = TorchPayload()
    assert payload.kernel_launches() == 1  # the warm-up
    ms = payload.run_sync(SimpleNamespace(duration=0.0), 0.01)
    assert payload.kernel_launches() == 2
    assert ms is not None and ms > 0 and payload.device_ms == [ms]


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

# tests/test_kernels.py's paged-attention tolerances
PAGED_TOLS = {
    torch.float32: dict(rtol=2e-5, atol=2e-5),
    torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
}


def _paged_inputs(rng, H, KVH, D, lens, page_size, num_pages, dtype):
    """Pages dealt from a permutation of pages 1..P-1 (page 0 is what -1
    entries read), NaN in every page no entry refers to."""
    max_pages = max(-(-n // page_size) for n in lens) + 1
    perm = rng.permutation(np.arange(1, num_pages))
    table = np.full((len(lens), max_pages), -1, np.int32)
    off = 0
    for b, n in enumerate(lens):
        k = -(-n // page_size)
        table[b, :k] = perm[off:off + k]
        off += k
    referenced = set(table[table >= 0].tolist()) | {0}
    unused = [p for p in range(num_pages) if p not in referenced]

    def t(shape):
        return torch.tensor(rng.normal(size=shape), device="cuda").to(dtype)

    q = t((len(lens), H, D))
    kp = t((num_pages, page_size, KVH, D))
    vp = t((num_pages, page_size, KVH, D))
    kp[unused] = float("nan")
    vp[unused] = float("nan")
    return (q, kp, vp, torch.tensor(table, device="cuda"),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("H,KVH,D", [(8, 2, 64), (4, 4, 64), (16, 1, 64),
                                     (32, 8, 128), (16, 1, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_matches_plain_on_card(H, KVH, D, dtype):
    _need_card()
    rng = np.random.default_rng(7)
    lens = [37, 5, 0, 100, 16]
    args = _paged_inputs(rng, H, KVH, D, lens, 16, 64, dtype)
    args[3][3, 2] = -1  # inside row 3's live range: reads page 0
    args[4][4] = 10_000  # past the table's capacity: every slot is live
    before = paged_ops.launches
    out = paged_ops.paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_ops.launches == before + 1
    ref = paged_attention_ref(*args)
    assert torch.isfinite(out).all()
    assert (out[2] == 0).all()  # the length-0 row
    torch.testing.assert_close(out.float(), ref.float(), **PAGED_TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [8, 16, 32])
def test_paged_kernel_never_reads_unreferenced_pages(page_size):
    _need_card()
    rng = np.random.default_rng(8)
    q, kp, vp, table, lens = _paged_inputs(
        rng, 8, 2, 128, [70, 1, 33], page_size, 40, torch.float32)
    out_nan = paged_ops.paged_attention(q, kp, vp, table, lens)
    clean = torch.nan_to_num(kp, nan=7.0), torch.nan_to_num(vp, nan=-7.0)
    out = paged_ops.paged_attention(q, *clean, table, lens)
    torch.cuda.synchronize()
    assert torch.equal(out_nan, out)


def _split_inputs(G, D, page_size, dtype, seed=10):
    """Sequences that start, end and cross the kernel's chunk and split
    boundaries: length 0, exactly one chunk, one token past it, runs of
    two chunks a split (one more chunk than slots), one token past that,
    the table's whole capacity; a -1 inside a live range."""
    KVH, B, max_pages = 8, 6, 60  # 48 (sequence, KV head) pairs
    elem = torch.tensor([], dtype=dtype).element_size()
    chunk, slots = paged_kernel.split_plan(elem, D, page_size, max_pages, B, KVH)
    ts, cap = chunk * page_size, max_pages * page_size
    lens = [0, ts, ts + 1, min((slots + 1) * ts, cap), min((slots + 1) * ts + 1, cap),
            cap]
    num_pages = sum(-(-n // page_size) for n in lens) + 8
    args = list(_paged_inputs(np.random.default_rng(seed), G * KVH, KVH, D, lens,
                              page_size, num_pages, dtype))
    table = torch.full((B, max_pages), -1, dtype=torch.int32, device="cuda")
    table[:, :args[3].shape[1]] = args[3][:, :max_pages]
    table[3, 1] = -1  # inside row 3's live range: reads page 0
    args[3] = table
    return args, chunk, slots


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [8, 16, 32])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_across_split_boundaries(G, D, page_size, dtype):
    _need_card()
    args, chunk, slots = _split_inputs(G, D, page_size, dtype)
    assert slots >= 3
    out = paged_ops.paged_attention(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and (out[0] == 0).all()
    torch.testing.assert_close(out.float(), paged_attention_ref(*args).float(),
                               **PAGED_TOLS[dtype])
    torch.testing.assert_close(out.float(),
                               paged_attention_split_ref(*args, chunk, slots).float(),
                               **PAGED_TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_is_bitwise_repeatable(dtype):
    """The splits are combined in split order, whichever finishes last."""
    _need_card()
    args, _, _ = _split_inputs(4, 128, 16, dtype)
    first = paged_ops.paged_attention(*args)
    for _ in range(3):
        assert torch.equal(paged_ops.paged_attention(*args), first)


@pytest.mark.cuda
def test_paged_kernel_back_to_back_calls_reset_the_counters():
    """Two calls on one stream with no sync between: the second finds its
    (sequence, KV head) counters at 0 again, so each is right."""
    _need_card()
    a, _, _ = _split_inputs(4, 128, 16, torch.bfloat16, seed=11)
    b, _, _ = _split_inputs(4, 128, 16, torch.bfloat16, seed=12)
    out_a = paged_ops.paged_attention(*a)
    out_b = paged_ops.paged_attention(*b)
    out_a2 = paged_ops.paged_attention(*a)
    torch.cuda.synchronize()
    for out, args in ((out_a, a), (out_b, b), (out_a2, a)):
        torch.testing.assert_close(out.float(), paged_attention_ref(*args).float(),
                                   **PAGED_TOLS[torch.bfloat16])
    assert torch.equal(out_a, out_a2)


@pytest.mark.cuda
def test_paged_kernel_shared_memory_plan_matches_the_source():
    _need_card()
    lib = paged_kernel._library()
    for elem, G, D, ps, chunk in ((2, 4, 128, 16, 4), (4, 16, 256, 32, 1),
                                  (4, 1, 64, 8, 17), (2, 8, 8, 16, 3)):
        assert lib.paged_attn_shared_bytes(elem, G, D, ps, chunk) == \
            paged_kernel.shared_bytes(elem, G, D, ps, chunk)


@pytest.mark.cuda
def test_paged_decode_on_card_launches_once_per_layer_and_step():
    _need_card()
    from repro_torch.launch import serve

    stats_cpu = serve.run_local(serve.parse_args(
        ["--backend", "local", "--smoke", "--device", "cpu", "--requests", "4",
         "--gen-tokens", "3"]))
    before = paged_ops.launches
    stats = serve.run_local(serve.parse_args(
        ["--backend", "local", "--smoke", "--requests", "4", "--gen-tokens", "3"]))
    assert paged_ops.launches == before + 2 * 3  # 2 layers x 3 decode steps
    assert stats["logits_finite"]
    assert stats["tokens"].shape == stats_cpu["tokens"].shape == (4, 4)


# ---------------------------------------------------------------------------
# packed attention, forward and backward
# ---------------------------------------------------------------------------

# In bf16 (the float32 kernels' cases follow below).  Forward:
# tests/test_kernels.py's bf16 TOLS.  Output and gradients: ``rel_l2``
# (ref.py), ||err|| / ||ref|| over the whole tensor and over each 64-row
# tile of one head, within REL_L2; the kernels round P and dS to bf16 as
# tensor-core operands and take delta from the bf16 output, where the plain
# version keeps fp32 (chip_smoke.py's PACKED_REL_L2 gives the argument and
# the planted faults these limits catch).
@pytest.mark.cuda
@pytest.mark.parametrize("H,KVH,D", [(16, 16, 64), (14, 2, 64)], ids=["G1", "G7"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_at_the_new_families_decode_shapes(H, KVH, D, dtype):
    """seamless-m4t-medium's decode (G = 1, D = 64; its cross attention runs
    over 1024 encoder positions) and internvl2-1b's (G = 7, D = 64), with a
    second launch bitwise equal to the first."""
    _need_card()
    rng = np.random.default_rng(H + KVH)
    lens = [1024, 320, 0, 65, 1000, 17, 1024, 333]
    args = _paged_inputs(rng, H, KVH, D, lens, 16, 1024, dtype)
    out = paged_ops.paged_attention(*args)
    again = paged_ops.paged_attention(*args)
    torch.cuda.synchronize()
    ref = paged_attention_ref(*args)
    assert torch.isfinite(out).all() and (out[2] == 0).all()
    assert torch.equal(again, out)
    torch.testing.assert_close(out.float(), ref.float(), **PAGED_TOLS[dtype])


PACKED_TOLS = dict(rtol=2e-2, atol=2e-2)
REL_L2 = (1e-2, 2e-2)  # (whole tensor, worst 64-row tile of a head)
# (S, H, KVH, D, window[, layout]): test_kernels' grid, GQA, a window, ragged
# lengths; then one document filling each row (almost every tile is full:
# the unmasked path), S = 1000 and 300 (TMA's zero fill past the end, a
# ragged last tile), GQA with G = 4 and 8 at D = 128 and G = 7 at D = 64
# (internvl2-1b's 14 over 2), and a window of 192, not a multiple of a tile
PACKED_CASES = [(256, 4, 4, 64, 0), (512, 4, 2, 64, 0), (384, 4, 1, 32, 0),
                (200, 4, 2, 16, 0), (256, 2, 2, 32, 64), (300, 8, 2, 128, 0),
                (1024, 4, 4, 128, 0, "one-document"), (1000, 8, 2, 128, 0),
                (300, 4, 4, 64, 0), (512, 16, 4, 128, 0), (512, 16, 2, 128, 0),
                (256, 14, 2, 64, 0), (640, 4, 2, 128, 192), (640, 4, 4, 64, 192)]


def _packed_segments(rng, B, S, max_segs=4, pad_frac=0.2):
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        n_real = int(S * (1 - pad_frac * rng.random()))
        cuts = np.sort(rng.choice(np.arange(1, n_real), size=max_segs - 1,
                                  replace=False))
        bounds = [0, *cuts, n_real]
        for i in range(len(bounds) - 1):
            seg[b, bounds[i]:bounds[i + 1]] = i + 1
    return seg


def _packed_run(fn, q, k, v, g):
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*ts)
    out.backward(g)
    return out.detach(), [t.grad for t in ts]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PACKED_CASES, ids=lambda c: "x".join(map(str, c)))
def test_packed_kernels_match_plain_on_card(case):
    _need_card()
    from repro_torch.kernels.packed_attention import ops as packed_ops
    from repro_torch.kernels.packed_attention.ref import rel_l2

    S, H, KVH, D, window = case[:5]
    B = 2
    rng = np.random.default_rng(sum(case[:5]))

    def t(shape):
        return torch.tensor(rng.normal(size=shape), device="cuda").to(torch.bfloat16)

    q, k, v, g = t((B, S, H, D)), t((B, S, KVH, D)), t((B, S, KVH, D)), t((B, S, H, D))
    seg = (np.ones((B, S), np.int32) if case[5:] == ("one-document",)
           else _packed_segments(rng, B, S))
    seg = torch.tensor(seg, device="cuda")
    before = (packed_ops.launches_fwd, packed_ops.launches_bwd)
    out, grads = _packed_run(
        lambda *a: packed_ops.packed_attention(*a, seg, seg, window=window), q, k, v, g)
    torch.cuda.synchronize()
    assert (packed_ops.launches_fwd, packed_ops.launches_bwd) == (before[0] + 1,
                                                                  before[1] + 1)
    ref, ref_grads = _packed_run(
        lambda *a: packed_ops.packed_attention_plain(*a, seg, seg, window=window),
        q, k, v, g)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), **PACKED_TOLS)
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out, *grads), (ref, *ref_grads),
                          strict=True):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        whole, tile = rel_l2(a, b)
        assert whole <= REL_L2[0] and tile <= REL_L2[1], (name, whole, tile)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
def test_packed_kernels_are_bitwise_repeatable_on_card(D):
    """Two launches of the forward and of the backward on the same inputs
    give the same bits: no atomics, a fixed order of every sum."""
    _need_card()
    from repro_torch.kernels.packed_attention import ops as packed_ops

    rng = np.random.default_rng(D)
    B, S, H, KVH = 2, 640, 8, 2

    def t(shape):
        return torch.tensor(rng.normal(size=shape), device="cuda").to(torch.bfloat16)

    q, k, v, g = t((B, S, H, D)), t((B, S, KVH, D)), t((B, S, KVH, D)), t((B, S, H, D))
    seg = torch.tensor(_packed_segments(rng, B, S), device="cuda")
    runs = [_packed_run(lambda *a: packed_ops.packed_attention(*a, seg, seg), q, k, v, g)
            for _ in range(2)]
    torch.cuda.synchronize()
    (out0, grads0), (out1, grads1) = runs
    assert torch.equal(out0, out1)
    for a, b in zip(grads0, grads1, strict=True):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_packed_kernels_refuse_float32_on_card():
    """float32 beside bf16 (or float16 alone): the kernels take q, k, v all
    bf16 or all float32, and refuse any other mix before a launch."""
    _need_card()
    from repro_torch.kernels.packed_attention import ops as packed_ops

    x = torch.zeros((1, 64, 2, 32), device="cuda")
    seg = torch.ones((1, 64), dtype=torch.int32, device="cuda")
    before = (packed_ops.launches_fwd, packed_ops.launches_bwd)
    with pytest.raises(TypeError, match="bfloat16 or all float32"):
        packed_ops.packed_attention(x, x.bfloat16(), x.bfloat16(), seg, seg)
    with pytest.raises(TypeError, match="bfloat16 or all float32"):
        packed_ops.packed_attention(x.half(), x.half(), x.half(), seg, seg)
    assert (packed_ops.launches_fwd, packed_ops.launches_bwd) == before


@pytest.mark.cuda
def test_packed_padded_row_gives_zero_output_and_gradient():
    _need_card()
    from repro_torch.kernels.packed_attention import ops as packed_ops

    rng = np.random.default_rng(9)
    B, S, H, KVH, D = 2, 256, 4, 2, 64

    def t(shape):
        return torch.tensor(rng.normal(size=shape), device="cuda").to(torch.bfloat16)

    q, k, v, g = t((B, S, H, D)), t((B, S, KVH, D)), t((B, S, KVH, D)), t((B, S, H, D))
    seg = torch.tensor(_packed_segments(rng, B, S), device="cuda")
    seg[1] = 0
    out, (dq, dk, dv) = _packed_run(
        lambda *a: packed_ops.packed_attention(*a, seg, seg), q, k, v, g)
    torch.cuda.synchronize()
    pad = seg == 0
    assert (out[1] == 0).all() and torch.isfinite(out).all()
    for grad in (dq, dk, dv):
        assert (grad[pad] == 0).all()


# (Sq, Skv, H, KVH, D, causal): queries and keys of different lengths, as
# seamless-m4t-medium's cross attention (64 decoder tokens against 1024
# encoder frames, and 1000: a ragged last key tile), its non-causal
# encoder, a causal Sq != Skv, and G = 7 at D = 64
CROSS_CASES = [(64, 1024, 16, 16, 64, False), (64, 1000, 16, 16, 64, False),
               (320, 320, 14, 2, 64, False), (300, 130, 4, 2, 128, False),
               (200, 450, 14, 2, 64, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CROSS_CASES, ids=lambda c: "x".join(map(str, c)))
def test_packed_kernels_with_separate_key_lengths_on_card(case):
    """Forward and backward against the autograd of the plain version with
    separate query and key segment ids (each padding some rows), the tile
    census equal to ``ref.tile_schedule``'s, padded keys' dK and dV 0."""
    _need_card()
    from repro_torch.kernels.packed_attention import kernel as pk
    from repro_torch.kernels.packed_attention import ops as packed_ops
    from repro_torch.kernels.packed_attention.ref import census_rule, rel_l2

    Sq, Skv, H, KVH, D, causal = case
    B = 3
    rng = np.random.default_rng(Sq + Skv + D)

    def t(shape):
        return torch.tensor(rng.normal(size=shape), device="cuda").to(torch.bfloat16)

    q, k, v, g = (t((B, Sq, H, D)), t((B, Skv, KVH, D)), t((B, Skv, KVH, D)),
                  t((B, Sq, H, D)))
    seg_q_np, seg_kv_np = np.ones((B, Sq), np.int32), np.ones((B, Skv), np.int32)
    seg_q_np[1, Sq - Sq // 5:] = 0
    seg_kv_np[2, Skv - Skv // 3:] = 0
    seg_q, seg_kv = (torch.tensor(a, device="cuda") for a in (seg_q_np, seg_kv_np))
    out, grads = _packed_run(lambda *a: packed_ops.packed_attention(
        *a, seg_q, seg_kv, causal=causal), q, k, v, g)
    ref, ref_grads = _packed_run(lambda *a: packed_ops.packed_attention_plain(
        *a, seg_q, seg_kv, causal=causal), q, k, v, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **PACKED_TOLS)
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out, *grads), (ref, *ref_grads),
                          strict=True):
        assert a.shape == b.shape and torch.isfinite(a).all()
        whole, tile = rel_l2(a, b)
        assert whole <= REL_L2[0] and tile <= REL_L2[1], (name, whole, tile)
    pad_kv = seg_kv == 0
    assert (grads[1][pad_kv] == 0).all() and (grads[2][pad_kv] == 0).all()
    assert (out[seg_q == 0] == 0).all()
    pk.tile_census(on=True)
    o, lse, lo = pk.packed_flash_attention(q, k, v, seg_q, seg_kv, causal=causal,
                                           residual=True)
    pk.packed_flash_attention_bwd(q, k, v, seg_q, seg_kv, o, lo, g, lse, causal=causal)
    census = pk.tile_census(on=False)
    assert census == census_rule(seg_q.cpu(), seg_kv.cpu(), H, KVH, causal=causal)


@pytest.mark.cuda
def test_packed_backward_takes_delta_from_the_unrounded_output_on_card():
    """seamless-m4t-medium's decoder cross-attention shape (512 tokens over
    1024 frames, two documents a side, 16 heads of 64), its keys and values
    each with one mean per document and its queries tempered by 2^-3, as
    phase 15 of chip_smoke.py trains it: the kernels' dQ, dK and dV within
    1e-2 of fp64 (relative l2); with the forward's residual zeroed
    (delta from the bf16 output) dQ reads above 5e-2.  The forward writes
    the same output with the residual as without it, and the residual
    within a few ulps of it."""
    _need_card()
    from repro_torch.kernels.packed_attention import kernel as pk
    from repro_torch.kernels.packed_attention.ref import visible_mask

    B, Sq, Skv, H, D = 2, 512, 1024, 16, 64
    rng = np.random.default_rng(24)
    seg_q_np, seg_kv_np = np.ones((B, Sq), np.int32), np.ones((B, Skv), np.int32)
    for b in range(B):
        seg_q_np[b, Sq * (b + 1) // (B + 1):] = 2
        seg_kv_np[b, Skv * (b + 1) // (B + 1):] = 2
    q = rng.normal(size=(B, Sq, H, D)) * 2.0 ** -3
    k, v = rng.normal(size=(B, Skv, H, D)), rng.normal(size=(B, Skv, H, D))
    for b in range(B):
        for sid in (1, 2):
            m = seg_kv_np[b] == sid
            k[b, m] += 2.0 * rng.normal(size=(1, H, D))
            v[b, m] += 1.5 * rng.normal(size=(1, H, D))
    g = rng.normal(size=(B, Sq, H, D))
    q, k, v, g = (torch.tensor(x, device="cuda").to(torch.bfloat16) for x in (q, k, v, g))
    seg_q, seg_kv = (torch.tensor(a, device="cuda") for a in (seg_q_np, seg_kv_np))

    out, lse, lo = pk.packed_flash_attention(q, k, v, seg_q, seg_kv, causal=False,
                                             residual=True)
    out_alone, _ = pk.packed_flash_attention(q, k, v, seg_q, seg_kv, causal=False)
    assert torch.equal(out, out_alone)
    assert lo.abs().max() > 0 and (lo.float().abs() <= out.float().abs() * 2.0 ** -6).all()
    grads = pk.packed_flash_attention_bwd(q, k, v, seg_q, seg_kv, out, lo, g, lse,
                                          causal=False)
    dq_bf16_delta, _, _ = pk.packed_flash_attention_bwd(
        q, k, v, seg_q, seg_kv, out, torch.zeros_like(lo), g, lse, causal=False)

    mask = visible_mask(seg_q, seg_kv, causal=False)[:, None]
    ts = [t.double().requires_grad_(True) for t in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", ts[0], ts[1]) / D ** 0.5
    exact = torch.einsum("bhqk,bkhd->bqhd",
                         torch.softmax(s.masked_fill(~mask, float("-inf")), -1), ts[2])
    truth = torch.autograd.grad(exact, ts, g.double())

    def rel(a, b):
        return ((a.double() - b).norm() / b.norm()).item()

    readings = [rel(a, b) for a, b in zip(grads, truth, strict=True)]
    assert max(readings) <= 1e-2, readings
    assert rel(dq_bf16_delta, truth[0]) > 5e-2, (readings, rel(dq_bf16_delta, truth[0]))


# (S, H, KVH, D, window, causal): skipped, full and masked tiles, GQA, a
# window, a ragged last tile, and no causal limit
CENSUS_CASES = [(1000, 8, 2, 128, 0, True), (640, 4, 4, 64, 192, True),
                (512, 4, 2, 128, 0, False), (4096, 2, 1, 128, 0, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CENSUS_CASES, ids=lambda c: "x".join(map(str, c)))
def test_packed_tile_census_matches_tile_schedule(case):
    """The tiles each kernel skipped, masked and left unmasked, counted by
    the kernels, are ``ref.tile_schedule``'s count of the same rule, once
    per head (per KV head in dK/dV); with the census off nothing is
    counted."""
    _need_card()
    from repro_torch.kernels.packed_attention import kernel as pk
    from repro_torch.kernels.packed_attention.ref import census_rule

    S, H, KVH, D, window, causal = case
    B = 3
    rng = np.random.default_rng(S + D + window)

    def t(shape):
        return torch.tensor(rng.normal(size=shape), device="cuda").to(torch.bfloat16)

    q, k, v, g = t((B, S, H, D)), t((B, S, KVH, D)), t((B, S, KVH, D)), t((B, S, H, D))
    seg_np = _packed_segments(rng, B, S)
    seg_np[0] = 1  # one document filling a row: full tiles
    seg = torch.tensor(seg_np, device="cuda")
    kw = dict(causal=causal, window=window)
    pk.tile_census(on=True)
    out, lse, lo = pk.packed_flash_attention(q, k, v, seg, seg, residual=True, **kw)
    pk.packed_flash_attention_bwd(q, k, v, seg, seg, out, lo, g, lse, **kw)
    census = pk.tile_census(on=False)
    assert census == census_rule(torch.tensor(seg_np), torch.tensor(seg_np), H, KVH, **kw)
    assert census["forward"]["masked"] > 0
    if window == 0:  # a window narrower than two tiles leaves no tile full
        assert census["forward"]["full"] > 0
    pk.packed_flash_attention(q, k, v, seg, seg, **kw)
    assert all(n == 0 for counts in pk.tile_census(on=False).values()
               for n in counts.values())


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_packed_kernels_take_a_row_of_140000_tokens(D):
    """A row longer than 131072 tokens, in documents of 1000: the first and
    the last document's output and gradients are the plain version's on
    that document alone."""
    _need_card()
    from repro_torch.kernels.packed_attention import ops as packed_ops
    from repro_torch.kernels.packed_attention.ref import rel_l2

    S, doc, H, KVH = 140_000, 1000, 2, 1
    rng = np.random.default_rng(D)

    def t(shape):
        return torch.tensor(rng.normal(size=shape), device="cuda").to(torch.bfloat16)

    q, k, v, g = t((1, S, H, D)), t((1, S, KVH, D)), t((1, S, KVH, D)), t((1, S, H, D))
    seg = (torch.arange(S, device="cuda", dtype=torch.int32) // doc + 1)[None]
    out, grads = _packed_run(
        lambda *a: packed_ops.packed_attention(*a, seg, seg), q, k, v, g)
    one = torch.ones((1, doc), dtype=torch.int32, device="cuda")
    for first in (0, S - doc):
        rows = slice(first, first + doc)
        ref, ref_grads = _packed_run(
            lambda *a: packed_ops.packed_attention_plain(*a, one, one),
            q[:, rows], k[:, rows], v[:, rows], g[:, rows])
        for name, a, b in zip(("out", "dq", "dk", "dv"),
                              (out[:, rows], *(x[:, rows] for x in grads)),
                              (ref, *ref_grads), strict=True):
            whole, tile = rel_l2(a, b)
            assert whole <= REL_L2[0] and tile <= REL_L2[1], (first, name, whole, tile)


@pytest.mark.cuda
def test_packed_kernels_raise_on_a_row_past_the_tile_schedule():
    """At D = 128 a block's tile schedule (a byte per key tile in range)
    fits beside the forward's stages up to about 8.5 million keys a row
    (an H100's 227 KB of shared memory): past that the forward raises."""
    _need_card()
    from repro_torch.kernels.packed_attention import kernel as pk

    S = 9_000_000
    x = torch.zeros((1, S, 1, 128), dtype=torch.bfloat16, device="cuda")
    seg = torch.ones((1, S), dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="tile schedule"):
        pk.packed_flash_attention(x, x, x, seg, seg)


@pytest.mark.cuda
@pytest.mark.parametrize("remat,fwd_per_layer", [("nothing", 2), ("dots", 2),
                                                 ("everything", 1)])
def test_packed_launches_per_train_step(remat, fwd_per_layer):
    """A 2-layer model: under remat "nothing" and "dots" each layer's
    attention forward runs twice (once more in the recomputation), under
    "everything" once; its backward once."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.kernels.packed_attention import ops as packed_ops
    from repro_torch.launch.train import make_params
    from repro_torch.models import build_model
    from repro_torch.training import OptimizerConfig, init_opt_state, make_train_step

    cfg = get_config("olmo-1b").smoke()
    model = build_model(cfg)
    dev = torch.device("cuda")
    params = make_params(model, 0, dev)
    rng = np.random.default_rng(0)
    batch = {
        "tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (2, 128)),
                               dtype=torch.int32, device=dev),
        "labels": torch.tensor(rng.integers(0, cfg.vocab_size, (2, 128)),
                               dtype=torch.int32, device=dev),
        "segment_ids": torch.tensor(_packed_segments(rng, 2, 128), device=dev),
        "positions": torch.arange(128, dtype=torch.int32, device=dev).expand(2, 128),
    }
    step = make_train_step(model, OptimizerConfig(), remat_policy=remat)
    packed_ops.launches_fwd = packed_ops.launches_bwd = 0
    _, _, metrics = step(params, init_opt_state(params), batch)
    torch.cuda.synchronize()
    assert packed_ops.launches_fwd == 2 * fwd_per_layer
    assert packed_ops.launches_bwd == 2
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])


# ---------------------------------------------------------------------------
# the MoE layer: the grouped matmul's bf16 entry at qwen3-moe-30b-a3b's shapes
# ---------------------------------------------------------------------------

# (E, C, d, f, live rows an expert): a decode step of 8 sequences (0-2 rows
# in 128-row bins) and a prefill of 8 x 1024 tokens (about 512 rows in
# 640-row bins), through the gate/up products and the down product
MOE_SHAPES = [(128, 128, 2048, 768, (0, 2)), (128, 640, 2048, 768, (448, 576)),
              (128, 640, 768, 2048, (448, 576))]
# bf16 outputs one ulp apart everywhere would read at most 2^-7 in relative
# l2; the kernel (fp32 sums on the tensor cores, each k16 step summed in the
# hardware's own order) and the plain version (fp32 sums in k order) differ
# by fp32 rounding in the sums and by where those round to bf16
MOE_REL_L2 = 1e-2


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", MOE_SHAPES, ids=lambda c: "x".join(map(str, c[:4])))
def test_gmm_bf16_at_the_moe_shapes(case):
    _need_card()
    E, C, d, f, (lo, hi) = case
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    gs = torch.randint(lo, hi + 1, (E,), generator=gen, device=dev, dtype=torch.int32)
    live = (torch.arange(C, device=dev)[None, :] < gs[:, None])[..., None]
    x = (torch.randn((E, C, d), generator=gen, device=dev) * live).to(torch.bfloat16)
    w = (torch.randn((E, d, f), generator=gen, device=dev) / d ** 0.5).to(torch.bfloat16)
    before = ops.launches
    out = ops.gmm(x, w, gs)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    ref = grouped_matmul_ref(x, w, gs)
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[torch.bfloat16])
    assert _rel_l2(out, ref) <= MOE_REL_L2
    assert (out.float().abs()[~live[..., 0]] == 0).all()


def _bf16_bins(E, C, d, f, gs, seed):
    """bf16 x (zeros past each bin's size, as the dispatch leaves them) and
    w of unit-variance outputs, made on the card from a seed."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    gs = torch.as_tensor(gs, dtype=torch.int32, device=dev)
    live = (torch.arange(C, device=dev)[None, :] < gs[:, None])[..., None]
    x = (torch.randn((E, C, d), generator=gen, device=dev) * live).to(torch.bfloat16)
    w = (torch.randn((E, d, f), generator=gen, device=dev) / d ** 0.5).to(torch.bfloat16)
    return x, w, gs, live[..., 0]


def _path(x, w):
    """The path the wrapper takes (its output is a fresh, aligned allocation)."""
    return gmm_kernel.path(x.dtype, x.shape[2], w.shape[2], x.data_ptr(), w.data_ptr())


def _census_of(fn):
    """``fn()``'s result and the tile census of the launches it made."""
    gmm_kernel.tile_census(True)
    try:
        out = fn()
    finally:
        counts = gmm_kernel.tile_census(False)
    return out, counts


def _ref_census(gs, C, f):
    return {**tile_census(gs.cpu(), C, f), "simt_calls": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("g", [63, 64, 65, 127, 128, 129])
def test_gmm_tma_path_across_half_and_tile_edges(g):
    """Bins whose size ends just before, at and after a 64-row half and a
    128-row tile, beside an empty and a full bin: within TOLS and the MoE
    limit, rows past each bin exactly 0, the census equal to the rule's."""
    _need_card()
    E, C, d, f = 4, 640, 256, 768
    x, w, gs, live = _bf16_bins(E, C, d, f, [g, 0, C, C - g], seed=g)
    assert _path(x, w) == "tma"
    out, counts = _census_of(lambda: ops.gmm(x, w, gs))
    ref = grouped_matmul_ref(x, w, gs)
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[torch.bfloat16])
    assert _rel_l2(out, ref) <= MOE_REL_L2
    assert (out[~live] == 0).all()
    assert counts == _ref_census(gs, C, f)


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,f", [(3, 16, 8, 8), (2, 40, 24, 40), (2, 64, 56, 72),
                                     (1, 1, 8, 8)])
def test_gmm_tma_path_under_one_box(E, C, d, f):
    """Shapes smaller than one 64 x 64 box in C, d or f: TMA fills what lies
    past the ends with zeros and leaves it out of the stores."""
    _need_card()
    x, w, gs, live = _bf16_bins(E, C, d, f, [C] + [C // 2] * (E - 1), seed=d + f)
    assert _path(x, w) == "tma"
    out, counts = _census_of(lambda: ops.gmm(x, w, gs))
    ref = grouped_matmul_ref(x, w, gs)
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[torch.bfloat16])
    assert (out[~live] == 0).all()
    assert counts == _ref_census(gs, C, f)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_paths_on_card(dtype):
    """Each of SHAPES takes the path ``kernel.path`` names: f32 and the bf16
    shapes TMA cannot take count as SIMT calls, the others as tiles."""
    _need_card()
    rng = np.random.default_rng(13)
    for E, C, d, f in SHAPES:
        gs = torch.tensor(rng.integers(0, C + 1, size=E), dtype=torch.int32, device="cuda")
        x = torch.tensor(rng.normal(size=(E, C, d)), device="cuda").to(dtype)
        w = torch.tensor(rng.normal(size=(E, d, f)), device="cuda").to(dtype)
        which = _path(x, w)
        out, counts = _census_of(lambda: ops.gmm(x, w, gs))
        torch.testing.assert_close(out.float(), grouped_matmul_ref(x, w, gs).float(),
                                   **TOLS[dtype])
        if which == "tma":
            assert counts == _ref_census(gs, C, f), (E, C, d, f)
        else:
            tiles = {"zero_tiles": 0, "halves_computed": 0, "halves_skipped": 0}
            assert counts == {**tiles, "simt_calls": int(dtype == torch.bfloat16)}
    assert [s for s in SHAPES if gmm_kernel.path(torch.bfloat16, s[2], s[3], 0) == "tma"] \
        == [(4, 256, 128, 256), (2, 128, 256, 128), (8, 128, 64, 64), (2, 300, 520, 136)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MOE_SHAPES, ids=lambda c: "x".join(map(str, c[:4])))
def test_gmm_bf16_repeats_bitwise_at_the_moe_shapes(case):
    """No split over k and no atomics: a launch gives the bits of the last."""
    _need_card()
    E, C, d, f, (lo, hi) = case
    gen = torch.Generator(device="cuda").manual_seed(43)
    gs = torch.randint(lo, hi + 1, (E,), generator=gen, device="cuda", dtype=torch.int32)
    x, w, gs, _ = _bf16_bins(E, C, d, f, gs, seed=44)
    first = ops.gmm(x, w, gs)
    for _ in range(2):
        assert torch.equal(ops.gmm(x, w, gs), first)


@pytest.mark.cuda
@pytest.mark.parametrize("case", MOE_SHAPES, ids=lambda c: "x".join(map(str, c[:4])))
def test_gmm_bf16_census_and_planted_faults_at_the_moe_shapes(case):
    """The kernel's census equals ``ref.tile_census``; two faults built from
    the plain version read above the limit the kernel is held to: the last
    live row of each bin dropped, and one 64-deep k box left out."""
    _need_card()
    E, C, d, f, (lo, hi) = case
    gen = torch.Generator(device="cuda").manual_seed(47)
    gs = torch.randint(max(lo, 1), hi + 1, (E,), generator=gen, device="cuda",
                       dtype=torch.int32)
    x, w, gs, _ = _bf16_bins(E, C, d, f, gs, seed=48)
    assert _path(x, w) == "tma"
    out, counts = _census_of(lambda: ops.gmm(x, w, gs))
    assert counts == _ref_census(gs, C, f)
    short = grouped_matmul_ref(x, w, (gs - 1).clamp(min=0))
    hole = x.clone()
    hole[..., d // 2:d // 2 + 64] = 0
    no_box = grouped_matmul_ref(hole, w, gs)
    ref = grouped_matmul_ref(x, w, gs)
    assert _rel_l2(out, ref) <= MOE_REL_L2
    assert _rel_l2(short, out) > MOE_REL_L2 and _rel_l2(no_box, out) > MOE_REL_L2


def _moe_layer_inputs(T, seed=37):
    """qwen3-moe-30b-a3b's MoE layer at full width, bf16 weights drawn on the
    card, and ``T`` tokens of unit-variance input."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_specs
    from repro_torch.models.params import init_params

    cfg = get_config("qwen3-moe-30b-a3b")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = init_params(moe_specs(cfg), gen, torch.bfloat16, dev)
    x = torch.randn((1, T, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    return cfg, p, x


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8, 8 * 1024], ids=["decode", "prefill"])
def test_moe_layer_kernel_route_matches_plain_route_on_card(T):
    """The same routing through the kernel (128-row bins) and the batched
    product (8-row bins): at these token counts both bins hold every
    assignment an expert can get (decode) or the same 640 rows (prefill), so
    the drops are equal and the outputs differ by bf16 rounding only."""
    _need_card()
    from repro_torch.models.moe import expert_capacity, moe_layer

    cfg, p, x = _moe_layer_inputs(T)
    E, K, factor = cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.capacity_factor
    assert min(expert_capacity(T, E, K, factor, 128),
               expert_capacity(T, E, K, factor, 8)) >= min(T, 640)
    before = ops.launches
    got, aux = moe_layer(p, cfg, x)
    torch.cuda.synchronize()
    assert ops.launches == before + 3
    want, aux_plain = moe_layer(p, cfg, x, use_gmm_kernel=False)
    assert ops.launches == before + 3
    assert torch.equal(aux["moe_drop_fraction"], aux_plain["moe_drop_fraction"])
    assert _rel_l2(got, want) <= MOE_REL_L2
    assert bool(torch.isfinite(got).all())


@pytest.mark.cuda
def test_moe_layer_repeats_bitwise_on_card():
    _need_card()
    from repro_torch.models.moe import moe_layer

    cfg, p, x = _moe_layer_inputs(1024)
    a, aux_a = moe_layer(p, cfg, x)
    b, aux_b = moe_layer(p, cfg, x)
    assert torch.equal(a, b)
    assert all(torch.equal(aux_a[k], aux_b[k]) for k in aux_a)


@pytest.mark.cuda
def test_expert_ffn_swiglu_refuses_autograd_on_card():
    """The kernel's output carries no gradient: training through it raises,
    naming the ROADMAP item, and launches nothing."""
    _need_card()
    dev = torch.device("cuda")
    x = torch.randn((4, 128, 64), device=dev, dtype=torch.bfloat16)
    w = torch.randn((4, 64, 64), device=dev, dtype=torch.bfloat16, requires_grad=True)
    gs = torch.full((4,), 5, dtype=torch.int32, device=dev)
    before = ops.launches
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        ops.expert_ffn_swiglu(x, w, w, w, gs)
    assert ops.launches == before
    with torch.no_grad():
        out = ops.expert_ffn_swiglu(x, w, w, w, gs)
    assert ops.launches == before + 3 and out.shape == x.shape


@pytest.mark.cuda
def test_moe_serving_on_card_launches_three_products_per_layer():
    """qwen3-moe-30b-a3b at smoke size through ``run_local`` on the card:
    3 grouped-matmul launches per layer in the prefill and in every decode
    step, one paged launch per layer and step."""
    _need_card()
    from repro_torch.launch import serve

    argv = ["--backend", "local", "--arch", "qwen3-moe-30b-a3b", "--smoke",
            "--requests", "4", "--gen-tokens", "3"]
    before, paged_before = ops.launches, paged_ops.launches
    stats = serve.run_local(serve.parse_args(argv))
    assert ops.launches == before + 3 * 2 * (1 + 3)  # 2 layers, prefill + 3 steps
    assert paged_ops.launches == paged_before + 2 * 3
    assert stats["logits_finite"] and stats["tokens"].shape == (4, 4)


# ---------------------------------------------------------------------------
# The distributed layer on the card: the kernels' DTensor rule on a (1, 1)
# mesh of a one-rank NCCL group, and the int8 gradient compressor
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    started = not dist.is_initialized()
    yield make_local_mesh("cuda")
    if started and dist.is_initialized():
        dist.destroy_process_group()


def _dt(t, mesh, placements):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, mesh, placements, run_check=False)


@pytest.mark.cuda
def test_packed_kernels_run_shard_local_on_dtensors(card_mesh):
    """Batch and heads sharded: the kernels run (forward and backward) on
    the local shards and give the plain tensors' results; the sequence
    sharded raises and launches nothing."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels.packed_attention import ops as packed

    g = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, KVH, D = 2, 256, 4, 2, 64
    q, k, v = (torch.randn(B, S, h, D, device="cuda", generator=g, dtype=torch.bfloat16)
               for h in (H, KVH, KVH))
    seg = torch.ones(B, S, dtype=torch.int32, device="cuda")
    seg[:, 100:] = 2
    want = packed.packed_attention(q, k, v, seg, seg)
    heads, rows = (Shard(0), Shard(2)), (Shard(0), Replicate())
    dq = _dt(q.clone(), card_mesh, heads).requires_grad_(True)
    fwd, bwd = packed.launches_fwd, packed.launches_bwd
    out = packed.packed_attention(dq, _dt(k, card_mesh, heads), _dt(v, card_mesh, heads),
                                  _dt(seg, card_mesh, rows), _dt(seg, card_mesh, rows))
    assert isinstance(out, DTensor) and tuple(out.placements) == heads
    assert torch.equal(out.to_local(), want)
    out.sum().backward()
    assert (packed.launches_fwd, packed.launches_bwd) == (fwd + 1, bwd + 1)
    assert tuple(dq.grad.placements) == heads
    with pytest.raises(ValueError, match="packed_attention: q"):
        packed.packed_attention(_dt(q, card_mesh, (Shard(0), Shard(1))),
                                _dt(k, card_mesh, heads), _dt(v, card_mesh, heads),
                                _dt(seg, card_mesh, rows), _dt(seg, card_mesh, rows))
    assert (packed.launches_fwd, packed.launches_bwd) == (fwd + 1, bwd + 1)


@pytest.mark.cuda
def test_paged_and_grouped_kernels_run_shard_local_on_dtensors(card_mesh):
    from torch.distributed.tensor import Replicate, Shard

    rng = np.random.default_rng(3)
    B, H, KVH, D, P, ps = 4, 8, 2, 128, 32, 16
    q = torch.tensor(rng.normal(size=(B, H, D)), device="cuda").to(torch.bfloat16)
    kp, vp = (torch.tensor(rng.normal(size=(P, ps, KVH, D)), device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    table = torch.arange(B * 8, dtype=torch.int32, device="cuda").view(B, 8)
    lens = torch.tensor([128, 17, 64, 1], dtype=torch.int32, device="cuda")
    want = paged_ops.paged_attention(q, kp, vp, table, lens)
    rows, heads = (Shard(0), Replicate()), (Shard(0), Shard(1))
    pools = (Replicate(), Shard(2))
    before = paged_ops.launches
    out = paged_ops.paged_attention(_dt(q, card_mesh, heads), _dt(kp, card_mesh, pools),
                                    _dt(vp, card_mesh, pools), _dt(table, card_mesh, rows),
                                    _dt(lens, card_mesh, rows))
    assert paged_ops.launches == before + 1 and torch.equal(out.to_local(), want)
    with pytest.raises(ValueError, match="paged_attention: k_pool"):
        paged_ops.paged_attention(_dt(q, card_mesh, heads),
                                  _dt(kp, card_mesh, (Shard(0), Shard(2))),
                                  _dt(vp, card_mesh, pools), _dt(table, card_mesh, rows),
                                  _dt(lens, card_mesh, rows))
    E, C, d, f = 4, 128, 64, 64
    x = torch.tensor(rng.normal(size=(E, C, d)), device="cuda").to(torch.bfloat16)
    w = torch.tensor(rng.normal(size=(E, d, f)), device="cuda").to(torch.bfloat16)
    gs = torch.tensor([128, 3, 0, 64], dtype=torch.int32, device="cuda")
    want = ops.gmm(x, w, gs)
    experts = (Replicate(), Shard(0))
    before = ops.launches
    out = ops.gmm(_dt(x, card_mesh, experts), _dt(w, card_mesh, (Shard(2), Shard(0))),
                  _dt(gs, card_mesh, experts))
    assert ops.launches == before + 1 and torch.equal(out.to_local(), want)
    with pytest.raises(ValueError, match="gmm: w"):
        ops.gmm(_dt(x, card_mesh, experts), _dt(w, card_mesh, (Shard(1), Shard(0))),
                _dt(gs, card_mesh, experts))
    assert ops.launches == before + 1


@pytest.mark.cuda
def test_compressor_and_mesh_local_training_at_smoke_width_on_card(tmp_path):
    """The chip smoke's distributed phase at olmo-1b smoke width: the
    compressor's error bound, error-feedback identity and same-seed
    repeat on the step's gradients, the compressed run's step-1 loss equal
    to the plain run's, and ``launch.train --mesh local`` through the
    packed kernels with the plain run's step-1 loss."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.distributed import GradCompressor
    from repro_torch.kernels.packed_attention import ops as packed
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves, tree_unflatten
    from repro_torch.training import OptimizerConfig, init_opt_state, make_train_step
    from repro_torch.training.train_step import cast_params_for_compute

    cfg = get_config("olmo-1b").smoke()
    model = build_model(cfg)
    dev = torch.device("cuda")
    params = train.make_params(model, 0, dev)
    rng = np.random.default_rng(0)
    tok = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 256)), dtype=torch.int32,
                       device=dev)
    seg = torch.ones_like(tok)
    seg[:, 90:] = 2
    pos = torch.cat([torch.arange(90), torch.arange(166)]).int().to(dev).expand(4, 256)
    batch = {"tokens": tok, "labels": tok.roll(-1, 1), "segment_ids": seg,
             "positions": pos.contiguous()}
    leaves = [t.detach().requires_grad_(True)
              for t in tree_leaves(cast_params_for_compute(params))]
    loss, _ = model.loss(tree_unflatten(params, leaves), batch)
    grads = tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))
    deq, ef = GradCompressor(stochastic=False).apply(grads, None)
    for g, dq, e in zip(tree_leaves(grads), tree_leaves(deq), tree_leaves(ef)):
        g = g.float()  # half a step, and fp32's two roundings (chip_smoke QUANT_SLACK)
        scale = float(g.abs().max()) / 127.0
        assert float((g - dq).abs().max()) <= scale * (0.5 + 127 * 2.0 ** -22)
        assert torch.equal(e, g - dq)
    noisy = GradCompressor(stochastic=True)
    a, b = noisy.apply(grads, None), noisy.apply(grads, None)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a[0]), tree_leaves(b[0])))
    losses = {}
    for name, comp in (("compressed", GradCompressor(stochastic=False)), ("plain", None)):
        step = make_train_step(model, OptimizerConfig(decay_steps=100), compressor=comp)
        _, opt, met = step(params, init_opt_state(params), batch)
        losses[name] = float(met["loss"])
        assert ("ef" in opt) == (comp is not None)
    assert losses["compressed"] == losses["plain"]
    fwd = packed.launches_fwd
    argv = ["--arch", "olmo-1b", "--smoke", "--steps", "2", "--ckpt-dir", str(tmp_path)]
    meshed = train.run(train.parse_args(argv + ["--mesh", "local"]))
    plain = train.run(train.parse_args(argv + ["--mesh", "none",
                                               "--ckpt-dir", str(tmp_path / "none")]))
    assert meshed["mesh"] == {"data": 1, "model": 1}
    assert meshed["launches_fwd"] == plain["launches_fwd"] == 2 * 2 * cfg.n_layers
    assert packed.launches_fwd == fwd + 2 * 2 * 2 * cfg.n_layers
    assert abs(meshed["losses"][0] - plain["losses"][0]) <= 1e-6 * abs(plain["losses"][0])


# ---------------------------------------------------------------------------
# one train step of each newer family, trained route against plain route
# ---------------------------------------------------------------------------

# One train step of each family at smoke size, 2 rows of 256 tokens (two
# chunks of the scans), each row cut into two documents as phase 15 cuts
# them, through chip_smoke.py's own harness and limits (``_family_routes``,
# ``FT_LIMITS``, ``FT_LEAVES``): step 1's loss and named
# gradients, the trained route (the packed kernels; the scans in chunks of
# 128 under checkpoints) against the plain route (the plain flash path;
# each scan one chunk), the attention projections tempered (``_tempered``);
# a planted fault (a segment boundary dropped; the carry reset at the chunk
# boundary) must read above the limits, and the launches are held.
FAMILY_ARCHS = ("internvl2-1b", "jamba-v0.1-52b", "seamless-m4t-medium", "xlstm-125m")


def _chip_smoke():
    """chip_smoke.py, at the root of the checkout, as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_train_step_matches_its_plain_route_on_card(arch):
    _need_card()
    import contextlib
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model, make_batch

    cs = _chip_smoke()
    dev = torch.device("cuda")
    cfg = get_config(arch).smoke()
    if cfg.moe is not None:  # jamba: its first layer, a Mamba block and a dense MLP
        cfg = dataclasses.replace(cfg, n_layers=1, layer_pattern=cfg.pattern[:1])
    model = build_model(cfg)
    params = train.make_params(model, 0, dev)
    B, S = 2, 256
    if cfg.encdec:  # S frames and S tokens
        batch = cs._two_documents(torch, make_batch(cfg, "train", B, 2 * S, seed=1),
                                  cs._cuts(S, B), cs._cuts(S, B))
    else:
        text = cfg.frontend_tokens if cfg.frontend == "vision" else 0
        batch = cs._two_documents(torch, make_batch(cfg, "train", B, S, seed=1),
                                  [text + c for c in cs._cuts(S - text, B)])
    batch = {k: v.to(dev) for k, v in batch.items()}
    none = {"gmm": 0, "paged": 0, "packed": 0, "packed_bwd": 0}
    if arch in ("xlstm-125m", "jamba-v0.1-52b"):
        routes = ({"scan": cs._one_chunk}, {"scan": cs._carry_reset}, none)
        tempered = contextlib.nullcontext((params, None))
    else:
        n_attn = cfg.n_encoder_layers + 2 * cfg.n_layers if cfg.encdec else cfg.n_layers
        routes = ({"packed": cs._PlainPacked}, {"packed": cs._MergedSegments},
                  dict(none, packed=2 * n_attn, packed_bwd=n_attn))
        tempered = cs._tempered(params, None)
    dtype = torch.float32 if arch == "xlstm-125m" else torch.bfloat16
    with tempered as (params, _):
        readings, checks = cs._family_routes(torch, arch, model, params, batch, dtype,
                                             cs.FT_LEAVES[arch], *routes)
    assert all(checks.values()), (checks, readings)


# ---------------------------------------------------------------------------
# packed attention in float32 (the SIMT kernels), paged decode with a window
# ---------------------------------------------------------------------------

# The float32 kernels against the plain version's autograd in fp32: both
# compute in fp32 throughout and differ in the order of their sums only.
# The output is held elementwise to test_kernels' f32 TOLS; the output and
# gradients by rel_l2 (whole tensor, worst 64-row tile of a head) within
# F32_REL_L2, far under the planted faults of chip_smoke.py's phase 7
# (0.45 and above whole for delta = 0 in dQ).
F32_TOLS = dict(rtol=2e-5, atol=2e-5)
F32_REL_L2 = (1e-5, 1e-4)
# (S, H, KVH, D, window, causal): every head dim, GQA up to G = 8, a
# window, ragged lengths, non-causal
F32_CASES = [(256, 4, 4, 16, 0, True), (384, 4, 1, 32, 0, True), (300, 8, 2, 64, 0, True),
             (512, 16, 2, 128, 0, True), (640, 4, 2, 128, 192, True),
             (1000, 4, 4, 64, 0, False), (256, 14, 2, 64, 64, True),
             # ragged at D = 128 (rows past the last 128- and 64-row tile), and
             # a window at D = 16 narrower than a chunk
             (700, 8, 2, 128, 0, True), (333, 4, 1, 16, 40, True)]


def _f32_packed(case, seed=0):
    S, H, KVH, D, window, causal = case
    B = 2
    rng = np.random.default_rng(seed + S + H + D + window)

    def t(shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32, device="cuda")

    q, k, v, g = t((B, S, H, D)), t((B, S, KVH, D)), t((B, S, KVH, D)), t((B, S, H, D))
    seg_np = _packed_segments(rng, B, S)
    seg_np[0] = 1  # one document filling a row: full tiles
    return (q, k, v, g, torch.tensor(seg_np, device="cuda"), seg_np,
            dict(causal=causal, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_CASES, ids=lambda c: "x".join(map(str, c)))
def test_packed_f32_kernels_match_plain_on_card(case):
    _need_card()
    from repro_torch.kernels.packed_attention import ops as packed_ops
    from repro_torch.kernels.packed_attention.ref import rel_l2

    q, k, v, g, seg, _, kw = _f32_packed(case)
    before = (packed_ops.launches_fwd, packed_ops.launches_bwd)
    out, grads = _packed_run(lambda *a: packed_ops.packed_attention(*a, seg, seg, **kw),
                             q, k, v, g)
    torch.cuda.synchronize()
    assert (packed_ops.launches_fwd, packed_ops.launches_bwd) == (before[0] + 1,
                                                                  before[1] + 1)
    ref, ref_grads = _packed_run(
        lambda *a: packed_ops.packed_attention_plain(*a, seg, seg, **kw), q, k, v, g)
    torch.testing.assert_close(out, ref, **F32_TOLS)
    for name, a, b in zip(("out", "dq", "dk", "dv"), (out, *grads), (ref, *ref_grads),
                          strict=True):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        whole, tile = rel_l2(a, b)
        assert whole <= F32_REL_L2[0] and tile <= F32_REL_L2[1], (name, whole, tile)


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_CASES[2:5], ids=lambda c: "x".join(map(str, c)))
def test_packed_f32_kernels_census_and_repeat_on_card(case):
    """The float32 kernels class their tiles by the bf16 kernels' rule (the
    census equals ``ref.tile_schedule``'s count), write no residual, and
    repeat bitwise."""
    _need_card()
    from repro_torch.kernels.packed_attention import kernel as pk
    from repro_torch.kernels.packed_attention.ref import census_rule

    q, k, v, g, seg, seg_np, kw = _f32_packed(case, seed=1)
    H, KVH = q.shape[2], k.shape[2]
    pk.tile_census(on=True)
    out, lse, lo = pk.packed_flash_attention(q, k, v, seg, seg, residual=True, **kw)
    grads = pk.packed_flash_attention_bwd(q, k, v, seg, seg, out, lo, g, lse, **kw)
    census = pk.tile_census(on=False)
    assert lo.numel() == 0
    assert census == census_rule(torch.tensor(seg_np), torch.tensor(seg_np), H, KVH, **kw)
    out2, lse2 = pk.packed_flash_attention(q, k, v, seg, seg, **kw)
    grads2 = pk.packed_flash_attention_bwd(q, k, v, seg, seg, out2, lo, g, lse2, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2, strict=True))


@pytest.mark.cuda
def test_packed_f32_kernels_run_on_the_tensor_cores():
    """Each float32 kernel (forward, dK/dV, dQ) at every head dim runs its
    products on the tensor cores: the built library's SASS holds TF32
    warpgroup products (HGMMA.64xNx8.F32.TF32) in each."""
    _need_card()
    import re
    import shutil
    import subprocess

    from repro_torch.kernels.packed_attention import kernel as pk

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(pk.build())], capture_output=True,
                          text=True, check=True).stdout
    bodies = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, _, body = part.partition("\n")
        m = re.search(r"packed_attn_(fwd|dkdv|dq)_f32_kernelILi(\d+)E", name)
        if m:
            bodies[(m.group(1), int(m.group(2)))] = body
    for kind in ("fwd", "dkdv", "dq"):
        for D in pk.HEAD_DIMS:
            assert (kind, D) in bodies, (kind, D, sorted(bodies))
            assert re.search(r"HGMMA\.64x\d+x8\.F32\.TF32", bodies[(kind, D)]), (kind, D)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 7, 16, 17, 100, 5000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_with_a_window_on_card(dtype, window):
    """Each sequence's last ``window`` tokens: inside a page, a page, one
    past it, several pages, longer than every sequence; over the split
    boundaries of ``_split_inputs`` (length 0, a chunk and one past it, the
    table's capacity) with the window's plan, held to the plain version and
    to the split algorithm under the same plan.  Pages wholly before the
    window are never read: NaN there leaves the output as it is."""
    _need_card()
    args, _, _ = _split_inputs(4, 128, 16, dtype)
    q, kp, vp, table, lens = args
    elem = torch.tensor([], dtype=dtype).element_size()
    chunk, slots = paged_kernel.split_plan(elem, 128, 16, table.shape[1], table.shape[0],
                                           kp.shape[2], window)
    before = paged_ops.launches
    out = paged_ops.paged_attention(*args, window=window)
    torch.cuda.synchronize()
    assert paged_ops.launches == before + 1
    assert torch.isfinite(out).all() and (out[0] == 0).all()
    ref = paged_attention_ref(*args, window=window)
    torch.testing.assert_close(out.float(), ref.float(), **PAGED_TOLS[dtype])
    split = paged_attention_split_ref(*args, chunk, slots, window=window)
    torch.testing.assert_close(out.float(), split.float(), **PAGED_TOLS[dtype])
    # NaN in every page wholly before a sequence's window
    kn, vn = kp.clone(), vp.clone()
    for b, n in enumerate(lens.tolist()):
        for i in range(max(n - window, 0) // 16):
            if table[b, i] > 0:
                kn[table[b, i]] = float("nan")
                vn[table[b, i]] = float("nan")
    assert torch.equal(paged_ops.paged_attention(q, kn, vn, table, lens, window=window),
                       out)

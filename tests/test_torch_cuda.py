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

from repro_torch.kernels.grouped_matmul import ops
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.runtime import TorchPayload

# tests/test_kernels.py's shapes and tolerances, plus a ragged shape
SHAPES = [(4, 256, 128, 256), (2, 128, 256, 128), (8, 128, 64, 64),
          (3, 100, 70, 90)]
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

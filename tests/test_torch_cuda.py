"""The port's Hopper kernel against its plain version, on a CUDA card.

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

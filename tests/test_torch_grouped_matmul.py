"""The port's grouped matmul (``repro_torch.kernels.grouped_matmul``) against
the JAX package's.

On the CPU the port's ``gmm`` takes its plain PyTorch version; it is held to
the JAX Pallas kernel in interpret mode and to the JAX reference on the same
inputs, made with numpy from a seed, at ``tests/test_kernels.py``'s shapes
and tolerances.  The Hopper kernel itself runs only on a card
(``test_torch_cuda.py``); ``chip_smoke.py`` holds it to the plain version
there too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_matmul.kernel import grouped_matmul as jax_grouped_matmul
from repro.kernels.grouped_matmul.ops import gmm as jax_gmm
from repro.kernels.grouped_matmul.ref import grouped_matmul_ref as jax_ref
from repro_torch.kernels.grouped_matmul import kernel, ops
from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref

SHAPES = [(4, 256, 128, 256), (2, 128, 256, 128), (8, 128, 64, 64)]
TOLS = {
    "float32": dict(rtol=2e-4, atol=2e-4),
    "bfloat16": dict(rtol=5e-2, atol=5e-1),
}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(rng, E, C, d, f, gs, dtype):
    """The same packed inputs for both packages: zeros past ``gs`` (as the
    dispatch scatter leaves them), rounded to ``dtype`` once, in JAX."""
    x = rng.normal(size=(E, C, d)) * (
        np.arange(C)[None, :] < np.asarray(gs)[:, None])[..., None]
    w = rng.normal(size=(E, d, f))
    xj = jnp.asarray(x, JNP[dtype])
    wj = jnp.asarray(w, JNP[dtype])
    gj = jnp.asarray(gs, jnp.int32)
    # bf16 values are exact in f32, so this hands torch the same numbers
    xt = torch.from_numpy(np.array(xj, np.float32)).to(TORCH[dtype])
    wt = torch.from_numpy(np.array(wj, np.float32)).to(TORCH[dtype])
    gt = torch.from_numpy(np.asarray(gs, np.int32))
    return (xj, wj, gj), (xt, wt, gt)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("E,C,d,f", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_matches_jax_kernel_and_ref(E, C, d, f, dtype):
    rng = np.random.default_rng(0)
    gs = rng.integers(0, C + 1, size=E)
    (xj, wj, gj), (xt, wt, gt) = _inputs(rng, E, C, d, f, gs, dtype)
    out = ops.gmm(xt, wt, gt)
    assert out.dtype == TORCH[dtype] and out.shape == (E, C, f)
    kern = jax_gmm(xj, wj, gj, use_kernel=True, interpret=True)
    ref = jax_ref(xj, wj, gj)
    np.testing.assert_allclose(_f32(out), _f32(kern), **TOLS[dtype])
    np.testing.assert_allclose(_f32(out), _f32(ref), **TOLS[dtype])


def test_gmm_empty_bins_are_exactly_zero():
    rng = np.random.default_rng(1)
    E, C, d, f = 4, 128, 64, 64
    gs = [0, 0, 64, 0]
    (xj, wj, gj), (xt, wt, gt) = _inputs(rng, E, C, d, f, gs, "float32")
    out = ops.gmm(xt, wt, gt).numpy()
    assert np.abs(out[[0, 1, 3]]).max() == 0.0
    assert np.abs(out[2, 64:]).max() == 0.0
    kern = jax_grouped_matmul(xj, wj, gj, block_c=64, block_d=64, block_f=64,
                              interpret=True)
    np.testing.assert_allclose(out, np.asarray(kern), **TOLS["float32"])


def test_gmm_zeroes_padding_even_when_inputs_are_not_zero():
    """Rows past ``group_sizes`` are zero whatever the padding holds."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(3, 16, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 8, 4)).astype(np.float32))
    gs = torch.tensor([0, 5, 16], dtype=torch.int32)
    out = ops.gmm(x, w, gs)
    assert out[0].abs().max() == 0 and out[1, 5:].abs().max() == 0
    torch.testing.assert_close(out[2], x[2] @ w[2], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_ragged_shape_matches_jax_ref(dtype):
    """C, d, f that are no block multiple (the Hopper kernel masks them)."""
    rng = np.random.default_rng(3)
    E, C, d, f = 3, 100, 70, 90
    gs = [0, 37, 100]
    (xj, wj, gj), (xt, wt, gt) = _inputs(rng, E, C, d, f, gs, dtype)
    out = ops.gmm(xt, wt, gt)
    ref = jax_gmm(xj, wj, gj, use_kernel=False)
    np.testing.assert_allclose(_f32(out), _f32(ref), **TOLS[dtype])


def test_cpu_path_launches_nothing():
    rng = np.random.default_rng(4)
    _, (xt, wt, gt) = _inputs(rng, 2, 8, 4, 4, [8, 3], "float32")
    before = ops.launches
    ops.gmm(xt, wt, gt)
    assert ops.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never falls back to the plain version."""
    x = torch.zeros(2, 8, 4)
    w = torch.zeros(2, 4, 4)
    gs = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.grouped_matmul(x, w, gs)


def test_kernel_build_is_pinned_to_hopper():
    assert "arch=compute_90a,code=sm_90a" in kernel.NVCC_FLAGS
    assert kernel.SOURCE.is_file()
    assert kernel.BUILD_DIR.parts[-2:] == ("build", "repro_torch")


def test_ref_matches_jax_ref_on_random_group_sizes():
    rng = np.random.default_rng(5)
    for _ in range(4):
        E, C, d, f = (int(v) for v in rng.integers(1, 24, size=4))
        gs = rng.integers(0, C + 1, size=E)
        (xj, wj, gj), (xt, wt, gt) = _inputs(rng, E, C, d, f, gs, "float32")
        np.testing.assert_allclose(
            grouped_matmul_ref(xt, wt, gt).numpy(), np.asarray(jax_ref(xj, wj, gj)),
            **TOLS["float32"],
        )

"""The port's paged decode attention (plain version, on the CPU) against the
JAX package's reference and its Pallas kernel in interpret mode.

Inputs are made with numpy and handed to both packages.  Tolerances are
``tests/test_kernels.py``'s ``TOLS``: the port sums in another order than
JAX does, and in bf16 the output is rounded once on both sides.  The Hopper
kernel itself runs only on a card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import paged_decode_attention
from repro.kernels.paged_attention.ops import (
    page_table_from_allocator as jax_page_table_from_allocator,
)
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_ref
from repro.serving.kv_cache import PageAllocator as JaxPageAllocator
from repro.serving.kv_cache import PagedCacheLayout as JaxLayout
from repro_torch.kernels.paged_attention import kernel, ops
from repro_torch.kernels.paged_attention.ref import gather_pages, paged_attention_ref
from repro_torch.serving.kv_cache import PageAllocator, PagedCacheLayout

TOLS = {"float32": dict(rtol=2e-5, atol=2e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def scatter_pages(rng, lens, num_pages, page_size):
    """tests/test_kernels.py's page tables: a permutation dealt to rows."""
    max_pages = max(-(-l // page_size) for l in lens) + 1
    perm = rng.permutation(num_pages)
    pt = np.full((len(lens), max_pages), -1, np.int32)
    off = 0
    for b, l in enumerate(lens):
        n = -(-l // page_size)
        pt[b, :n] = perm[off:off + n]
        off += n
    return pt


def both(arrays, dtype):
    """The same numpy inputs as JAX arrays and torch tensors of one dtype
    (the page table and lengths stay int32)."""
    jx, tx = [], []
    for a in arrays:
        if a.dtype == np.int32:
            jx.append(jnp.asarray(a))
            tx.append(torch.from_numpy(a))
        else:
            jx.append(jnp.asarray(a, JNP[dtype]))
            tx.append(torch.from_numpy(a.astype(np.float32)).to(TORCH[dtype]))
    return jx, tx


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("H,KVH", [(8, 2), (4, 4), (16, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_matches_jax_ref_and_kernel(H, KVH, dtype):
    rng = np.random.default_rng(0)
    B, D, num_pages, page_size = 3, 64, 48, 16
    lens = [37, 5, 100]
    q = rng.normal(size=(B, H, D))
    kp = rng.normal(size=(num_pages, page_size, KVH, D))
    vp = rng.normal(size=(num_pages, page_size, KVH, D))
    pt = scatter_pages(rng, lens, num_pages, page_size)
    sl = np.asarray(lens, np.int32)
    jx, tx = both([q, kp, vp, pt, sl], dtype)
    out = ops.paged_attention(*tx)
    assert out.dtype == TORCH[dtype] and out.shape == (B, H, D)
    np.testing.assert_allclose(f32(out), f32(jax_ref(*jx)), **TOLS[dtype])
    np.testing.assert_allclose(
        f32(out), f32(paged_decode_attention(*jx, interpret=True)), **TOLS[dtype])


def test_paged_attention_from_allocator():
    """The port's First-Fit allocator gives JAX's page tables, op for op,
    and the attention over them matches JAX's kernel and reference."""
    rng = np.random.default_rng(1)
    KVH, D, page_size = 2, 32, 8
    layout = dict(num_pages=64, page_size=page_size, n_kv_heads=KVH,
                  head_dim=D, max_pages_per_seq=16)
    alloc, jalloc = PageAllocator(PagedCacheLayout(**layout)), \
        JaxPageAllocator(JaxLayout(**layout))
    for a in (alloc, jalloc):
        for sid, n in {10: 25, 11: 7, 12: 64}.items():
            assert a.allocate(sid, n) is not None
        a.free(11)
        a.allocate(13, 30)  # reuses freed low pages (fragmented table)
        a.extend(10, 9)
    seq_ids = [10, 12, 13]
    pt, sl = ops.page_table_from_allocator(alloc, seq_ids)
    jpt, jsl = jax_page_table_from_allocator(jalloc, seq_ids)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jpt))
    np.testing.assert_array_equal(sl.numpy(), np.asarray(jsl))
    assert pt.dtype == sl.dtype == torch.int32
    assert alloc.highest_used_page() == jalloc.highest_used_page()
    assert alloc.utilization() == jalloc.utilization()

    B, H = len(seq_ids), 4
    q = rng.normal(size=(B, H, D))
    kp = rng.normal(size=(64, page_size, KVH, D))
    vp = rng.normal(size=(64, page_size, KVH, D))
    jx, tx = both([q, kp, vp], "float32")
    out = ops.paged_attention(*tx, pt, sl)
    np.testing.assert_allclose(
        f32(out), f32(paged_decode_attention(*jx, jpt, jsl, interpret=True)),
        **TOLS["float32"])
    np.testing.assert_allclose(f32(out), f32(jax_ref(*jx, jpt, jsl)),
                               **TOLS["float32"])


@pytest.mark.parametrize("fill", [99.0, float("nan")])
def test_paged_attention_ignores_stale_pages(fill):
    """What unreferenced pages hold, NaN included, cannot reach the output.
    Page 0 counts as referenced: a -1 entry reads it."""
    rng = np.random.default_rng(2)
    B, H, KVH, D, page_size = 1, 4, 2, 32, 8
    lens = [20]
    kp = torch.from_numpy(rng.normal(size=(32, page_size, KVH, D)).astype(np.float32))
    vp = torch.from_numpy(rng.normal(size=(32, page_size, KVH, D)).astype(np.float32))
    pt = torch.from_numpy(scatter_pages(rng, lens, 32, page_size))
    sl = torch.tensor(lens, dtype=torch.int32)
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
    out1 = ops.paged_attention(q, kp, vp, pt, sl)
    used = set(pt.flatten().tolist()) - {-1} | {0}
    unused = [p for p in range(32) if p not in used]
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[unused] = fill
    vp2[unused] = -fill
    out2 = ops.paged_attention(q, kp2, vp2, pt, sl)
    np.testing.assert_array_equal(out1.numpy(), out2.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_zero_length_row_is_zero(dtype):
    rng = np.random.default_rng(3)
    B, H, KVH, D, num_pages, page_size = 3, 8, 2, 64, 16, 4
    lens = [9, 0, 4]
    q = rng.normal(size=(B, H, D))
    kp = rng.normal(size=(num_pages, page_size, KVH, D))
    vp = rng.normal(size=(num_pages, page_size, KVH, D))
    pt = scatter_pages(rng, [max(n, 1) for n in lens], num_pages, page_size)
    sl = np.asarray(lens, np.int32)
    jx, tx = both([q, kp, vp, pt, sl], dtype)
    out = ops.paged_attention(*tx)
    assert (out[1] == 0).all()
    np.testing.assert_allclose(f32(out), f32(jax_ref(*jx)), **TOLS[dtype])


def test_minus_one_inside_the_live_range_reads_page_zero():
    rng = np.random.default_rng(4)
    KVH, D, page_size = 2, 16, 4
    pool = torch.from_numpy(rng.normal(size=(8, page_size, KVH, D)).astype(np.float32))
    table = torch.tensor([[3, -1, 5]], dtype=torch.int32)
    dense = gather_pages(pool, table)
    torch.testing.assert_close(dense[0, 4:8], pool[0])
    torch.testing.assert_close(dense[0, 8:12], pool[5])


def test_cpu_path_launches_nothing():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(2, 4, 16)).astype(np.float32))
    kp = torch.from_numpy(rng.normal(size=(4, 4, 2, 16)).astype(np.float32))
    pt = torch.tensor([[0, 1], [2, -1]], dtype=torch.int32)
    sl = torch.tensor([7, 3], dtype=torch.int32)
    before = ops.launches
    want = paged_attention_ref(q, kp, kp, pt, sl)
    torch.testing.assert_close(ops.paged_attention(q, kp, kp, pt, sl), want)
    assert ops.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never falls back to the plain version."""
    q = torch.zeros(1, 4, 16)
    kp = torch.zeros(2, 4, 2, 16)
    pt = torch.zeros(1, 2, dtype=torch.int32)
    sl = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.paged_decode_attention(q, kp, kp, pt, sl)


def test_kernel_build_is_pinned_to_hopper():
    from repro_torch.kernels.nvcc import BUILD_DIR, NVCC_FLAGS

    assert "arch=compute_90a,code=sm_90a" in NVCC_FLAGS
    assert kernel.SOURCE.is_file()
    assert BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    src = kernel.SOURCE.read_text()
    assert "_paged_attn_kernel" in src  # names the TPU kernel it replaces
    assert "#include <torch" not in src and "cudnn" not in src.lower()

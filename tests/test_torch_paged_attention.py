"""The port's paged decode attention (plain version, on the CPU) against the
JAX package's reference and its Pallas kernel in interpret mode.

Inputs are made with numpy and handed to both packages.  Tolerances are
``tests/test_kernels.py``'s ``TOLS``: the port sums in another order than
JAX does, and in bf16 the output is rounded once on both sides.  The Hopper
kernel itself runs only on a card (``tests/test_torch_cuda.py``).
"""

import ast
import importlib.util
from pathlib import Path

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
from repro_torch.kernels.paged_attention.ref import (
    gather_pages,
    paged_attention_ref,
    paged_attention_split_ref,
)
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


# ---------------------------------------------------------------------------
# the kernel's split-KV algorithm (ref.paged_attention_split_ref) and the
# host's split plan
# ---------------------------------------------------------------------------


def _split_case(rng, chunk_pages, slots):
    """Five sequences over a 6-slot table of 4-token pages: length 0, one
    that ends exactly on a split boundary, one a token past a split
    boundary, one with a -1 inside its live range, one filling the table;
    NaN in every page no entry refers to (page 0 counts as referenced: -1
    reads it)."""
    B, H, KVH, D, page_size, num_pages, max_pages = 5, 8, 2, 32, 4, 40, 6
    full = max_pages * page_size
    chunk = chunk_pages * page_size
    # 4 chunks' worth of pages, dealt in runs of ceil(4 / slots): the
    # first split ends at `boundary`, and the sequence ends on a split end
    per = -(-min(4, -(-max_pages // chunk_pages)) // slots)
    boundary = min(per * chunk, full)
    lens = [0, min(4 * chunk, full) if per * slots == 4 else boundary,
            min(boundary + 1, full), 17, full]
    perm = rng.permutation(np.arange(1, num_pages))
    table = np.full((B, max_pages), -1, np.int32)
    off = 0
    for b, n in enumerate(lens):
        k = -(-n // page_size)
        table[b, :k] = perm[off:off + k]
        off += k
    table[3, 2] = -1  # inside row 3's live range: reads page 0
    referenced = set(table[table >= 0].tolist()) | {0}
    q = rng.normal(size=(B, H, D))
    kp = rng.normal(size=(num_pages, page_size, KVH, D))
    vp = rng.normal(size=(num_pages, page_size, KVH, D))
    return [q, kp, vp, table, np.asarray(lens, np.int32)], referenced


# (chunk_pages, slots): splits of 1 page, of several pages, of all pages
@pytest.mark.parametrize("chunk_pages,slots", [(1, 6), (1, 2), (2, 2), (6, 1), (1, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_ref_matches_ref_and_jax(chunk_pages, slots, dtype):
    rng = np.random.default_rng(6)
    arrays, referenced = _split_case(rng, chunk_pages, slots)
    jx, tx = both(arrays, dtype)
    want_jax = f32(jax_ref(*jx))
    want = paged_attention_ref(*tx)
    unreferenced = [p for p in range(tx[1].shape[0]) if p not in referenced]
    for pool in tx[1:3]:
        pool[unreferenced] = float("nan")
    out = paged_attention_split_ref(*tx, chunk_pages, slots)
    assert out.dtype == TORCH[dtype] and torch.isfinite(out).all()
    assert (out[0] == 0).all()  # length 0
    np.testing.assert_allclose(f32(out), f32(want), **TOLS[dtype])
    np.testing.assert_allclose(f32(out), want_jax, **TOLS[dtype])


def test_split_ref_with_the_kernels_plan_matches_ref():
    """At a width whose plan gives several slots of several-page chunks."""
    rng = np.random.default_rng(7)
    B, H, KVH, D, page_size, num_pages, max_pages = 3, 16, 4, 64, 8, 96, 30
    chunk, slots = kernel.split_plan(4, D, page_size, max_pages, B, KVH)
    assert chunk > 1 and 1 < slots < max_pages
    lens = [chunk * page_size * 2, 5, max_pages * page_size - 3]
    table = np.full((B, max_pages), -1, np.int32)
    perm = rng.permutation(num_pages)
    off = 0
    for b, n in enumerate(lens):
        k = -(-n // page_size)
        table[b, :k] = perm[off:off + k]
        off += k
    arrays = [rng.normal(size=(B, H, D)), rng.normal(size=(num_pages, page_size, KVH, D)),
              rng.normal(size=(num_pages, page_size, KVH, D)), table,
              np.asarray(lens, np.int32)]
    jx, tx = both(arrays, "float32")
    out = paged_attention_split_ref(*tx, chunk, slots)
    np.testing.assert_allclose(f32(out), f32(paged_attention_ref(*tx)), **TOLS["float32"])
    np.testing.assert_allclose(f32(out), f32(jax_ref(*jx)), **TOLS["float32"])


def test_launch_plan_reads_no_values():
    """The plan comes from shapes and element sizes: on meta tensors, which
    hold no values (reading one raises), it is the plan of real ones."""
    shapes = ((8, 32, 128), (1024, 16, 8, 128), (8, 128))
    meta = [torch.empty(s, dtype=torch.bfloat16, device="meta") for s in shapes[:2]]
    table = torch.empty(shapes[2], dtype=torch.int32, device="meta")
    with pytest.raises(Exception):
        table.tolist()
    plan = kernel.launch_plan(*meta, table)
    assert plan == kernel.launch_plan(torch.zeros(shapes[0], dtype=torch.bfloat16),
                                      torch.zeros(shapes[1], dtype=torch.bfloat16),
                                      torch.zeros(shapes[2], dtype=torch.int32))
    # the serving decode shape: 4-page chunks, 8 slots, 512 blocks
    assert plan[:2] == (4, 8)
    assert plan[2] == kernel.shared_bytes(2, 4, 128, 16, 4) <= kernel.MAX_SHARED


@pytest.mark.parametrize("elem,D,page_size,max_pages,B,KVH", [
    (2, 128, 16, 128, 8, 8), (4, 128, 16, 128, 8, 8), (4, 256, 32, 5, 5, 1),
    (2, 64, 8, 1, 1, 1), (2, 8, 16, 4096, 64, 8), (4, 256, 8, 300, 1000, 16)])
def test_split_plan_covers_the_table_within_budget(elem, D, page_size, max_pages, B, KVH):
    chunk, slots = kernel.split_plan(elem, D, page_size, max_pages, B, KVH)
    page = 2 * page_size * (D * elem + 16)  # a page's K and V rows in shared memory
    assert chunk >= 1 and slots >= 1
    assert chunk == 1 or chunk * page <= kernel.CHUNK_BYTES < (chunk + 1) * page
    assert slots <= -(-max(max_pages, 1) // chunk)  # no slot without a chunk
    # the card holds every block at once, and no fewer than it can
    resident = kernel.SLOTS_PER_SM * kernel.SMS
    assert slots == 1 or B * KVH * slots <= resident
    assert slots == -(-max(max_pages, 1) // chunk) or B * KVH * (slots + 1) > resident


def test_kernel_ab_tool_resolves_the_chip_smoke_names_it_uses():
    """``tools/kernel_ab.py`` borrows ``chip_smoke``'s phase-4 and phase-6
    inputs, timing and yardsticks as ``cs.<name>``: each must exist there."""
    root = Path(__file__).resolve().parents[1]

    def load(path):
        spec = importlib.util.spec_from_file_location(path.stem, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    tool_path = root / "tools" / "kernel_ab.py"
    tool = load(tool_path)
    assert callable(tool.main) and callable(tool.child)
    names = {node.attr for node in ast.walk(ast.parse(tool_path.read_text()))
             if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
             and node.value.id == "cs"}
    assert {"_decode_inputs", "_sdpa_yardstick", "_paged_bound", "_payload_inputs",
            "_bmm_yardstick", "_bound", "_time_ms"} <= names
    chip_smoke = load(root / "chip_smoke.py")
    assert not [n for n in sorted(names) if not hasattr(chip_smoke, n)]


def test_kernel_variants_tool_edits_apply_to_the_committed_sources():
    """``tools/kernel_variants.py`` builds its variants by text edits of the
    committed kernel sources: each edit must find its text there, and the
    ``chip_smoke`` names it borrows must exist."""
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "kernel_variants", root / "tools" / "kernel_variants.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    from repro_torch.kernels.grouped_matmul.kernel import SOURCE as GMM_SOURCE

    for source, variants in ((GMM_SOURCE, tool.GMM_VARIANTS),
                             (kernel.SOURCE, tool.PAGED_PARTS)):
        text = source.read_text()
        for name, edits in variants.items():
            assert all(old in text for old, _ in edits), name
    names = {node.attr for node in ast.walk(ast.parse(
        (root / "tools" / "kernel_variants.py").read_text()))
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
        and node.value.id == "cs"}
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert names and not [n for n in sorted(names) if not hasattr(cs, n)]

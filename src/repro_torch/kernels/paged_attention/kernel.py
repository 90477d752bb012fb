"""Build and bind the Hopper paged-decode-attention kernel
(``csrc/paged_attention.cu``).

The source is compiled on first use (``kernels/nvcc.py``) and loaded with
``ctypes``: pointers and the stream cross as ``ctypes.c_void_p``.  Nothing
GPU-specific happens at import, so CPU-only hosts import this module too.

The kernel splits each sequence's pages across blocks and combines the
splits inside the same launch (see the source's header).  ``split_plan``
picks the split from the shapes (and the sliding window) alone, so a call
never reads ``seq_lens`` on the host.
"""

from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ..nvcc import build_library

__all__ = ["build", "paged_decode_attention", "split_plan", "launch_plan",
           "window_pages", "shared_bytes", "SOURCE", "MAX_G", "MAX_D"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
MAX_G, MAX_D = 16, 256           # the kernel's register plan
MAX_SHARED = 227 * 1024          # a block's shared memory on an H100
CHUNK_BYTES = 36 * 1024          # a chunk's K and V rows; two chunks in flight
SLOTS_PER_SM = 4                 # blocks planned per SM (3 fit at once)
SMS = 132                        # an H100 SXM's SMs
_MAX_GRID_Y = 65535

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# (device index, stream) -> (counters, workspace); see paged_decode_attention
_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _row_bytes(elem_bytes: int, D: int) -> int:
    """One token's row in shared memory: D elements padded by 16 bytes."""
    return D * elem_bytes + 16


def shared_bytes(elem_bytes: int, G: int, D: int, page_size: int,
                 chunk_pages: int) -> int:
    """A block's shared memory, as the kernel lays it out
    (``paged_attention.cu``: ``shared_bytes``)."""
    ts = chunk_pages * page_size
    return 4 * ts * _row_bytes(elem_bytes, D) + (G * D + G * ts + 3 * G) * 4 + 4


def window_pages(page_size: int, max_pages: int, window: int) -> int:
    """The most table slots a sequence's attention reads: the whole table,
    or with a window (> 0) the pages ``window`` tokens can touch, which
    start anywhere in a page."""
    if window <= 0:
        return max_pages
    return min(max_pages, (window + page_size - 2) // page_size + 1)


def split_plan(elem_bytes: int, D: int, page_size: int, max_pages: int,
               B: int, KVH: int, window: int = 0) -> Tuple[int, int]:
    """``(chunk_pages, slots)`` for a call, from its shapes alone.

    A chunk is the whole pages whose K and V rows fit ``CHUNK_BYTES`` (at
    least one page); a block holds two chunks in flight.  Each (sequence,
    KV head) gets ``slots`` blocks, ``SLOTS_PER_SM`` per SM over all
    ``B * KVH`` pairs, and no more than the table has chunks.  Three
    blocks fit an SM at once at ``CHUNK_BYTES``; planning four lets the
    blocks of short sequences, which finish early, hand their place to
    waiting ones (both constants from a sweep at the serving decode shape
    on an H100, PERF.md).  The kernel deals a sequence's live chunks to its
    slots in contiguous runs, from its length, which only the card reads:
    a decode step must not wait for ``seq_lens`` on the host.  With a
    ``window`` the chunks cover the window's pages only
    (``window_pages``), from its first.
    """
    chunk = max(1, CHUNK_BYTES // (2 * page_size * _row_bytes(elem_bytes, D)))
    chunks = max(1, -(-window_pages(page_size, max_pages, window) // chunk))
    slots = max(1, min(chunks, SLOTS_PER_SM * SMS // max(B * KVH, 1)))
    return chunk, slots


def build() -> Path:
    """Compile the kernel if this source has no library yet; return its path."""
    return build_library(SOURCE)


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            for fn in (lib.paged_attn_f32, lib.paged_attn_bf16):
                fn.argtypes = ([ptr] * 6 + [i32] * 7 + [ctypes.c_float]
                               + [i32] * 3 + [ptr] * 3)
                fn.restype = i32
            lib.paged_attn_shared_bytes.argtypes = [i32] * 5
            lib.paged_attn_shared_bytes.restype = ctypes.c_size_t
            lib.paged_attn_error_string.argtypes = [i32]
            lib.paged_attn_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


_ENTRY = {torch.float32: "paged_attn_f32", torch.bfloat16: "paged_attn_bf16"}


def paged_decode_attention(
    q: torch.Tensor,           # (B, H, D) one query token per sequence
    k_pool: torch.Tensor,      # (num_pages, page_size, KVH, D)
    v_pool: torch.Tensor,      # (num_pages, page_size, KVH, D)
    page_table: torch.Tensor,  # (B, max_pages) int32, -1 = unused slot
    seq_lens: torch.Tensor,    # (B,) int32
    window: int = 0,           # > 0: each sequence's last `window` tokens only
) -> torch.Tensor:
    """Launch the kernel on the current stream; return ``(B, H, D)`` in
    ``q.dtype``.  Raises on any input it does not take and on a launch the
    driver refuses; it never falls back to the plain version.  An empty
    output launches nothing.

    The splits of a sequence meet through a workspace of fp32 partials and
    a counter per (sequence, KV head) that the kernel leaves at 0.  Both
    are kept per (device, stream) and reused by the next call on that
    stream, which runs after this one: calls on two streams at once get
    two sets and never share a counter.
    """
    named = (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
             ("page_table", page_table), ("seq_lens", seq_lens))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not all(t.device == q.device for _, t in named):
        raise ValueError("all inputs must be on one device")
    if q.dtype not in _ENTRY or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(
            "q and the pools must all be float32 or all bfloat16, got "
            f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError(
            f"page_table and seq_lens must be int32, got {page_table.dtype}, "
            f"{seq_lens.dtype}")
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            f"want q (B, H, D) and two pools (P, page_size, KVH, D), got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    B, H, D = q.shape
    num_pages, page_size, KVH, Dk = k_pool.shape
    if (Dk != D or page_table.dim() != 2 or page_table.shape[0] != B
            or tuple(seq_lens.shape) != (B,)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, pools {tuple(k_pool.shape)}, "
            f"page_table {tuple(page_table.shape)}, seq_lens {tuple(seq_lens.shape)}")
    if H % KVH:
        raise ValueError(f"H = {H} is not a multiple of KVH = {KVH}")
    G = H // KVH
    if G > MAX_G or D > MAX_D or D % 8:
        raise ValueError(
            f"the kernel takes G <= {MAX_G} and D <= {MAX_D} with D % 8 == 0, "
            f"got G = {G}, D = {D}")
    if B > _MAX_GRID_Y:
        raise ValueError(f"at most {_MAX_GRID_Y} sequences per launch, got {B}")
    if num_pages == 0 or page_size == 0:
        raise ValueError("the pools hold no page")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("q and the pools must be 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    chunk, slots, smem = launch_plan(q, k_pool, page_table, window)
    if smem > MAX_SHARED:
        raise ValueError(
            f"one page of {page_size} tokens at D = {D}, G = {G} needs {smem} "
            f"bytes of shared memory, over {MAX_SHARED}")
    lib = _library()
    entry = getattr(lib, _ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream()
        counters = workspace = None
        if slots > 1:
            counters, workspace = _scratch_for(
                q.device, stream, B * KVH, B * KVH * slots * G * (D + 2))
        code = entry(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            B, H, KVH, D, num_pages, page_size, page_table.shape[1], 1.0 / math.sqrt(D),
            chunk, slots, max(int(window), 0),
            None if workspace is None else workspace.data_ptr(),
            None if counters is None else counters.data_ptr(),
            stream.cuda_stream,
        )
    if code != 0:
        raise RuntimeError(
            f"paged-attention launch failed: "
            f"{lib.paged_attn_error_string(code).decode()}")
    return out


def launch_plan(q: torch.Tensor, k_pool: torch.Tensor, page_table: torch.Tensor,
                window: int = 0) -> Tuple[int, int, int]:
    """``(chunk_pages, slots, shared bytes)`` of a call, from the shapes,
    the window and the element size of its inputs: no value is read."""
    B, H, D = q.shape
    page_size, KVH = k_pool.shape[1], k_pool.shape[2]
    chunk, slots = split_plan(q.element_size(), D, page_size, page_table.shape[1],
                              B, KVH, window)
    return chunk, slots, shared_bytes(q.element_size(), H // KVH, D, page_size, chunk)


def _scratch_for(device: torch.device, stream: torch.cuda.Stream, n_counters: int,
                 n_floats: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """This stream's (zeroed counters, workspace), grown to the sizes asked.
    A new counter buffer is zeroed on the same stream, before the launch."""
    key = (device.index, stream.cuda_stream)
    with _lock:
        counters, workspace = _scratch.get(key, (None, None))
        if counters is None or counters.numel() < n_counters:
            counters = torch.zeros(n_counters, dtype=torch.int32, device=device)
        if workspace is None or workspace.numel() < n_floats:
            workspace = torch.empty(n_floats, dtype=torch.float32, device=device)
        _scratch[key] = counters, workspace
    return counters, workspace

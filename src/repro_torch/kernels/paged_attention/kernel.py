"""Build and bind the Hopper paged-decode-attention kernel
(``csrc/paged_attention.cu``).

The source is compiled on first use (``kernels/nvcc.py``) and loaded with
``ctypes``: pointers and the stream cross as ``ctypes.c_void_p``.  Nothing
GPU-specific happens at import, so CPU-only hosts import this module too.
"""

from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path
from typing import Optional

import torch

from ..nvcc import build_library

__all__ = ["build", "paged_decode_attention", "SOURCE", "MAX_G", "MAX_D"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
MAX_G, MAX_D = 16, 256           # the kernel's register and shared-memory plan
MAX_SHARED = 227 * 1024          # a block's shared memory on an H100
_MAX_GRID_Y = 65535

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


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
                fn.argtypes = [ptr] * 6 + [i32] * 7 + [ctypes.c_float, ptr]
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
) -> torch.Tensor:
    """Launch the kernel on the current stream; return ``(B, H, D)`` in
    ``q.dtype``.  Raises on any input it does not take and on a launch the
    driver refuses; it never falls back to the plain version.  An empty
    output launches nothing.
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
    lib = _library()
    max_pages = page_table.shape[1]
    smem = lib.paged_attn_shared_bytes(q.element_size(), G, D, page_size, max_pages)
    if smem > MAX_SHARED:
        raise ValueError(
            f"page_size {page_size} and {max_pages} table slots at D = {D}, "
            f"G = {G} need {smem} bytes of shared memory, over {MAX_SHARED}")
    entry = getattr(lib, _ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        code = entry(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            B, H, KVH, D, num_pages, page_size, max_pages,
            1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream,
        )
    if code != 0:
        raise RuntimeError(
            f"paged-attention launch failed: "
            f"{lib.paged_attn_error_string(code).decode()}")
    return out

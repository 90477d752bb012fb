"""Build and bind the Hopper packed-flash-attention kernels
(``csrc/packed_attention.cu``): the forward, and the backward that computes
dQ, dK and dV from the forward's output, its residual and row
logsumexps.  The forward writes that residual (``out_lo``, in bf16) only
when asked (``residual``: a backward will follow), and the backward
takes its delta = rowsum(dO * O) from ``out + out_lo``, which holds the
fp32 output to about 2^-16 of it, as the JAX package's gradient takes
delta from its fp32 output.  (The fp32 output there is the one whose
weights, P rounded to bf16 for P.V, are renormalised to sum to one:
``csrc/packed_attention.cu``'s header says why.)  They take
bf16 tensors (the training and serving dtype), with the softmax and every
sum in fp32, or fp32 tensors (the float32 entries: every product as
3xTF32 on the tensor cores, each operand split into two TF32 parts, at
every head dim, the same tile schedule, no residual: the backward takes
delta from the fp32 output itself; ``ref.packed_attention_tf32`` models
their arithmetic); mixed or other dtypes raise.  In bf16, at head dims 64
and 128 they are warp-specialised: a producer warpgroup streams tiles by
TMA into a ring of shared-memory stages, two consumer warpgroups run the
products as ``wgmma``; at head dims 16 and 32 (the ``.smoke()`` configs)
they run ``mma.sync`` on 64 x 64 tiles.  The plain version (``ref.py``) is the CPU
path and the oracle on the card; ``ref.tile_schedule`` is their rule for
which tiles they skip and which they compute without a mask, and
``tile_census`` counts the classes the D = 64 and 128 kernels gave their
tiles, to hold the two to each other.

Both take the model's layout, q ``(B, Sq, H, D)`` and k, v ``(B, Skv, KVH,
D)`` with KV head ``h // (H // KVH)`` indexed in the kernel (never
repeated), and need no padding: ragged tails read as zeros of segment 0.
At D = 64 and 128 a block keeps its tile schedule in shared memory, a byte
per tile in range: on an H100 at D = 128 a row of more than about 8.5 million keys
(the forward) or 4 million queries (dK/dV) does not fit, and the launch
raises (the float32 kernels at D = 128, beside their fp32 tiles: 229
thousand keys in the forward, 245 thousand in dQ, 106 thousand queries in
dK/dV).
The source is compiled on first use (``kernels/nvcc.py``) and loaded with
``ctypes``; nothing GPU-specific happens at import, so CPU-only hosts import
this module too.
"""

from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ..nvcc import build_library

__all__ = ["build", "packed_flash_attention", "packed_flash_attention_bwd",
           "tile_census", "SOURCE", "HEAD_DIMS", "DTYPES", "CENSUS_KERNELS",
           "CENSUS_CLASSES"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "packed_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)   # the kernels' template instances
DTYPES = (torch.bfloat16, torch.float32)
_MAX_GRID_YZ = 65535
# the tile census's kernels and classes, in the library's order
# (``ref.KERNEL_TILES`` gives each kernel's tiles)
CENSUS_KERNELS = ("forward", "dk/dv", "dq")
CENSUS_CLASSES = ("skipped", "masked", "full")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile the kernels if this source has no library yet; return its path."""
    return build_library(SOURCE)


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.packed_attn_fwd.argtypes = [ptr] * 8 + [i32] * 9 + [ctypes.c_float, ptr]
            lib.packed_attn_fwd.restype = i32
            lib.packed_attn_bwd.argtypes = [ptr] * 13 + [i32] * 8 + [ctypes.c_float, ptr]
            lib.packed_attn_bwd.restype = i32
            lib.packed_attn_fwd_f32.argtypes = [ptr] * 7 + [i32] * 8 + [ctypes.c_float, ptr]
            lib.packed_attn_fwd_f32.restype = i32
            lib.packed_attn_bwd_f32.argtypes = [ptr] * 12 + [i32] * 8 + [ctypes.c_float, ptr]
            lib.packed_attn_bwd_f32.restype = i32
            lib.packed_attn_tile_census.argtypes = [i32, ptr]
            lib.packed_attn_tile_census.restype = i32
            lib.packed_attn_error_string.argtypes = [i32]
            lib.packed_attn_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           seg_q: torch.Tensor, seg_kv: torch.Tensor,
           **extra: torch.Tensor) -> Tuple[int, int, int, int, int, int]:
    """Raise on any input the kernels do not take; return the shape."""
    named = (("q", q), ("k", k), ("v", v), ("segment_ids_q", seg_q),
             ("segment_ids_kv", seg_kv), *extra.items())
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if not all(t.device == q.device for _, t in named):
        raise ValueError("all inputs must be on one device")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in DTYPES:
        raise TypeError(f"the kernels take q, k, v all bfloat16 or all float32, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if seg_q.dtype != torch.int32 or seg_kv.dtype != torch.int32:
        raise TypeError(f"segment ids must be int32, got {seg_q.dtype}, {seg_kv.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, Sq, H, D) and k, v (B, Skv, KVH, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    _, Skv, KVH, Dk = k.shape
    if (k.shape[0] != B or Dk != D or tuple(seg_q.shape) != (B, Sq)
            or tuple(seg_kv.shape) != (B, Skv)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, segment ids "
            f"{tuple(seg_q.shape)}, {tuple(seg_kv.shape)}")
    if KVH == 0 or H % KVH:
        raise ValueError(f"H = {H} is not a multiple of KVH = {KVH}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernels take head dims {HEAD_DIMS}, got {D}")
    if max(H, B) > _MAX_GRID_YZ:
        raise ValueError(f"at most {_MAX_GRID_YZ} heads and rows, got H={H}, B={B}")
    for name, t in extra.items():
        if t.dtype != (torch.float32 if name == "lse" else q.dtype):
            raise TypeError(f"{name} has dtype {t.dtype}")
    return B, Sq, Skv, H, KVH, D


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"packed-attention {what} launch failed: "
                           f"{_library().packed_attn_error_string(code).decode()}")


def tile_census(on: bool) -> Dict[str, Dict[str, int]]:
    """The tiles the bf16 kernels at D = 64 and 128 and the float32 kernels
    at every D of the current CUDA device have
    classed since the last call, per kernel (``CENSUS_KERNELS``) and class
    (``CENSUS_CLASSES``), summed over blocks: a head's (query tile, key
    tile) pair counts once per head in the forward and dQ and once per KV
    head in dK/dV.  Zeroes the counts, then turns counting on or off (off
    by default).  Synchronises with the device."""
    counts = (ctypes.c_ulonglong * (len(CENSUS_KERNELS) * len(CENSUS_CLASSES)))()
    _raise_on(_library().packed_attn_tile_census(int(on), counts), "tile census")
    n = len(CENSUS_CLASSES)
    return {kern: dict(zip(CENSUS_CLASSES, counts[i * n:(i + 1) * n]))
            for i, kern in enumerate(CENSUS_KERNELS)}


def packed_flash_attention(
    q: torch.Tensor,               # (B, Sq, H, D)
    k: torch.Tensor,               # (B, Skv, KVH, D)
    v: torch.Tensor,               # (B, Skv, KVH, D)
    segment_ids_q: torch.Tensor,   # (B, Sq) int32, 0 = padding
    segment_ids_kv: torch.Tensor,  # (B, Skv) int32
    *,
    causal: bool = True,
    window: int = 0,
    residual: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Launch the forward on the current stream.

    Returns ``out`` (B, Sq, H, D) in q's dtype and ``lse`` (B, H, Sq) fp32,
    each row's logsumexp of its scaled visible scores (+inf for a row that
    sees no key); with ``residual``, also ``out_lo``: in bf16 a (B, Sq, H,
    D) tensor, the fp32 output less ``out`` (rounded), which the backward
    takes; in fp32 an empty tensor (``out`` is the fp32 output, and nothing
    more is written).  Without it the launch writes nothing more.
    Raises on any input it does not take and on a launch CUDA refuses;
    it never falls back to the plain version.
    """
    B, Sq, Skv, H, KVH, D = _check(q, k, v, segment_ids_q, segment_ids_kv)
    f32 = q.dtype == torch.float32
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    out_lo = (q.new_empty(0) if f32 else torch.empty_like(q)) if residual else None
    if out.numel():
        lib = _library()
        with torch.cuda.device(q.device):
            ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids_q.data_ptr(),
                    segment_ids_kv.data_ptr(), out.data_ptr())
            stream = torch.cuda.current_stream().cuda_stream
            if f32:
                code = lib.packed_attn_fwd_f32(
                    *ptrs, lse.data_ptr(), B, Sq, Skv, H, KVH, D, int(causal), int(window),
                    1.0 / math.sqrt(D), stream)
            else:
                code = lib.packed_attn_fwd(
                    *ptrs, out_lo.data_ptr() if residual else None, lse.data_ptr(), B, Sq,
                    Skv, H, KVH, D, int(causal), int(window), int(residual),
                    1.0 / math.sqrt(D), stream)
        _raise_on(code, "forward")
    return (out, lse, out_lo) if residual else (out, lse)


def packed_flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids_q: torch.Tensor,
    segment_ids_kv: torch.Tensor,
    out: torch.Tensor,             # the forward's output
    out_lo: torch.Tensor,          # its residual (``residual=True``; empty in fp32)
    dout: torch.Tensor,            # the gradient of the loss by out
    lse: torch.Tensor,             # the forward's (B, H, Sq) logsumexps
    *,
    causal: bool = True,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward on the current stream: (dq, dk, dv) in the
    inputs' dtype and layouts.  Three kernels run: delta = rowsum(dO *
    (out + out_lo)) in fp32, then dK/dV and dQ.  (An ``out_lo`` of zeros
    takes delta from the bf16 output alone.)  In fp32 ``out_lo`` is the
    forward's empty one and delta = rowsum(dO * out)."""
    B, Sq, Skv, H, KVH, D = _check(q, k, v, segment_ids_q, segment_ids_kv,
                                   out=out, out_lo=out_lo, dout=dout, lse=lse)
    f32 = q.dtype == torch.float32
    if (out.shape != q.shape or out_lo.shape != ((0,) if f32 else q.shape)
            or dout.shape != q.shape or tuple(lse.shape) != (B, H, Sq)):
        raise ValueError(f"out {tuple(out.shape)}, out_lo {tuple(out_lo.shape)}, dout "
                         f"{tuple(dout.shape)} and lse {tuple(lse.shape)} do not match "
                         f"q {tuple(q.shape)} (out_lo is empty in float32)")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids_q.data_ptr(),
                segment_ids_kv.data_ptr(), out.data_ptr())
        tail = (dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, H, KVH, D, int(causal),
                int(window), 1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
        if f32:
            code = lib.packed_attn_bwd_f32(*head, *tail)
        else:
            code = lib.packed_attn_bwd(*head, out_lo.data_ptr(), *tail)
    _raise_on(code, "backward")
    return dq, dk, dv

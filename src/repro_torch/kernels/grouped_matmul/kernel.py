"""Build and bind the Hopper grouped-matmul kernel (``csrc/grouped_matmul.cu``).

The source is compiled on first use (``kernels/nvcc.py``) and loaded with
``ctypes``: pointers and the stream cross as ``ctypes.c_void_p``.  Nothing
GPU-specific happens at import, so CPU-only hosts import this module too.

Two paths, picked by ``path`` from the dtype, the shapes and the pointers
(never from ``group_sizes``): bf16 that TMA can take runs on the tensor
cores (TMA + ``wgmma``, fp32 accumulators); f32 and the bf16 edge cases run
the SIMT kernel, f32 in full fp32 on the CUDA cores (never TF32), so that
the kernel agrees with the fp32 reference ``ref.grouped_matmul_ref``.
``tile_census`` counts what the tensor-core path skipped, to hold it to
``ref.tile_census``, whose default tile is the source's 128 x 256.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ..nvcc import BUILD_DIR, NVCC_FLAGS, build_library

__all__ = ["build", "grouped_matmul", "path", "tile_census",
           "BUILD_DIR", "NVCC_FLAGS", "SOURCE", "CENSUS_KEYS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "grouped_matmul.cu"
# the tile census's counts, in the library's order
CENSUS_KEYS = ("zero_tiles", "halves_computed", "halves_skipped", "simt_calls")

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
            for fn in (lib.gmm_f32, lib.gmm_bf16, lib.gmm_bf16_tma):
                fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
                fn.restype = i32
            lib.gmm_tile_census.argtypes = [i32, ptr]
            lib.gmm_tile_census.restype = i32
            lib.gmm_error_string.argtypes = [i32]
            lib.gmm_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


_ENTRY = {(torch.float32, "simt"): "gmm_f32", (torch.bfloat16, "simt"): "gmm_bf16",
          (torch.bfloat16, "tma"): "gmm_bf16_tma"}
_MAX_GRID_Z = 65535


def path(dtype: torch.dtype, d: int, f: int, *pointers: int) -> str:
    """``"tma"`` (the tensor-core kernel) or ``"simt"`` for a call of this
    dtype, contraction ``d`` and width ``f`` on these data pointers (x, w
    and out): TMA takes bf16 rows of whole 16-byte units (``d`` and ``f``
    multiples of 8) from 16-byte aligned arrays; f32 always takes the SIMT
    kernel.  The library's ``tma_takes`` is the same rule."""
    if dtype != torch.bfloat16:
        return "simt"
    whole = d > 0 and f > 0 and d % 8 == 0 and f % 8 == 0
    return "tma" if whole and all(p % 16 == 0 for p in pointers) else "simt"


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(
            f"grouped-matmul {what} failed: {_library().gmm_error_string(code).decode()}")


def tile_census(on: bool) -> Dict[str, int]:
    """What the kernel counted since the last call (``CENSUS_KEYS``): the
    tensor-core path's tiles written as zeros, its 64-row halves computed
    and skipped, and the bf16 calls that took the SIMT path.  Zeroes the
    counts, then turns counting on or off (off by default: the launches
    then take the instance compiled without the counters).  Synchronises
    with the device."""
    counts = (ctypes.c_ulonglong * len(CENSUS_KEYS))()
    _raise_on(_library().gmm_tile_census(int(on), counts), "tile census")
    return dict(zip(CENSUS_KEYS, counts))


def grouped_matmul(
    x: torch.Tensor,            # (E, C, d) f32 or bf16, CUDA, contiguous
    w: torch.Tensor,            # (E, d, f) same type
    group_sizes: torch.Tensor,  # (E,) int32
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None,
) -> torch.Tensor:
    """Launch the kernel on the current stream; return ``(E, C, f)`` in
    ``x.dtype``.  Raises on any input it does not take and on a launch the
    driver refuses; it never falls back to the other path or to the plain
    version.

    ``events``, a ``(start, end)`` pair of timing CUDA events, are recorded
    on the launch stream just before and just after the launch, so their
    elapsed time leaves out the checks and the allocation above.  An empty
    output launches nothing and records neither.
    """
    for name, t in (("x", x), ("w", w), ("group_sizes", group_sizes)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(
            f"x and w must both be float32 or bfloat16, got {x.dtype}, {w.dtype}"
        )
    if group_sizes.dtype != torch.int32:
        raise TypeError(f"group_sizes must be int32, got {group_sizes.dtype}")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x and w must be 3-D, got {tuple(x.shape)}, {tuple(w.shape)}")
    E, C, d = x.shape
    if w.shape[0] != E or w.shape[1] != d or tuple(group_sizes.shape) != (E,):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"group_sizes {tuple(group_sizes.shape)}"
        )
    if E > _MAX_GRID_Z:
        raise ValueError(f"at most {_MAX_GRID_Z} experts per launch, got {E}")
    if not (x.device == w.device == group_sizes.device):
        raise ValueError("x, w and group_sizes must be on one device")
    f = w.shape[2]
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _library()
    which = path(x.dtype, d, f, x.data_ptr(), w.data_ptr(), out.data_ptr())
    entry = getattr(lib, _ENTRY[x.dtype, which])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream()
        if events is not None:
            events[0].record(stream)
        code = entry(
            x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
            out.data_ptr(), E, C, d, f, stream.cuda_stream,
        )
        if events is not None:
            events[1].record(stream)
    _raise_on(code, f"launch ({which} path)")
    return out

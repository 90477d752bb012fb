"""Build and bind the Hopper grouped-matmul kernel (``csrc/grouped_matmul.cu``).

The source is compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/repro_torch/`` at
the repository root, named by a hash of the source, and loaded with
``ctypes``: pointers and the stream cross as ``ctypes.c_void_p``.  Nothing
GPU-specific happens at import, so CPU-only hosts import this module too.

f32 inputs are multiplied in full fp32 on the CUDA cores (never TF32), so
the kernel agrees with the fp32 reference ``ref.grouped_matmul_ref``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

__all__ = ["build", "grouped_matmul", "BUILD_DIR", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "grouped_matmul.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the grouped-matmul kernel cannot be built")


def build() -> Path:
    """Compile the kernel if this source has no library yet; return its path.

    The library is written under a temporary name and renamed into place,
    so processes that build at once never load a half-written file.
    """
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libgrouped_matmul_{digest}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    return lib_path


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            for fn in (lib.gmm_f32, lib.gmm_bf16):
                fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
                fn.restype = i32
            lib.gmm_error_string.argtypes = [i32]
            lib.gmm_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


_ENTRY = {torch.float32: "gmm_f32", torch.bfloat16: "gmm_bf16"}
_MAX_GRID_Z = 65535


def grouped_matmul(
    x: torch.Tensor,            # (E, C, d) f32 or bf16, CUDA, contiguous
    w: torch.Tensor,            # (E, d, f) same type
    group_sizes: torch.Tensor,  # (E,) int32
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None,
) -> torch.Tensor:
    """Launch the kernel on the current stream; return ``(E, C, f)`` in
    ``x.dtype``.  Raises on any input it does not take and on a launch the
    driver refuses; it never falls back to the plain version.

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
    if x.dtype not in _ENTRY or w.dtype != x.dtype:
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
    entry = getattr(lib, _ENTRY[x.dtype])
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
    if code != 0:
        raise RuntimeError(
            f"grouped-matmul launch failed: {lib.gmm_error_string(code).decode()}"
        )
    return out

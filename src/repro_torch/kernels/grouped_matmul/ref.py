"""Plain PyTorch version of the expert-blocked grouped matmul.

The CPU path of ``ops.gmm`` and the oracle the Hopper kernel is held to on
the card; and ``tile_census``, the tensor-core path's occupancy skip
counted from ``group_sizes`` alone, which the kernel's own census must
equal.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["grouped_matmul_ref", "tile_census"]


def grouped_matmul_ref(
    x: torch.Tensor,            # (E, C, d) capacity-packed expert inputs
    w: torch.Tensor,            # (E, d, f) per-expert weights
    group_sizes: torch.Tensor,  # (E,) valid rows per expert bin
) -> torch.Tensor:
    """Per-expert GEMM over the occupied prefix of each capacity bin.

    Rows at or past ``group_sizes[e]`` are padding; they are zeroed
    explicitly so the kernel's tile skip is pinned down exactly.  The
    product runs in full fp32 (no TF32) and is cast back to ``x.dtype``.
    """
    C = x.shape[1]
    out = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    rows = torch.arange(C, device=x.device)
    valid = rows[None, :] < group_sizes.to(x.device)[:, None]  # (E, C)
    return torch.where(valid[..., None], out, 0.0).to(x.dtype)


def tile_census(
    group_sizes: torch.Tensor,  # (E,) valid rows per expert bin
    C: int,                     # rows per bin
    f: int,                     # output columns
    BM: int = 128,              # rows of an output tile: two halves of BM / 2
    BN: int = 256,              # columns of an output tile
) -> Dict[str, int]:
    """The tensor-core path's tiles over ``(E, C, f)`` outputs, each counted
    once per column tile: ``zero_tiles``, whose first row is at or past the
    bin's size ``g`` (written as zeros, nothing loaded); and, in the other
    tiles, ``halves_computed``, the 64-row halves whose first row is below
    ``g``, and ``halves_skipped``, the rest (no copy, no product)."""
    half = BM // 2
    g = group_sizes.to(torch.int64).clamp(0, C)[:, None]  # (E, 1)
    row0 = torch.arange(0, C, BM, dtype=torch.int64)[None, :]  # (1, row tiles)
    computed_tile = row0 < g
    live_halves = ((g - row0 + half - 1) // half).clamp(0, 2)
    col_tiles = -(-f // BN)
    return {
        "zero_tiles": int((~computed_tile).sum()) * col_tiles,
        "halves_computed": int(live_halves[computed_tile].sum()) * col_tiles,
        "halves_skipped": int((2 - live_halves)[computed_tile].sum()) * col_tiles,
    }

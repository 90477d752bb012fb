"""Plain PyTorch version of the expert-blocked grouped matmul.

The CPU path of ``ops.gmm`` and the oracle the Hopper kernel is held to on
the card.
"""

from __future__ import annotations

import torch

__all__ = ["grouped_matmul_ref"]


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

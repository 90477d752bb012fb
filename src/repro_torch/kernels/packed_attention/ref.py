"""Plain PyTorch version of packed flash attention.

Dense masked attention in fp32: the CPU path of ``ops.packed_attention``
and the oracle the Hopper kernels are held to on the card.  Its autograd is
the plain version of the backward kernel.  ``rel_l2`` is the error measure
the kernels are held to by it.
"""

from __future__ import annotations

import math

import torch

__all__ = ["packed_attention_ref", "rel_l2"]


def packed_attention_ref(
    q: torch.Tensor,               # (B, H, Sq, D)
    k: torch.Tensor,               # (B, H, Skv, D)  (KV heads pre-repeated)
    v: torch.Tensor,               # (B, H, Skv, D)
    segment_ids_q: torch.Tensor,   # (B, Sq) int32, 0 = padding
    segment_ids_kv: torch.Tensor,  # (B, Skv)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    q_ids = torch.arange(Sq, device=q.device)[:, None]
    kv_ids = torch.arange(Skv, device=q.device)[None, :]
    mask = (segment_ids_q[:, :, None] == segment_ids_kv[:, None, :]) & (
        segment_ids_kv[:, None, :] != 0)
    if causal:
        mask &= (q_ids >= kv_ids)[None]
    if window > 0:
        mask &= (q_ids - kv_ids < window)[None]
    s = s.masked_fill(~mask[:, None], -torch.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)  # fully-masked rows -> zero output
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def rel_l2(got: torch.Tensor, want: torch.Tensor, block: int = 64):
    """(||got - want|| / ||want||, the same ratio's largest value over the
    blocks of ``block`` rows along dim 1 and one head along dim 2), in fp32.

    For (B, S, H, D) tensors the blocks are the kernels' 64-row tiles, so an
    error confined to one tile of one head shows at its own scale, however
    small the tile's entries are beside the tensor's largest.  A block whose
    reference is all zero reads 0 if ``got`` is zero there too, else inf.
    ``block=0`` gives the whole tensor's ratio twice (for tensors of other
    layouts, such as weight gradients).
    """
    err, ref = (got.float() - want.float()), want.float()

    def ratio(e2: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
        return torch.where(r2 > 0, (e2 / torch.where(r2 > 0, r2, 1.0)).sqrt(),
                           torch.where(e2 > 0, torch.inf, 0.0))

    whole = ratio(err.square().sum(), ref.square().sum()).item()
    if block == 0:
        return whole, whole
    B, S = err.shape[:2]
    pad = (-S) % block
    err, ref = err.reshape(B, S, err.shape[2], -1), ref.reshape(B, S, ref.shape[2], -1)
    if pad:
        err = torch.nn.functional.pad(err, (0, 0, 0, 0, 0, pad))
        ref = torch.nn.functional.pad(ref, (0, 0, 0, 0, 0, pad))
    shape = (B, (S + pad) // block, block, err.shape[2], err.shape[3])
    blocks = ratio(err.reshape(shape).square().sum((2, 4)),
                   ref.reshape(shape).square().sum((2, 4)))
    return whole, blocks.max().item()

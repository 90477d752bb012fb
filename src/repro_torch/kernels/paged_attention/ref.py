"""Plain PyTorch version of paged decode attention.

Gathers each sequence's pages into a dense KV view and runs masked decode
attention in fp32: the CPU path of ``ops.paged_attention`` and the oracle
the Hopper kernel is held to on the card.
"""

from __future__ import annotations

import math

import torch

__all__ = ["paged_attention_ref", "gather_pages"]


def gather_pages(
    pool: torch.Tensor,        # (num_pages, page_size, KVH, D)
    page_table: torch.Tensor,  # (B, max_pages) int32, -1 = unused
) -> torch.Tensor:
    """Dense (B, max_pages * page_size, KVH, D) view of the paged cache.

    Unused table slots (-1) gather page 0; the caller masks by seq_lens, so
    the garbage never contributes.
    """
    idx = page_table.long().clamp(min=0)  # (B, P)
    gathered = pool[idx]                  # (B, P, ps, KVH, D)
    B, P, ps, KVH, D = gathered.shape
    return gathered.reshape(B, P * ps, KVH, D)


def paged_attention_ref(
    q: torch.Tensor,           # (B, H, D) one query token per sequence
    k_pool: torch.Tensor,      # (num_pages, page_size, KVH, D)
    v_pool: torch.Tensor,      # (num_pages, page_size, KVH, D)
    page_table: torch.Tensor,  # (B, max_pages) int32, -1 = unused
    seq_lens: torch.Tensor,    # (B,) valid tokens per sequence
) -> torch.Tensor:
    B, H, D = q.shape
    KVH = k_pool.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(D)

    k = gather_pages(k_pool, page_table).float()  # (B, S, KVH, D)
    v = gather_pages(v_pool, page_table).float()
    S = k.shape[1]

    qf = q.reshape(B, KVH, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k) * scale         # (B, KVH, G, S)
    valid = torch.arange(S, device=q.device)[None, :] < seq_lens.to(q.device)[:, None]
    s = torch.where(valid[:, None, None, :], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)  # a row of length 0 gives 0
    out = torch.einsum("bhgk,bkhd->bhgd", p, v)
    return out.reshape(B, H, D).to(q.dtype)

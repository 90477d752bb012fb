"""Plain PyTorch version of paged decode attention.

Gathers each sequence's pages into a dense KV view and runs masked decode
attention in fp32, over each sequence's tokens or the last ``window`` of
them: the CPU path of ``ops.paged_attention`` and the oracle
the Hopper kernel is held to on the card.  ``paged_attention_split_ref`` is
the kernel's algorithm in PyTorch: fp32 partials per split of pages, then
the same in-order combine.
"""

from __future__ import annotations

import math

import torch

__all__ = ["paged_attention_ref", "paged_attention_split_ref", "gather_pages"]


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
    window: int = 0,           # > 0: the last `window` tokens only
) -> torch.Tensor:
    """Token t of sequence b is seen if t < seq_lens[b] and, with a window,
    t >= seq_lens[b] - window (the JAX package's decode mask)."""
    B, H, D = q.shape
    KVH = k_pool.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(D)

    k = gather_pages(k_pool, page_table).float()  # (B, S, KVH, D)
    v = gather_pages(v_pool, page_table).float()
    S = k.shape[1]

    qf = q.reshape(B, KVH, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k) * scale         # (B, KVH, G, S)
    t = torch.arange(S, device=q.device)[None, :]
    lens = seq_lens.to(q.device)[:, None]
    valid = t < lens
    if window > 0:
        valid &= t >= lens - window
    s = torch.where(valid[:, None, None, :], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)  # a row of length 0 gives 0
    out = torch.einsum("bhgk,bkhd->bhgd", p, v)
    return out.reshape(B, H, D).to(q.dtype)


def paged_attention_split_ref(
    q: torch.Tensor,           # (B, H, D) one query token per sequence
    k_pool: torch.Tensor,      # (num_pages, page_size, KVH, D)
    v_pool: torch.Tensor,      # (num_pages, page_size, KVH, D)
    page_table: torch.Tensor,  # (B, max_pages) int32, -1 = unused
    seq_lens: torch.Tensor,    # (B,) valid tokens per sequence
    chunk_pages: int,
    slots: int,
    window: int = 0,
) -> torch.Tensor:
    """The kernel's split-KV algorithm (``csrc/paged_attention.cu``).

    A sequence's ``ceil(len / page_size)`` live table slots, from the
    window's first page ``max(len - window, 0) // page_size`` (the first
    slot without a window), make chunks of ``chunk_pages`` pages, dealt to
    at most ``slots`` splits in contiguous runs of ``per = ceil(chunks /
    slots)``; a sequence of length 0 has one (empty) split.  Each split
    gives fp32 partials over its tokens under ``len`` (and at or after
    ``len - window``): its max m, its sum of weights l = sum exp(s - m) and
    acc = sum exp(s - m) v.  They are combined one split after another: M =
    max m_s, out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s,
    1e-30).
    """
    B, H, D = q.shape
    page_size, KVH = k_pool.shape[1], k_pool.shape[2]
    G = H // KVH
    max_pages = page_table.shape[1]
    lens = seq_lens.to(q.device).long().clamp(min=0)
    n_live = torch.clamp((lens + page_size - 1) // page_size, max=max_pages)
    live = torch.minimum(lens, n_live * page_size)                  # (B,)
    first = (lens - window).clamp(min=0) if window > 0 else torch.zeros_like(lens)
    p0 = torch.minimum(first // page_size, n_live)                  # the window's first page
    n_chunks = (n_live - p0 + chunk_pages - 1) // chunk_pages
    per = torch.clamp((n_chunks + slots - 1) // slots, min=1)
    n_splits = torch.clamp((n_chunks + per - 1) // per, min=1)

    k = gather_pages(k_pool, page_table).float()  # (B, S, KVH, D)
    v = gather_pages(v_pool, page_table).float()
    S = k.shape[1]
    qf = q.reshape(B, KVH, G, D).float()
    sc = torch.einsum("bhgd,bthd->bhgt", qf, k) / math.sqrt(D)     # (B, KVH, G, S)
    t = torch.arange(S, device=q.device)
    valid = (t[None, :] < live[:, None]) & (t[None, :] >= first[:, None])  # (B, S)
    split_of = (t[None, :] // page_size - p0[:, None]).clamp(min=0) // chunk_pages // per[:, None]

    M = torch.full((B, KVH, G), -torch.inf, device=q.device)
    L = torch.zeros((B, KVH, G), device=q.device)
    acc = torch.zeros((B, KVH, G, D), device=q.device)
    partials = []
    for s in range(slots):
        mask = (valid & (split_of == s))[:, None, None, :]           # (B, 1, 1, S)
        sc_s = torch.where(mask, sc, -torch.inf)
        m = sc_s.amax(-1)                                            # (B, KVH, G)
        p = torch.where(mask, torch.exp(sc_s - m[..., None]), 0.0)
        v_s = torch.where(mask[:, 0, 0, :, None, None], v, 0.0)
        partials.append((m, p.sum(-1), torch.einsum("bhgt,bthd->bhgd", p, v_s)))
        live_s = (s < n_splits)[:, None, None] & (p.sum(-1) > 0)
        M = torch.where(live_s, torch.maximum(M, m), M)
    for s, (m, l, a) in enumerate(partials):  # in split order
        w = torch.where((s < n_splits)[:, None, None] & (l > 0), torch.exp(m - M), 0.0)
        L = L + w * l
        acc = acc + w[..., None] * a
    out = acc / torch.clamp(L, min=1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)

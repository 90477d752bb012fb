"""Public wrapper for paged decode attention: the Hopper kernel for CUDA
tensors, the plain PyTorch version for CPU tensors, and the bridge from the
host-side First-Fit ``PageAllocator`` to the page tables they read.

On DTensors ``paged_attention`` runs shard-locally when only the batch
dim and the heads (q's and the pools' KV heads over the same mesh dims)
are sharded (``kernels/shard_local.py``), and raises on any other layout.

A tensor that does not lie on the CPU goes through the operator
``repro_torch::paged_attention`` (``kernels/custom_ops.py``): the kernel on
the card, a fake that does no work on meta stand-ins.  Its work is the
PERF.md bound's (4 H D FLOPs and each K and V row once per token) over
every token the page table can hold, or with a sliding window over
``min(table tokens, window)`` a sequence: the formula sees shapes, not the
sequences' lengths.

``launches`` counts the kernel launches this process made through
``paged_attention``; a run resets it to 0 and reads it back to show that
its decode path went through the kernel.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import torch

from ..custom_ops import define, nbytes
from ..shard_local import any_dtensor, shard_local
from ...serving.kv_cache import PageAllocator
from .kernel import paged_decode_attention
from .ref import paged_attention_ref

__all__ = ["paged_attention", "page_table_from_allocator", "launches"]

launches = 0
_count_lock = threading.Lock()


def _launch(q, k_pool, v_pool, page_table, seq_lens, window: int) -> torch.Tensor:
    global launches
    out = paged_decode_attention(q, k_pool, v_pool, page_table, seq_lens, window)
    if out.numel():  # an empty output launches nothing
        with _count_lock:
            launches += 1
    return out


def _table_tokens(page_table_shape, k_pool_shape, window: int) -> int:
    """The tokens the page table can hold, each sequence's cut to the
    window: the dense count of the tokens the kernel reads."""
    per_seq = page_table_shape[1] * k_pool_shape[1]
    if window > 0:
        per_seq = min(per_seq, window)
    return page_table_shape[0] * per_seq


def _flops(q_shape, k_shape, v_shape, table_shape, lens_shape, window, *args,
           out_shape=None, **kwargs) -> int:
    _, H, D = q_shape
    return 4 * _table_tokens(table_shape, k_shape, window) * H * D  # q.K and p.V


def _moved(q, k_pool, v_pool, page_table, seq_lens, window, out) -> float:
    KVH, D = k_pool.shape[2], k_pool.shape[3]
    kv = (2 * _table_tokens(page_table.shape, k_pool.shape, window) * KVH * D
          * k_pool.element_size())
    return kv + nbytes(q, page_table, seq_lens, out)


_PAGED = define(
    "paged_attention",
    "(Tensor q, Tensor k_pool, Tensor v_pool, Tensor page_table, Tensor seq_lens, "
    "int window) -> Tensor",
    cuda=_launch, cpu=paged_attention_ref, fake=lambda q, *_: torch.empty_like(q),
    flops=_flops, moved=_moved)


def page_table_from_allocator(
    allocator: PageAllocator,
    seq_ids: List[int],
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(page_table, seq_lens) int32 tensors on ``device`` for ``seq_ids``."""
    table = torch.from_numpy(allocator.page_table(seq_ids))
    lens = torch.tensor([allocator.seq_len(s) for s in seq_ids], dtype=torch.int32)
    return table.to(device), lens.to(device)


def paged_attention(
    q: torch.Tensor,           # (B, H, D)
    k_pool: torch.Tensor,      # (num_pages, page_size, KVH, D)
    v_pool: torch.Tensor,      # (num_pages, page_size, KVH, D)
    page_table: torch.Tensor,  # (B, max_pages) int32, -1 = unused
    seq_lens: torch.Tensor,    # (B,) int32
    *,
    window: int = 0,           # > 0: each sequence's last `window` tokens only
) -> torch.Tensor:
    """Decode attention over the paged pools (see ``ref.paged_attention_ref``).

    A CUDA tensor launches the kernel or raises; only a tensor that lies on
    the CPU takes the plain version.
    """
    if any_dtensor(q, k_pool, v_pool, page_table, seq_lens):
        return shard_local(
            "paged_attention", lambda *a: paged_attention(*a, window=window),
            [("q", q, "bh."), ("k_pool", k_pool, "..h."), ("v_pool", v_pool, "..h."),
             ("page_table", page_table, "b."), ("seq_lens", seq_lens, "b")], "bh.")
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, page_table, seq_lens, window)
    return _PAGED(q, k_pool, v_pool, page_table, seq_lens, int(window))

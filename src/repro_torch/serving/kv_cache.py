"""Paged KV cache with a First-Fit page allocator.

HBM pages are the serving-side *bins*: the KV cache is a pool of
fixed-size pages; each sequence owns a page list recorded in a page table.
Allocation is First-Fit over the free list (lowest-index free page first),
which keeps live pages dense at the low end of the pool — the exact analogue
of the paper's Fig. 3, where the packing concentrates load on low-index
workers so the high-index tail can be released (here: handed back, or
defragmented away when a replica scales down).

The page tables are consumed by ``kernels/paged_attention`` (the Hopper
kernel, or its plain PyTorch version on the CPU) through
``ops.page_table_from_allocator``; the allocator itself is host-side
bookkeeping, exactly like the IRM living on the master node.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional

import numpy as np

__all__ = ["PageAllocator", "PagedCacheLayout"]


@dataclasses.dataclass(frozen=True)
class PagedCacheLayout:
    """Static geometry of the paged cache pool."""

    num_pages: int
    page_size: int          # tokens per page
    n_kv_heads: int
    head_dim: int
    max_pages_per_seq: int

    @property
    def tokens_capacity(self) -> int:
        return self.num_pages * self.page_size

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)


class PageAllocator:
    """First-Fit (lowest-index) page allocation with per-sequence tables."""

    def __init__(self, layout: PagedCacheLayout):
        self.layout = layout
        self._free: List[int] = list(range(layout.num_pages))
        heapq.heapify(self._free)
        self._owned: Dict[int, List[int]] = {}   # seq_id -> page list
        self._lengths: Dict[int, int] = {}       # seq_id -> token count
        self.peak_pages_used = 0

    # ---- queries ------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.layout.num_pages - len(self._free)

    def utilization(self) -> float:
        """Token-level utilization of allocated pages (packing efficiency)."""
        if not self._owned:
            return 0.0
        used_tokens = sum(self._lengths.values())
        return used_tokens / (self.used_pages * self.layout.page_size)

    def highest_used_page(self) -> int:
        """Max live page index + 1 (the 'bins in use' watermark, Fig. 10)."""
        top = -1
        for pages in self._owned.values():
            if pages:
                top = max(top, max(pages))
        return top + 1

    def can_fit(self, n_tokens: int) -> bool:
        return self.layout.pages_for(n_tokens) <= len(self._free)

    def seq_pages(self, seq_id: int) -> List[int]:
        return list(self._owned.get(seq_id, ()))

    def seq_len(self, seq_id: int) -> int:
        return self._lengths.get(seq_id, 0)

    # ---- allocation -----------------------------------------------------------
    def allocate(self, seq_id: int, n_tokens: int) -> Optional[List[int]]:
        """Allocate pages for a new sequence; None if it doesn't fit."""
        if seq_id in self._owned:
            raise KeyError(f"sequence {seq_id} already allocated")
        need = self.layout.pages_for(max(1, n_tokens))
        if need > len(self._free) or need > self.layout.max_pages_per_seq:
            return None
        pages = [heapq.heappop(self._free) for _ in range(need)]
        self._owned[seq_id] = pages
        self._lengths[seq_id] = n_tokens
        self.peak_pages_used = max(self.peak_pages_used, self.used_pages)
        return list(pages)

    def extend(self, seq_id: int, n_new_tokens: int = 1) -> Optional[List[int]]:
        """Grow a sequence; returns newly allocated pages (possibly empty)."""
        if seq_id not in self._owned:
            raise KeyError(f"sequence {seq_id} not allocated")
        old_len = self._lengths[seq_id]
        new_len = old_len + n_new_tokens
        have = len(self._owned[seq_id])
        need = self.layout.pages_for(new_len)
        if need > self.layout.max_pages_per_seq:
            return None
        fresh: List[int] = []
        while have + len(fresh) < need:
            if not self._free:
                return None  # pool exhausted: caller must evict/preempt
            fresh.append(heapq.heappop(self._free))
        self._owned[seq_id].extend(fresh)
        self._lengths[seq_id] = new_len
        self.peak_pages_used = max(self.peak_pages_used, self.used_pages)
        return fresh

    def free(self, seq_id: int) -> int:
        """Release a sequence's pages back to the free list."""
        pages = self._owned.pop(seq_id, [])
        self._lengths.pop(seq_id, None)
        for p in pages:
            heapq.heappush(self._free, p)
        return len(pages)

    # ---- page-table export ------------------------------------------------------
    def page_table(self, seq_ids: List[int]) -> np.ndarray:
        """(len(seq_ids), max_pages_per_seq) int32 table; -1 = unused slot."""
        t = np.full((len(seq_ids), self.layout.max_pages_per_seq), -1, np.int32)
        for row, sid in enumerate(seq_ids):
            pages = self._owned.get(sid, [])
            t[row, : len(pages)] = pages
        return t

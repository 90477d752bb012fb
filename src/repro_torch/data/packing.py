"""First-Fit sequence packing — the paper's technique in the data pipeline.

Documents are *items* (size = token count), fixed-length training rows are
*bins* (capacity = seq_len).  The online First-Fit packer fills rows from a
document stream exactly the way the IRM fills workers with PEs: lowest-index
open row that fits, new row only when none fits.  Packing efficiency (real
tokens / row capacity) is the data-pipeline analogue of the paper's 90-100%
worker utilization, and is benchmarked against the no-packing baseline
(one document per row) in ``benchmarks/packing_throughput.py``.

Emitted batches carry ``segment_ids`` (1..k per row, 0 = padding) and
within-segment ``positions``; the attention layers (and the
``kernels/packed_attention`` Hopper kernels) mask across segment boundaries,
so packed training is loss-equivalent to unpacked training.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

__all__ = ["PackedBatch", "SequencePacker", "pack_documents", "packing_efficiency"]


@dataclasses.dataclass
class PackedBatch:
    tokens: np.ndarray       # (B, S) int32
    labels: np.ndarray       # (B, S) int32, -1 where masked
    segment_ids: np.ndarray  # (B, S) int32, 0 = padding
    positions: np.ndarray    # (B, S) int32, within-segment

    @property
    def real_tokens(self) -> int:
        return int((self.segment_ids > 0).sum())

    @property
    def capacity(self) -> int:
        return int(self.tokens.size)


class _Row:
    """One open bin: a training row being filled with documents."""

    __slots__ = ("docs", "used", "capacity")

    def __init__(self, capacity: int):
        self.docs: List[np.ndarray] = []
        self.used = 0
        self.capacity = capacity

    @property
    def free(self) -> int:
        return self.capacity - self.used

    def add(self, doc: np.ndarray) -> None:
        self.docs.append(doc)
        self.used += len(doc)


class SequencePacker:
    """Online First-Fit packing of a token-document stream into rows.

    ``algorithm``: "first-fit" (paper default), "next-fit" (only the newest
    row — the cheap baseline), or "best-fit".  ``max_open_rows`` bounds
    latency and memory: when exceeded, the fullest row is closed (ready for
    emission), mirroring the IRM closing full bins.
    """

    def __init__(
        self,
        seq_len: int,
        batch_size: int,
        *,
        algorithm: str = "first-fit",
        max_open_rows: Optional[int] = None,
        min_fill_to_close: float = 1.0,
    ):
        if algorithm not in ("first-fit", "next-fit", "best-fit"):
            raise ValueError(f"unknown packing algorithm {algorithm!r}")
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.algorithm = algorithm
        self.max_open_rows = max_open_rows or 4 * batch_size
        self.min_fill_to_close = min_fill_to_close
        self._open: List[_Row] = []
        self._closed: List[_Row] = []
        # stats
        self.docs_in = 0
        self.tokens_in = 0
        self.rows_out = 0

    # ---- packing ---------------------------------------------------------------
    def _choose_row(self, n: int) -> Optional[int]:
        if self.algorithm == "next-fit":
            if self._open and self._open[-1].free >= n:
                return len(self._open) - 1
            return None
        if self.algorithm == "best-fit":
            best, best_free = None, self.seq_len + 1
            for i, row in enumerate(self._open):
                if n <= row.free < best_free:
                    best, best_free = i, row.free
            return best
        for i, row in enumerate(self._open):  # first-fit
            if row.free >= n:
                return i
        return None

    def feed(self, doc: Sequence[int]) -> None:
        """Pack one document (split into seq_len chunks if oversized)."""
        arr = np.asarray(doc, dtype=np.int32)
        self.docs_in += 1
        self.tokens_in += len(arr)
        for start in range(0, len(arr), self.seq_len):
            chunk = arr[start : start + self.seq_len]
            if len(chunk) == 0:
                continue
            idx = self._choose_row(len(chunk))
            if idx is None:
                if self.algorithm == "next-fit" and self._open:
                    # next-fit closes the previous row when it can't fit
                    self._closed.append(self._open.pop())
                self._open.append(_Row(self.seq_len))
                idx = len(self._open) - 1
            row = self._open[idx]
            row.add(chunk)
            if row.free == 0 or row.used >= self.min_fill_to_close * self.seq_len:
                self._closed.append(self._open.pop(idx))
        # bound the number of open rows (close the fullest)
        while len(self._open) > self.max_open_rows:
            fullest = max(range(len(self._open)), key=lambda i: self._open[i].used)
            self._closed.append(self._open.pop(fullest))

    # ---- emission -----------------------------------------------------------------
    def ready(self) -> bool:
        return len(self._closed) >= self.batch_size

    def flush(self) -> None:
        """Close all open rows (end of stream)."""
        self._closed.extend(self._open)
        self._open = []

    def pop_batch(self, *, pad_final: bool = False) -> Optional[PackedBatch]:
        if not self.ready():
            if not pad_final or not self._closed:
                return None
        rows = self._closed[: self.batch_size]
        self._closed = self._closed[self.batch_size :]
        while len(rows) < self.batch_size:  # pad_final: empty rows
            rows.append(_Row(self.seq_len))
        return self._emit(rows)

    def _emit(self, rows: List[_Row]) -> PackedBatch:
        B, S = self.batch_size, self.seq_len
        tokens = np.zeros((B, S), np.int32)
        labels = np.full((B, S), -1, np.int32)
        seg = np.zeros((B, S), np.int32)
        pos = np.zeros((B, S), np.int32)
        for b, row in enumerate(rows):
            off = 0
            for s_id, doc in enumerate(row.docs, start=1):
                n = len(doc)
                tokens[b, off : off + n] = doc
                seg[b, off : off + n] = s_id
                pos[b, off : off + n] = np.arange(n)
                # next-token labels within the document
                labels[b, off : off + n - 1] = doc[1:]
                off += n
        self.rows_out += B
        return PackedBatch(tokens=tokens, labels=labels, segment_ids=seg,
                           positions=pos)

    # ---- metrics --------------------------------------------------------------------
    @property
    def open_rows(self) -> int:
        return len(self._open)

    @property
    def closed_rows(self) -> int:
        return len(self._closed)


def pack_documents(
    docs: Iterable[Sequence[int]],
    seq_len: int,
    batch_size: int,
    *,
    algorithm: str = "first-fit",
) -> Iterator[PackedBatch]:
    """Pack a finite document collection into batches (flushes the tail)."""
    packer = SequencePacker(seq_len, batch_size, algorithm=algorithm)
    for doc in docs:
        packer.feed(doc)
        while packer.ready():
            yield packer.pop_batch()
    packer.flush()
    while True:
        batch = packer.pop_batch(pad_final=True)
        if batch is None:
            break
        yield batch


def packing_efficiency(batches: Iterable[PackedBatch]) -> float:
    """real tokens / capacity — the utilization metric (paper Figs. 4/8)."""
    real = cap = 0
    for b in batches:
        real += b.real_tokens
        cap += b.capacity
    return real / cap if cap else 0.0

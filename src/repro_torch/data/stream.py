"""Streaming training-data pipeline with IRM-managed packing.

The HarmonicIO loop, applied to training data:

  - documents stream into an ingest queue (the master's message queue),
  - the **load predictor** watches the queue length + ROC and decides how
    many packer shards should be active (PE auto-scaling),
  - the **profiler** tracks per-source document statistics (moving average
    of token counts — the item-size profile),
  - **First-Fit packing** fills training rows (bins) from the queue,
  - a background prefetch thread keeps a bounded batch queue ahead of the
    training loop (compute/ingest overlap).

The deterministic synchronous path (``__iter__`` with ``prefetch=0``) is
used by tests; training drivers enable the prefetch thread.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Dict, Iterable, Iterator, Optional

import numpy as np

from ..core.load_predictor import LoadPredictor, LoadPredictorConfig
from ..core.profiler import MasterProfiler, ProfilerConfig
from .packing import PackedBatch, SequencePacker

__all__ = ["StreamingPipeline"]


class StreamingPipeline:
    """Document iterator -> packed-batch iterator, IRM-instrumented."""

    def __init__(
        self,
        documents: Iterable[np.ndarray],
        seq_len: int,
        batch_size: int,
        *,
        algorithm: str = "first-fit",
        prefetch: int = 2,
        max_packer_shards: int = 8,
        source_name: str = "default",
    ):
        self.documents = iter(documents)
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.max_packer_shards = max_packer_shards
        self.source_name = source_name

        self.packer = SequencePacker(seq_len, batch_size, algorithm=algorithm)
        self.profiler = MasterProfiler(
            ProfilerConfig(window=256, default_size=0.1)
        )
        self.predictor = LoadPredictor(
            LoadPredictorConfig(queue_low=512, queue_high=4096,
                                roc_low=256, roc_high=2048,
                                small_increase=1, large_increase=2,
                                read_interval=0.0, cooldown=0.0)
        )
        self.active_shards = 1
        self._ingest: deque = deque()
        self._tick = 0.0
        self.exhausted = False
        self.scaling_events: list = []

    # ---- IRM instrumentation --------------------------------------------------
    def _ingest_documents(self, n: int) -> None:
        """Pull up to n documents from the source into the ingest queue."""
        for _ in range(n):
            try:
                doc = next(self.documents)
            except StopIteration:
                self.exhausted = True
                return
            self._ingest.append(doc)
            # profile: document size as a fraction of a row (the item size)
            self.profiler.observe(
                self.source_name, min(1.0, len(doc) / self.seq_len)
            )

    def _autoscale(self) -> None:
        """Load-predictor decision -> number of active packer shards."""
        self._tick += 1.0
        decision = self.predictor.update(self._tick, float(len(self._ingest)))
        if decision.num_pes > 0:
            new = min(self.max_packer_shards, self.active_shards + decision.num_pes)
            if new != self.active_shards:
                self.scaling_events.append((self._tick, self.active_shards, new))
                self.active_shards = new
        elif len(self._ingest) == 0 and self.active_shards > 1:
            self.scaling_events.append((self._tick, self.active_shards, 1))
            self.active_shards = 1

    # ---- synchronous iteration ---------------------------------------------------
    def _next_batch(self) -> Optional[PackedBatch]:
        while not self.packer.ready():
            if not self._ingest and not self.exhausted:
                # each active shard ingests a chunk per tick (shard throughput)
                self._ingest_documents(64 * self.active_shards)
                self._autoscale()
            if self._ingest:
                self.packer.feed(self._ingest.popleft())
            elif self.exhausted:
                self.packer.flush()
                return self.packer.pop_batch(pad_final=True)
        return self.packer.pop_batch()

    def __iter__(self) -> Iterator[PackedBatch]:
        if self.prefetch <= 0:
            while True:
                batch = self._next_batch()
                if batch is None:
                    return
                yield batch
        else:
            yield from self._prefetch_iter()

    # ---- background prefetch -------------------------------------------------------
    def _prefetch_iter(self) -> Iterator[PackedBatch]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _SENTINEL = object()

        def worker() -> None:
            try:
                while True:
                    batch = self._next_batch()
                    if batch is None:
                        break
                    q.put(batch)
            finally:
                q.put(_SENTINEL)

        t = threading.Thread(target=worker, daemon=True, name="packer-prefetch")
        t.start()
        while True:
            item = q.get()
            if item is _SENTINEL:
                t.join()
                return
            yield item

    # ---- metrics ---------------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        return {
            "docs_in": self.packer.docs_in,
            "tokens_in": self.packer.tokens_in,
            "rows_out": self.packer.rows_out,
            "mean_doc_fill": self.profiler.estimate(self.source_name),
            "active_shards": self.active_shards,
            "ingest_queue": len(self._ingest),
        }

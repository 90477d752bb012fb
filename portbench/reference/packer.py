"""Plain online First-Fit packing of documents into training rows, the rows
the port's pipeline has to emit.

A document longer than a row is cut into row-length chunks, each its own
document.  A chunk goes into the lowest-index open row with room for it, or
a new row; a row closes when full, and while more than ``4 x rows`` rows are
open the fullest of them closes.  Closed rows leave in the order they
closed, ``rows`` at a time.  A row holds its documents in order, each with
segment id 1, 2, ... (0 pads), positions from 0 and next-token labels
inside the document (-1 on its last token and on padding).
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List

import numpy as np

__all__ = ["packed_rows"]


def _emit(rows: List[List[np.ndarray]], seq_len: int) -> Dict[str, np.ndarray]:
    B = len(rows)
    out = {"tokens": np.zeros((B, seq_len), np.int32),
           "labels": np.full((B, seq_len), -1, np.int32),
           "segment_ids": np.zeros((B, seq_len), np.int32),
           "positions": np.zeros((B, seq_len), np.int32)}
    for b, docs in enumerate(rows):
        at = 0
        for i, doc in enumerate(docs, start=1):
            n = len(doc)
            out["tokens"][b, at:at + n] = doc
            out["labels"][b, at:at + n - 1] = doc[1:]
            out["segment_ids"][b, at:at + n] = i
            out["positions"][b, at:at + n] = np.arange(n)
            at += n
    return out


def packed_rows(documents: Iterable[np.ndarray], seq_len: int, rows: int) -> Iterator[Dict[str, np.ndarray]]:
    """Batches of ``rows`` packed rows (dicts of (rows, seq_len) arrays)."""
    open_rows: List[List[np.ndarray]] = []
    used: List[int] = []
    closed: List[List[np.ndarray]] = []
    for doc in documents:
        for at in range(0, len(doc), seq_len):
            chunk = doc[at:at + seq_len]
            i = next((j for j, u in enumerate(used) if seq_len - u >= len(chunk)), None)
            if i is None:
                open_rows.append([])
                used.append(0)
                i = len(open_rows) - 1
            open_rows[i].append(chunk)
            used[i] += len(chunk)
            if used[i] == seq_len:
                closed.append(open_rows.pop(i))
                used.pop(i)
        while len(open_rows) > 4 * rows:
            i = int(np.argmax(used))
            closed.append(open_rows.pop(i))
            used.pop(i)
        while len(closed) >= rows:
            yield _emit(closed[:rows], seq_len)
            closed = closed[rows:]

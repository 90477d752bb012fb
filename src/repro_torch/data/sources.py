"""Document sources for the streaming data pipeline.

``synthetic_documents`` models a scientific-corpus length distribution
(log-normal, heavy upper tail — the "large individual objects" regime the
paper targets, in token form).  ``bimodal_documents`` mixes short chat-like
and long article-like documents, the adversarial case for naive padding.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

__all__ = ["synthetic_documents", "bimodal_documents"]


def synthetic_documents(
    vocab_size: int,
    *,
    mean_len: float = 700.0,
    sigma: float = 0.9,
    max_len: int = 16384,
    seed: int = 0,
    limit: Optional[int] = None,
    zipf_a: float = 1.3,
) -> Iterator[np.ndarray]:
    """Log-normal document lengths; Zipf-distributed token ids.

    The Zipf unigram distribution gives the stream *learnable* structure
    (uniform tokens would make ln(V) the optimal loss — nothing to train
    on); documents also repeat a sampled 8-gram motif, so a small model's
    loss visibly drops within a few hundred steps.
    """
    rng = np.random.default_rng(seed)
    mu = np.log(mean_len) - sigma ** 2 / 2
    n = 0
    while limit is None or n < limit:
        length = int(np.clip(rng.lognormal(mu, sigma), 8, max_len))
        toks = rng.zipf(zipf_a, size=length) % vocab_size
        # per-document repeated motif (local predictable structure)
        if length >= 32:
            motif = toks[:8].copy()
            starts = rng.integers(8, length - 8, size=max(1, length // 64))
            for s in starts:
                toks[s : s + 8] = motif
        yield toks.astype(np.int32)
        n += 1


def bimodal_documents(
    vocab_size: int,
    *,
    short_len: int = 128,
    long_len: int = 3000,
    long_fraction: float = 0.2,
    jitter: float = 0.3,
    seed: int = 0,
    limit: Optional[int] = None,
) -> Iterator[np.ndarray]:
    rng = np.random.default_rng(seed)
    n = 0
    while limit is None or n < limit:
        base = long_len if rng.random() < long_fraction else short_len
        length = max(8, int(base * rng.uniform(1 - jitter, 1 + jitter)))
        yield rng.integers(0, vocab_size, size=length).astype(np.int32)
        n += 1

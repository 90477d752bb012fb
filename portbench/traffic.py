"""The one generator of inputs: documents for training, prompts for
serving, each from a traffic file's parameters and the run's seed.

Shapes come from the traffic file alone, so that every seed times the same
work: document lengths from the file's ``length_seed``, prompt lengths
listed in the file.  The seed draws only token ids (and the documents'
motifs).  The document law is the port's ``synthetic_documents`` (a
log-normal length, Zipf ids, an 8-gram motif repeated through each
document), with its lengths and its ids split into two streams.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

__all__ = ["seed_words", "rng", "document_lengths", "documents", "prompt_ids"]

# stream tags: each stream a run draws from has its own
IDS, WEIGHTS, PROMPTS, WARMUP, SAMPLE = 1, 2, 3, 4, 5


def seed_words(seed: int) -> List[int]:
    """Any whole number as two unsigned 32-bit words (a negative one taken
    modulo 2**64)."""
    u = int(seed) % (1 << 64)
    return [u & 0xFFFFFFFF, u >> 32]


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(seed_words(seed) + list(tags)))


def document_lengths(law: Dict) -> Iterator[int]:
    """The law's lengths, the same on every run."""
    r = np.random.default_rng(law["length_seed"])
    mu = np.log(law["mean_len"]) - law["sigma"] ** 2 / 2
    while True:
        yield int(np.clip(r.lognormal(mu, law["sigma"]), law["min_len"], law["max_len"]))


def documents(law: Dict, vocab: int, seed: int) -> Iterator[np.ndarray]:
    """Documents of ``document_lengths`` with Zipf(``zipf_a``) ids below
    ``vocab``; a document of 32 tokens or more repeats its first 8 ids at
    one place in every 64 tokens, drawn from the seed."""
    r = rng(seed, IDS)
    motif = law["motif_len"]
    for n in document_lengths(law):
        toks = r.zipf(law["zipf_a"], size=n) % vocab
        if n >= 4 * motif:
            starts = r.integers(motif, n - motif, size=max(1, n // 64))
            for s in starts:
                toks[s:s + motif] = toks[:motif]
        yield toks.astype(np.int32)


def prompt_ids(lengths: List[int], vocab: int, seed: int, *tags: int) -> List[np.ndarray]:
    """One prompt of uniform ids below ``vocab`` for each length."""
    r = rng(seed, PROMPTS, *tags)
    return [r.integers(0, vocab, size=n, dtype=np.int32) for n in lengths]

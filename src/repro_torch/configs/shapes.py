"""Assigned input shapes (LM transformer family).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of ``seq_len``), not ``train_step``.  ``long_500k`` requires
sub-quadratic attention: it runs only for hybrid/SSM archs
(``ArchConfig.subquadratic``); the skip for pure full-attention archs is
recorded in DESIGN.md §4.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List

__all__ = ["ShapeConfig", "SHAPES", "cells_for"]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: List[ShapeConfig] = [
    ShapeConfig("train_4k", "train", 4_096, 256),
    ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    ShapeConfig("decode_32k", "decode", 32_768, 128),
    ShapeConfig("long_500k", "decode", 524_288, 1),
]

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def cells_for(cfg) -> Iterator[ShapeConfig]:
    """The dry-run cells for an architecture, honouring the skip rules."""
    for s in SHAPES:
        if s.name == "long_500k" and not cfg.subquadratic:
            continue  # pure full-attention arch: 500k dense KV inapplicable
        yield s

"""Model registry: ``ArchConfig`` -> model object, and materialised batches.

The port builds all ten architectures, as the JAX package does: the
encoder-decoder (``cfg.encdec``: seamless-m4t-medium) as ``EncDecLM``, and
every decoder as ``DecoderLM``, whatever its layer pattern: attention only
(dense or MoE), Mamba + attention with MoE (jamba), mLSTM/sLSTM (xlstm),
and the vision-embedding prefix (internvl2).
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from ..configs.base import ArchConfig
from .encdec import EncDecLM
from .transformer import DecoderLM

__all__ = ["build_model", "make_batch"]


def build_model(cfg: ArchConfig) -> Union[DecoderLM, EncDecLM]:
    return EncDecLM(cfg) if cfg.encdec else DecoderLM(cfg)


def make_batch(
    cfg: ArchConfig, shape_kind: str, B: int, S: int, seed: int = 0
) -> Dict[str, torch.Tensor]:
    """The JAX package's ``make_batch``: the same numbers, drawn from a
    numpy generator seeded ``seed`` in the same order, as CPU tensors
    (``shape_kind`` is unused, as there).  An encoder-decoder batch splits
    S into S/2 encoder frames and S/2 decoder tokens; a vision batch
    carries min(frontend_tokens, S) patch embeddings."""
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size

    def t(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)

    def tok(b: int, s: int) -> torch.Tensor:
        return t(rng.integers(0, v, size=(b, s)), torch.int32)

    def positions(b: int, s: int) -> torch.Tensor:
        return t(np.broadcast_to(np.arange(s), (b, s)), torch.int32)

    if cfg.encdec:
        Se, Sd = S // 2, S // 2
        return {
            "enc_embeds": t(rng.normal(size=(B, Se, cfg.d_model)) * 0.02, torch.float32),
            "enc_segment_ids": t(np.ones((B, Se)), torch.int32),
            "tokens": tok(B, Sd),
            "labels": tok(B, Sd),
            "segment_ids": t(np.ones((B, Sd)), torch.int32),
            "positions": positions(B, Sd),
        }
    batch = {
        "tokens": tok(B, S),
        "labels": tok(B, S),
        "segment_ids": t(np.ones((B, S)), torch.int32),
        "positions": positions(B, S),
    }
    if cfg.frontend == "vision":
        nv = min(cfg.frontend_tokens, S)
        batch["vision_embeds"] = t(rng.normal(size=(B, nv, cfg.d_model)) * 0.02,
                                   torch.float32)
    return batch

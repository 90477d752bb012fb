"""Model registry: ``ArchConfig`` -> model object.

This slice builds the dense decoders whose layer pattern is attention only
(``family == "dense"``: qwen3-8b, olmo-1b, qwen2-72b, deepseek-67b).  The
other families raise, naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from ..configs.base import ArchConfig
from .transformer import DecoderLM

__all__ = ["build_model"]


def build_model(cfg: ArchConfig) -> DecoderLM:
    if cfg.encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are ROADMAP queue 1 item 6")
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the MoE layer is ROADMAP queue 1 item 4")
    if "M" in cfg.pattern:
        raise NotImplementedError(
            f"{cfg.name}: the Mamba (ssm) blocks are ROADMAP queue 1 item 6")
    if any(c in cfg.pattern for c in "ls"):
        raise NotImplementedError(
            f"{cfg.name}: the xLSTM blocks are ROADMAP queue 1 item 6")
    if cfg.family != "dense" or set(cfg.pattern) != {"A"}:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (frontend {cfg.frontend!r}) is "
            "ROADMAP queue 1 item 6")
    return DecoderLM(cfg)

"""Model registry: ``ArchConfig`` -> model object.

The port builds the decoders whose layer pattern is attention only: the
dense ones (``family == "dense"``: qwen3-8b, olmo-1b, qwen2-72b,
deepseek-67b) and the MoE ones (``family == "moe"``: qwen3-moe-30b-a3b,
grok-1-314b).  The other families raise, naming the ROADMAP item that ports
them.
"""

from __future__ import annotations

from ..configs.base import ArchConfig
from .transformer import DecoderLM

__all__ = ["build_model"]


def build_model(cfg: ArchConfig) -> DecoderLM:
    if cfg.encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are ROADMAP queue 1 item 6")
    if "M" in cfg.pattern:
        raise NotImplementedError(
            f"{cfg.name}: the Mamba (ssm) blocks are ROADMAP queue 1 item 6")
    if any(c in cfg.pattern for c in "ls"):
        raise NotImplementedError(
            f"{cfg.name}: the xLSTM blocks are ROADMAP queue 1 item 6")
    if cfg.family not in ("dense", "moe") or set(cfg.pattern) != {"A"}:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (frontend {cfg.frontend!r}) is "
            "ROADMAP queue 1 item 6")
    return DecoderLM(cfg)

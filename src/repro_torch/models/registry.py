"""Model registry: ``ArchConfig`` -> model object, the stand-ins of a
dry-run cell's inputs and cache, and materialised batches.

The port builds all ten architectures, as the JAX package does: the
encoder-decoder (``cfg.encdec``: seamless-m4t-medium) as ``EncDecLM``, and
every decoder as ``DecoderLM``, whatever its layer pattern: attention only
(dense or MoE), Mamba + attention with MoE (jamba), mLSTM/sLSTM (xlstm),
and the vision-embedding prefix (internvl2).
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..configs.shapes import ShapeConfig
from ..kernels.paged_attention.ops import page_table_from_allocator
from ..serving.kv_cache import PagedCacheLayout
from . import ssm, xlstm
from .encdec import EncDecLM
from .transformer import DecoderLM

__all__ = ["build_model", "input_specs", "cache_specs", "make_batch"]

META = torch.device("meta")
PAGE_SIZE = 16  # tokens a page, as the serving launcher's (launch/serve.py)
# each recurrent block's state, as prefill leaves it
_INIT_STATE = {"M": ssm.mamba_init_state, "l": xlstm.mlstm_init_state,
               "s": xlstm.slstm_init_state}


def build_model(cfg: ArchConfig) -> Union[DecoderLM, EncDecLM]:
    return EncDecLM(cfg) if cfg.encdec else DecoderLM(cfg)


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for the model inputs of one cell, the JAX
    package's ``input_specs``: (B, S) int32 tokens, labels, segment ids and
    positions for training and prefill (an encoder-decoder splits S into
    S/2 bf16 encoder frames and S/2 tokens; a vision model adds its bf16
    patch embeddings); one (B, 1) token for decode."""
    B, S = shape.global_batch, shape.seq_len

    def i32(*dims: int) -> torch.Tensor:
        return torch.empty(dims, dtype=torch.int32, device=META)

    def bf16(*dims: int) -> torch.Tensor:
        return torch.empty(dims, dtype=torch.bfloat16, device=META)

    if shape.kind == "decode":
        return {"tokens": i32(B, 1)}
    if cfg.encdec:
        Se, Sd = S // 2, S // 2
        return {"enc_embeds": bf16(B, Se, cfg.d_model), "enc_segment_ids": i32(B, Se),
                "tokens": i32(B, Sd), "labels": i32(B, Sd), "segment_ids": i32(B, Sd),
                "positions": i32(B, Sd)}
    specs = {"tokens": i32(B, S), "labels": i32(B, S), "segment_ids": i32(B, S),
             "positions": i32(B, S)}
    if cfg.frontend == "vision":
        specs["vision_embeds"] = bf16(B, cfg.frontend_tokens, cfg.d_model)
    return specs


def cache_specs(cfg: ArchConfig, shape: ShapeConfig,
                dtype: torch.dtype = torch.bfloat16,
                device: torch.device = META) -> Dict[str, Any]:
    """The cache of one serving cell on meta stand-ins (or zeroed on
    ``device``): the port's paged cache (the JAX package's dense
    ``KVCache`` is not ported).

    Decode: pools exactly large enough for B sequences of S tokens, the
    First-Fit allocator holding each of the B sequences at S - 1 tokens (a
    decode step writes the S-th), and each recurrent layer's state; an
    encoder-decoder's cross pages hold max(S / 8, 128) encoder positions a
    sequence, as the JAX package's cache.

    Prefill: the cache ``prefill`` fills, an argument, so its bytes count as
    the step's arguments.  They match what the JAX package's prefill
    returns, the dense cache it builds: pools exactly large enough for the B
    prompts of ``input_specs`` (S tokens; an encoder-decoder's S / 2
    decoder tokens, and its cross pools S / 2 encoder positions), an empty
    allocator, and each recurrent layer's initial state."""
    model = build_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    prefill = shape.kind == "prefill"
    if prefill and cfg.encdec:
        S //= 2
    per_seq = -(-S // PAGE_SIZE)
    layout = PagedCacheLayout(num_pages=B * per_seq, page_size=PAGE_SIZE,
                              n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim_,
                              max_pages_per_seq=per_seq)
    cache = model.init_paged_cache(layout, dtype, device)
    seqs = list(range(B))
    if not cfg.encdec:
        cache["state"] = [_INIT_STATE[c](cfg, B, device)
                          for _ in range(cfg.n_periods) for c in cfg.pattern
                          if c in _INIT_STATE]
    if prefill:
        return cache
    for b in seqs:
        cache["alloc"].allocate(b, S - 1)
    cache["seqs"] = seqs
    cache["len"] = torch.full((B,), S - 1, dtype=torch.int32, device=device)
    if cfg.encdec:
        for b in seqs:
            cache["cross_alloc"].allocate(b, max(S // 8, 128))
        cache["cross_table"], cache["enc_len"] = page_table_from_allocator(
            cache["cross_alloc"], seqs, device)
    return cache


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

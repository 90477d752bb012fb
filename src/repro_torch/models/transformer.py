"""Decoder-only LM assembled from an ``ArchConfig``: the dense serving path.

Parameters keep the JAX package's layout: each position of the layer
pattern is a dict of tensors stacked over periods, so the JAX package's
parameters carry across as a copy (``params.params_from_numpy``).  The
layer stack is a Python loop over periods with the pattern unrolled inside.

Serving entry points, with the JAX package's argument order and returns:
  - ``prefill``     : full-sequence forward; writes every valid token's K/V
                      into the pages the First-Fit allocator gives its row;
  - ``decode_step`` : one new token per sequence, attending over its pages
                      through the paged-attention kernel.
The cache is the paged one (``init_paged_cache``): a K pool and a V pool
``(n_layers, num_pages, page_size, KVH, D)``, the port's ``PageAllocator``,
the active sequence ids and their lengths.  Both entry points update it in
place and return it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels.paged_attention.ops import page_table_from_allocator
from ..serving.kv_cache import PageAllocator, PagedCacheLayout
from .layers import (
    attention,
    attention_decode,
    attention_specs,
    mlp,
    mlp_specs,
    norm,
    norm_specs,
)
from .params import Spec, tree_map

__all__ = ["DecoderLM", "pad_vocab"]


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Pad vocab to a multiple of 256, as the JAX package does."""
    return ((v + multiple - 1) // multiple) * multiple


def _block_specs(cfg: Any, pos: int) -> Dict[str, Any]:
    """Parameter specs for the attention block at ``pos`` within the period."""
    if cfg.pattern[pos] != "A":
        raise ValueError(f"dense blocks only, got pattern char {cfg.pattern[pos]!r}")
    specs: Dict[str, Any] = {
        "ln1": norm_specs(cfg.norm_type, cfg.d_model),
        "mixer": attention_specs(cfg),
    }
    if cfg.d_ff:
        specs["ln2"] = norm_specs(cfg.norm_type, cfg.d_model)
        specs["ffn"] = mlp_specs(cfg)
    return specs


def _stack_period(cfg: Any, spec_tree: Any) -> Any:
    """Prepend the stacked 'layers' (periods) dimension to every spec."""
    n = cfg.n_periods
    return tree_map(
        lambda s: Spec(shape=(n,) + s.shape, axes=("layers",) + s.axes,
                       init=s.init, scale=s.scale, dtype=s.dtype),
        spec_tree,
    )


@dataclasses.dataclass
class DecoderLM:
    cfg: Any

    # ---- parameters ---------------------------------------------------------
    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        v = pad_vocab(cfg.vocab_size)
        specs: Dict[str, Any] = {
            # unit-variance embeddings for untied models; tied models keep
            # the small init, since the same table is the unembedding
            "embed": Spec((v, cfg.d_model), ("vocab", "embed"), init="normal",
                          scale=0.02 if cfg.tie_embeddings else 1.0),
            "final_norm": norm_specs(cfg.norm_type, cfg.d_model),
            "blocks": {
                str(pos): _stack_period(cfg, _block_specs(cfg, pos))
                for pos in range(len(cfg.pattern))
            },
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = Spec((v, cfg.d_model), ("vocab", "embed"),
                                    init="scaled")
        return specs

    def _table(self, params: Dict[str, Any]) -> torch.Tensor:
        return params["embed"] if self.cfg.tie_embeddings else params["lm_head"]

    def _embed(self, params: Dict[str, Any],
               batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return params["embed"][batch["tokens"]]

    def _logits(self, params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        return x.float() @ self._table(params).float().T

    def _layers(self, params: Dict[str, Any]):
        """(layer index, pattern position, that layer's params) in order."""
        cfg = self.cfg
        for period in range(cfg.n_periods):
            for pos in range(len(cfg.pattern)):
                p = tree_map(lambda t: t[period], params["blocks"][str(pos)])
                yield period * len(cfg.pattern) + pos, p

    def _ffn(self, p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        if "ffn" not in p:
            return x
        return x + mlp(p["ffn"], self.cfg, norm(p["ln2"], self.cfg.norm_type, x))

    # ---- cache allocation ---------------------------------------------------
    def init_paged_cache(
        self,
        layout: PagedCacheLayout,
        dtype: torch.dtype = torch.bfloat16,
        device: Optional[torch.device] = None,
    ) -> Dict[str, Any]:
        """An empty paged cache: zeroed K and V pools of ``(n_layers,
        num_pages, page_size, KVH, D)``, a First-Fit allocator over them, and
        no sequences."""
        cfg = self.cfg
        if (layout.n_kv_heads, layout.head_dim) != (cfg.n_kv_heads, cfg.head_dim_):
            raise ValueError(
                f"layout has {layout.n_kv_heads} KV heads of {layout.head_dim}, "
                f"the model {cfg.n_kv_heads} of {cfg.head_dim_}")
        shape = (cfg.n_layers, layout.num_pages, layout.page_size,
                 layout.n_kv_heads, layout.head_dim)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "alloc": PageAllocator(layout),
            "seqs": [],
            "len": torch.zeros((0,), dtype=torch.int32, device=device),
        }

    # ---- serving: prefill ---------------------------------------------------
    def prefill(
        self,
        params: Dict[str, Any],
        batch: Dict[str, torch.Tensor],
        cache: Dict[str, Any],
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Returns (last-token logits (B, V) fp32, cache).

        Row b becomes sequence b of ``cache``, which must hold none yet: the
        allocator gives it the pages for its valid tokens (``seg > 0``), and
        each valid token's K/V is written to slot ``i % page_size`` of its
        row's page ``i // page_size``, where i counts the row's valid tokens.
        """
        cfg = self.cfg
        if cache["seqs"]:
            raise ValueError("prefill takes a cache that holds no sequence")
        seg, pos_ids = batch["segment_ids"], batch["positions"]
        B = seg.shape[0]
        alloc: PageAllocator = cache["alloc"]
        valid = seg > 0
        lens = valid.sum(dim=1, dtype=torch.int32)
        for b, n in enumerate(lens.tolist()):
            if alloc.allocate(b, n) is None:
                raise RuntimeError(
                    f"the KV pool cannot hold sequence {b} of {n} tokens "
                    f"({alloc.free_pages} pages free)")
        seqs = list(range(B))
        table, _ = page_table_from_allocator(alloc, seqs, seg.device)
        page_size = alloc.layout.page_size
        rank = valid.long().cumsum(dim=1) - 1  # index among the row's valid tokens
        b_idx, t_idx = valid.nonzero(as_tuple=True)
        r = rank[b_idx, t_idx]
        dest = table.long()[b_idx, r // page_size] * page_size + r % page_size

        x = self._embed(params, batch)
        for layer, p in self._layers(params):
            h = norm(p["ln1"], cfg.norm_type, x)
            out, (k, v) = attention(p["mixer"], cfg, h, seg, pos_ids)
            for pool, new in ((cache["k"], k), (cache["v"], v)):
                pool[layer].flatten(0, 1)[dest] = new[b_idx, t_idx].to(pool.dtype)
            x = self._ffn(p, x + out)
        x = norm(params["final_norm"], cfg.norm_type, x)
        last = (lens.long() - 1).clamp(min=0)  # last valid position per row
        logits = self._logits(params, x[torch.arange(B, device=x.device), last])
        cache["seqs"], cache["len"] = seqs, lens
        return logits, cache

    # ---- serving: decode ----------------------------------------------------
    def decode_step(
        self,
        params: Dict[str, Any],
        batch: Dict[str, torch.Tensor],  # {"tokens": (B, 1)}
        cache: Dict[str, Any],
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One token for every sequence of the cache, in its order."""
        cfg = self.cfg
        tokens = batch["tokens"]
        seqs = cache["seqs"]
        if tokens.shape[0] != len(seqs):
            raise ValueError(f"{tokens.shape[0]} tokens for {len(seqs)} sequences")
        alloc: PageAllocator = cache["alloc"]
        for s in seqs:
            if alloc.extend(s, 1) is None:
                raise RuntimeError(
                    f"the KV pool cannot grow sequence {s} "
                    f"({alloc.free_pages} pages free)")
        table, new_len = page_table_from_allocator(alloc, seqs, tokens.device)
        position = new_len - 1  # 0-based position of the new token

        x = self._embed(params, batch)  # (B, 1, d)
        for layer, p in self._layers(params):
            h = norm(p["ln1"], cfg.norm_type, x)
            out = attention_decode(p["mixer"], cfg, h, position, cache["k"][layer],
                                   cache["v"][layer], table, new_len)
            x = self._ffn(p, x + out)
        x = norm(params["final_norm"], cfg.norm_type, x)
        cache["len"] = new_len
        return self._logits(params, x[:, 0]), cache

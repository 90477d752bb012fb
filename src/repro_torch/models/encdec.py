"""Encoder-decoder LM (the seamless-m4t backbone), in PyTorch.

As in the JAX package, the audio frontend is a stub: the encoder takes
precomputed frame embeddings (B, S_enc, d), which it casts to the weights'
dtype.  The encoder is non-causal self-attention; each decoder layer is
causal self-attention, cross attention to the encoder output (no RoPE),
and the MLP.

Serving keeps the port's paged design.  The decoder's self-attention K/V go
into a First-Fit paged pool, as the decoders' do.  The cross K/V of each
layer are written once, at prefill, into a second pair of pools with their
own ``PageAllocator``, which gives each sequence its encoder length; a
decode step's cross attention is the paged kernel over those pages, with
the encoder's valid length as the cache length (the JAX package computes
the same with its dense ``decode_attention``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.context import constrain
from ..kernels.paged_attention.ops import page_table_from_allocator
from ..serving.kv_cache import PageAllocator, PagedCacheLayout
from .layers import (
    attention,
    attention_decode,
    attention_specs,
    cross_attention_decode,
    mlp,
    mlp_specs,
    norm,
    norm_specs,
)
from .params import Spec, tree_leaves, tree_map
from .transformer import (
    _remat,
    chunked_cross_entropy,
    grow,
    last_tokens,
    pad_vocab,
    write_plan,
    write_tokens,
)

__all__ = ["EncDecLM"]


@dataclasses.dataclass
class EncDecLM:
    cfg: Any

    # ---- parameters -----------------------------------------------------------
    def _enc_layer_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "ln1": norm_specs(cfg.norm_type, cfg.d_model),
            "self_attn": attention_specs(cfg),
            "ln2": norm_specs(cfg.norm_type, cfg.d_model),
            "ffn": mlp_specs(cfg),
        }

    def _dec_layer_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "ln1": norm_specs(cfg.norm_type, cfg.d_model),
            "self_attn": attention_specs(cfg),
            "ln_cross": norm_specs(cfg.norm_type, cfg.d_model),
            "cross_attn": attention_specs(cfg, cross=True),
            "ln2": norm_specs(cfg.norm_type, cfg.d_model),
            "ffn": mlp_specs(cfg),
        }

    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        v = pad_vocab(cfg.vocab_size)

        def stack(n: int, tree: Any) -> Any:
            return tree_map(
                lambda s: Spec((n,) + s.shape, ("layers",) + s.axes, init=s.init,
                               scale=s.scale, dtype=s.dtype), tree)

        return {
            # unit-variance embeddings, as the untied decoders'
            "embed": Spec((v, cfg.d_model), ("vocab", "embed"), init="normal",
                          scale=1.0),
            "enc_blocks": stack(cfg.n_encoder_layers, self._enc_layer_specs()),
            "enc_norm": norm_specs(cfg.norm_type, cfg.d_model),
            "dec_blocks": stack(cfg.n_layers, self._dec_layer_specs()),
            "final_norm": norm_specs(cfg.norm_type, cfg.d_model),
            "lm_head": Spec((v, cfg.d_model), ("vocab", "embed"), init="scaled"),
        }

    @staticmethod
    def _layers(stacked: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Each layer's params, every stacked leaf unbound once."""
        parts = tree_map(lambda t: t.unbind(0), stacked)
        n = len(tree_leaves(parts)[0])
        return [tree_map(lambda leaf: leaf[i], parts) for i in range(n)]

    def _logits(self, params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        return x.float() @ params["lm_head"].float().T

    # ---- encoder ----------------------------------------------------------------
    def encode(
        self,
        params: Dict[str, Any],
        enc_embeds: torch.Tensor,       # (B, Se, d) stub frame embeddings
        enc_segment_ids: torch.Tensor,  # (B, Se)
        *,
        remat_policy: Optional[str] = "nothing",
    ) -> torch.Tensor:
        cfg = self.cfg
        B, Se, _ = enc_embeds.shape
        pos = torch.arange(Se, dtype=torch.int32, device=enc_embeds.device).expand(B, Se)

        def body(p, x):
            x = constrain(x, ("batch", "seq", None))
            h = norm(p["ln1"], cfg.norm_type, x)
            out, _ = attention(p["self_attn"], cfg, h, enc_segment_ids, pos, causal=False)
            x = x + out
            h = norm(p["ln2"], cfg.norm_type, x)
            return x + mlp(p["ffn"], cfg, h)

        if remat_policy is not None:
            body = _remat(body, remat_policy)
        x = enc_embeds.to(params["embed"].dtype)
        for p in self._layers(params["enc_blocks"]):
            x = body(p, x)
        return norm(params["enc_norm"], cfg.norm_type, x)

    # ---- decoder (training / prefill over full sequence) --------------------------
    def _decoder_hidden(
        self,
        params: Dict[str, Any],
        tokens: torch.Tensor,
        segment_ids: torch.Tensor,
        positions: torch.Tensor,
        enc_out: torch.Tensor,
        enc_segment_ids: torch.Tensor,
        *,
        remat_policy: Optional[str] = "nothing",
        on_layer=None,
    ) -> torch.Tensor:
        """The final-normed decoder states.  ``on_layer(l, (k, v), (ck,
        cv))``, if given, receives each layer's self and cross K/V (and
        rematerialisation is off)."""
        cfg = self.cfg
        B, Se, _ = enc_out.shape
        enc_pos = torch.arange(Se, dtype=torch.int32, device=enc_out.device).expand(B, Se)

        def body(p, x):
            x = constrain(x, ("batch", "seq", None))
            h = norm(p["ln1"], cfg.norm_type, x)
            out, kv = attention(p["self_attn"], cfg, h, segment_ids, positions)
            x = x + out
            h = norm(p["ln_cross"], cfg.norm_type, x)
            out, ckv = attention(
                p["cross_attn"], cfg, h, segment_ids, positions, causal=False,
                x_kv=enc_out, segment_ids_kv=enc_segment_ids, positions_kv=enc_pos,
                use_rope=False)
            x = x + out
            h = norm(p["ln2"], cfg.norm_type, x)
            return x + mlp(p["ffn"], cfg, h), kv, ckv

        if remat_policy is not None and on_layer is None:
            body = _remat(body, remat_policy)
        x = F.embedding(tokens, params["embed"])
        for layer, p in enumerate(self._layers(params["dec_blocks"])):
            x, kv, ckv = body(p, x)
            if on_layer is not None:
                on_layer(layer, kv, ckv)
        return norm(params["final_norm"], cfg.norm_type, x)

    # ---- entry points ------------------------------------------------------------
    def loss(
        self,
        params: Dict[str, Any],
        batch: Dict[str, torch.Tensor],
        *,
        remat_policy: Optional[str] = "nothing",
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        enc_out = self.encode(params, batch["enc_embeds"], batch["enc_segment_ids"],
                              remat_policy=remat_policy)
        x = self._decoder_hidden(
            params, batch["tokens"], batch["segment_ids"], batch["positions"],
            enc_out, batch["enc_segment_ids"], remat_policy=remat_policy)
        loss, metrics = chunked_cross_entropy(x, params["lm_head"], batch["labels"])
        return loss, dict(metrics, loss=loss)

    def init_paged_cache(
        self,
        layout: PagedCacheLayout,
        dtype: torch.dtype = torch.bfloat16,
        device: Optional[torch.device] = None,
    ) -> Dict[str, Any]:
        """An empty paged cache: zeroed self-attention K and V pools of
        ``(n_layers, num_pages, page_size, KVH, D)`` under a First-Fit
        allocator, cross K and V pools of the same shape under a second
        one, and no sequences."""
        cfg = self.cfg
        if (layout.n_kv_heads, layout.head_dim) != (cfg.n_kv_heads, cfg.head_dim_):
            raise ValueError(
                f"layout has {layout.n_kv_heads} KV heads of {layout.head_dim}, "
                f"the model {cfg.n_kv_heads} of {cfg.head_dim_}")
        shape = (cfg.n_layers, layout.num_pages, layout.page_size, layout.n_kv_heads,
                 layout.head_dim)

        def pool() -> torch.Tensor:
            return torch.zeros(shape, dtype=dtype, device=device)

        return {
            "k": pool(), "v": pool(), "alloc": PageAllocator(layout),
            "ck": pool(), "cv": pool(), "cross_alloc": PageAllocator(layout),
            "seqs": [], "len": torch.zeros((0,), dtype=torch.int32, device=device),
            "enc_len": torch.zeros((0,), dtype=torch.int32, device=device),
            "cross_table": None,
        }

    def prefill(
        self,
        params: Dict[str, Any],
        batch: Dict[str, torch.Tensor],
        cache: Dict[str, Any],
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Returns (last-token logits (B, V) fp32, cache).  Row b becomes
        sequence b of both allocators: its valid decoder tokens' K/V go into
        the self pools and its valid encoder positions' cross K/V into the
        cross pools, each in the pages its allocator gave it."""
        if cache["seqs"]:
            raise ValueError("prefill takes a cache that holds no sequence")
        seg, enc_seg = batch["segment_ids"], batch["enc_segment_ids"]
        B = seg.shape[0]
        plan = write_plan(cache["alloc"], seg)
        enc_plan = write_plan(cache["cross_alloc"], enc_seg)

        def keep(layer, kv, ckv):
            write_tokens(cache["k"][layer], cache["v"][layer], *kv, plan)
            write_tokens(cache["ck"][layer], cache["cv"][layer], *ckv, enc_plan)

        enc_out = self.encode(params, batch["enc_embeds"], enc_seg, remat_policy=None)
        x = self._decoder_hidden(params, batch["tokens"], seg, batch["positions"],
                                 enc_out, enc_seg, remat_policy=None, on_layer=keep)
        logits = self._logits(params, last_tokens(x, plan))
        seqs = list(range(B))
        cache["cross_table"], cache["enc_len"] = page_table_from_allocator(
            cache["cross_alloc"], seqs, plan.lens.device)
        cache["seqs"], cache["len"] = seqs, plan.lens
        return logits, cache

    def decode_step(
        self,
        params: Dict[str, Any],
        batch: Dict[str, torch.Tensor],  # {"tokens": (B, 1)}
        cache: Dict[str, Any],
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One decoder token for every sequence of the cache: self attention
        over its pages, then cross attention over its encoder pages."""
        cfg = self.cfg
        tokens = batch["tokens"]
        seqs = cache["seqs"]
        if tokens.shape[0] != len(seqs):
            raise ValueError(f"{tokens.shape[0]} tokens for {len(seqs)} sequences")
        table, new_len = grow(cache["alloc"], seqs, tokens.device)
        position = new_len - 1
        x = F.embedding(tokens, params["embed"])  # (B, 1, d)
        for layer, p in enumerate(self._layers(params["dec_blocks"])):
            x = constrain(x, ("batch", None, None))
            h = norm(p["ln1"], cfg.norm_type, x)
            x = x + attention_decode(p["self_attn"], cfg, h, position, cache["k"][layer],
                                     cache["v"][layer], table, new_len)
            h = norm(p["ln_cross"], cfg.norm_type, x)
            x = x + cross_attention_decode(p["cross_attn"], cfg, h, cache["ck"][layer],
                                           cache["cv"][layer], cache["cross_table"],
                                           cache["enc_len"])
            h = norm(p["ln2"], cfg.norm_type, x)
            x = x + mlp(p["ffn"], cfg, h)
        x = norm(params["final_norm"], cfg.norm_type, x)
        cache["len"] = new_len
        return self._logits(params, x[:, 0]), cache

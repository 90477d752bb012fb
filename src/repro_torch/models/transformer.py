"""Decoder-only LM assembled from an ``ArchConfig``: the training and
serving paths of the decoders, whatever their layer pattern: attention
('A'), Mamba ('M', ``ssm.py``), mLSTM and sLSTM ('l', 's', ``xlstm.py``),
dense or MoE feed-forwards, and the vision-embedding prefix.

Parameters keep the JAX package's layout: each position of the layer
pattern is a dict of tensors stacked over periods, so the JAX package's
parameters carry across as a copy (``params.params_from_numpy``).  The
layer stack is a Python loop over periods with the pattern unrolled inside;
each stacked leaf is unbound once per call, so autograd stacks its
gradient once rather than once per layer.

Entry points, with the JAX package's argument order and returns:
  - ``loss``        : training forward + chunked cross-entropy, over rows
                      the First-Fit sequence packer fills with documents;
  - ``prefill``     : full-sequence forward; writes every valid token's K/V
                      into the pages the First-Fit allocator gives its row,
                      and keeps each recurrent layer's final state;
  - ``decode_step`` : one new token per sequence, attending over its pages
                      through the paged-attention kernel and advancing each
                      recurrent state by one step.
On the card, ``loss`` and ``prefill`` attend through the packed-attention
kernels (``layers.attention``), and an MoE layer's experts run through the
grouped-matmul kernel (``moe.moe_layer``; serving only: the kernel has no
backward).  The recurrent scans are plain PyTorch loops over time, as the
JAX package's are ``lax.scan`` loops.  The cache is the paged one
(``init_paged_cache``): a K pool and a V pool ``(n_attn_layers, num_pages,
page_size, KVH, D)``, the port's ``PageAllocator``, the active sequence
ids, their lengths and the recurrent states.  Both serving entry points
update it in place and return it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..distributed.context import constrain
from ..kernels.paged_attention.ops import page_table_from_allocator
from ..serving.kv_cache import PageAllocator, PagedCacheLayout
from . import ssm, xlstm
from .layers import (
    attention,
    attention_decode,
    attention_specs,
    mlp,
    mlp_specs,
    norm,
    norm_specs,
    write_rows_local,
)
from .moe import moe_layer, moe_specs
from .params import Spec, tree_map

__all__ = ["DecoderLM", "WritePlan", "chunked_cross_entropy", "full_rows_plan", "pad_vocab",
           "write_plan"]


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Pad vocab to a multiple of 256, as the JAX package does."""
    return ((v + multiple - 1) // multiple) * multiple


# ---------------------------------------------------------------------------
# Chunked cross-entropy (never materializes (B, S, V) logits)
# ---------------------------------------------------------------------------


def _reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending partial reductions carried out (each partial mesh
    dim made ``Replicate``); anything else as it is.  A gather along a
    sharded dim leaves a masked partial, which DTensor cannot carry through
    the select that follows."""
    if not isinstance(x, DTensor) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


def _chunk_loss(h_c: torch.Tensor, table_f: torch.Tensor, l_c: torch.Tensor):
    # batch over the data axes only, so that the vocab dim can take "model":
    # the (b, chunk, V) logits stay sharded
    h_c = constrain(h_c, ("batch_data", None, None))
    logits = constrain(h_c.float() @ table_f.T,  # (B, chunk, V) fp32
                       ("batch_data", None, "vocab"))
    lse = torch.logsumexp(logits, dim=-1)
    picked = _reduce_partial(logits.gather(-1, l_c.clamp(min=0).long()[..., None]))[..., 0]
    valid = (l_c >= 0).float()
    ce = (lse - picked) * valid
    zl = lse.square() * valid
    return ce.sum(), zl.sum(), valid.sum()


def chunked_cross_entropy(
    hidden: torch.Tensor,   # (B, S, d)
    table: torch.Tensor,    # (V, d) embedding/unembedding table
    labels: torch.Tensor,   # (B, S) int, -1 = masked
    *,
    chunk: int = 512,
    z_loss: float = 1e-4,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy plus ``z_loss`` x mean lse^2 over the
    labels that are not -1.  Each chunk of ``chunk`` positions computes its
    fp32 logits against the table under ``torch.utils.checkpoint``, so only
    one chunk's (B, chunk, V) logits live at a time, forward or backward.
    The table is cast to fp32 once, outside the chunks (the JAX package casts
    it inside each; the values are the same)."""
    B, S, d = hidden.shape
    hidden = constrain(hidden, ("batch_data", None, None))  # the sequence gathered
    labels = constrain(labels, ("batch_data", None))
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    table_f = table.float()
    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
    ce_sum, zl_sum, n_valid = zero, zero, zero
    for c0 in range(0, hidden.shape[1], chunk):
        ce, zl, nv = checkpoint(_chunk_loss, hidden[:, c0:c0 + chunk], table_f,
                                labels[:, c0:c0 + chunk], use_reentrant=False)
        ce_sum, zl_sum, n_valid = ce_sum + ce, zl_sum + zl, n_valid + nv
    n_valid = torch.clamp(n_valid, min=1.0)
    loss = ce_sum / n_valid + z_loss * zl_sum / n_valid
    return loss, {"ce": ce_sum / n_valid, "tokens": n_valid}


# ---------------------------------------------------------------------------
# Block specs, rematerialisation
# ---------------------------------------------------------------------------


def _block_specs(cfg: Any, pos: int) -> Dict[str, Any]:
    """Parameter specs for the block at position ``pos`` within the period:
    its mixer (attention, Mamba, mLSTM or sLSTM), and for attention and
    Mamba blocks a feed-forward, the MoE layer where the config makes
    ``pos`` one (the xLSTM blocks carry their own projections)."""
    char = cfg.pattern[pos]
    specs: Dict[str, Any] = {"ln1": norm_specs(cfg.norm_type, cfg.d_model)}
    if char == "A":
        specs["mixer"] = attention_specs(cfg)
    elif char == "M":
        specs["mixer"] = ssm.mamba_specs(cfg)
    elif char == "l":
        specs["mixer"] = xlstm.mlstm_specs(cfg)
    elif char == "s":
        specs["mixer"] = xlstm.slstm_specs(cfg)
    else:
        raise ValueError(f"unknown pattern char {char!r}")
    if char in ("A", "M") and (cfg.d_ff or cfg.moe):
        specs["ln2"] = norm_specs(cfg.norm_type, cfg.d_model)
        if cfg.moe is not None and cfg.moe.is_moe_layer(pos):
            specs["ffn"] = moe_specs(cfg)
        elif cfg.d_ff:
            specs["ffn"] = mlp_specs(cfg)
    return specs


# each recurrent block's (full-sequence forward, one-token step); both take
# and return the block's state (a dict of fp32 tensors)
_RECURRENT = {
    "M": (ssm.mamba_forward, ssm.mamba_decode_step),
    "l": (xlstm.mlstm_forward, xlstm.mlstm_decode_step),
    "s": (xlstm.slstm_forward, xlstm.slstm_decode_step),
}


def _mixer(char: str, p: Dict[str, Any], cfg: Any, h: torch.Tensor,
           seg: torch.Tensor, pos_ids: torch.Tensor):
    """The full-sequence mixer of a ``char`` block on its normed input:
    (out, (k, v)) for attention, (out, final state) for a recurrent block,
    which ignores the segment ids, as in the JAX package."""
    if char == "A":
        return attention(p, cfg, h, seg, pos_ids)
    if char in _RECURRENT:
        return _RECURRENT[char][0](p, cfg, h)
    raise ValueError(f"unknown pattern char {char!r}")


class WritePlan(NamedTuple):
    """Where prefill writes each valid token (``write_plan``): the rows'
    valid counts (B,), each valid token's row and column, its slot in a
    pool flattened over (page, slot), and whether every row is full and
    row b holds pages b P ... (b + 1) P - 1 (P pages a row), the layout a
    page-sharded pool's ranks write without a plan (``layers.write_rows_local``)."""

    lens: torch.Tensor
    b_idx: torch.Tensor
    t_idx: torch.Tensor
    dest: torch.Tensor
    full_rows: bool


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def write_plan(alloc: PageAllocator, seg: torch.Tensor) -> WritePlan:
    """Give row b of ``seg`` (B, S) its pages as sequence b of ``alloc``
    (its valid tokens: ``seg > 0``), and plan each valid token's slot: slot
    ``i % page_size`` of the row's page ``i // page_size``, where i counts
    the row's valid tokens.

    The plan is read from the segment ids' values, or, for a dry-run's
    stand-in (a meta tensor, or a DTensor of meta shards: no values), from
    their shape: every row is full, and First-Fit gives B equal sequences
    on an empty pool consecutive pages, which the allocator must confirm."""
    B, S = seg.shape
    if _local(seg).device.type == "meta":
        plan = full_rows_plan(alloc, B, S, _local(seg).device)
        if not plan.full_rows:
            raise RuntimeError("a stand-in prefill needs an empty pool: its rows are "
                               "planned on consecutive pages")
        return plan
    if isinstance(seg, DTensor):  # the plan is the host's: every rank's the same
        seg = seg.full_tensor()
    valid = seg > 0
    lens = valid.sum(dim=1, dtype=torch.int32)
    _allocate(alloc, lens.tolist())
    table, _ = page_table_from_allocator(alloc, list(range(B)), seg.device)
    rank = valid.long().cumsum(dim=1) - 1  # index among the row's valid tokens
    b_idx, t_idx = valid.nonzero(as_tuple=True)
    full = bool(valid.all()) and _consecutive(alloc, B, S)
    return _plan(table, alloc.layout.page_size, lens, b_idx, t_idx, rank[b_idx, t_idx], full)


def full_rows_plan(alloc: PageAllocator, B: int, S: int, device: Any) -> WritePlan:
    """``write_plan`` for B rows of S valid tokens, from the shapes alone:
    the rows' pages from ``alloc``, which hands them out, and each token's
    slot from the pages First-Fit gives B equal sequences on an empty pool
    (row b: pages b P ... (b + 1) P - 1)."""
    _allocate(alloc, [S] * B)
    P = alloc.layout.pages_for(S)
    table = torch.arange(B * P, dtype=torch.int32, device=device).view(B, P)
    b_idx = torch.arange(B, device=device).repeat_interleave(S)
    t_idx = torch.arange(S, device=device).repeat(B)
    lens = torch.full((B,), S, dtype=torch.int32, device=device)
    return _plan(table, alloc.layout.page_size, lens, b_idx, t_idx, t_idx,
                 _consecutive(alloc, B, S))


def _allocate(alloc: PageAllocator, lens: List[int]) -> None:
    for b, n in enumerate(lens):
        if alloc.allocate(b, n) is None:
            raise RuntimeError(
                f"the KV pool cannot hold sequence {b} of {n} tokens "
                f"({alloc.free_pages} pages free)")


def _consecutive(alloc: PageAllocator, B: int, S: int) -> bool:
    P = alloc.layout.pages_for(S)
    return all(alloc.seq_pages(b) == list(range(b * P, (b + 1) * P)) for b in range(B))


def _plan(table: torch.Tensor, page_size: int, lens: torch.Tensor, b_idx: torch.Tensor,
          t_idx: torch.Tensor, r: torch.Tensor, full_rows: bool) -> WritePlan:
    dest = table.long()[b_idx, r // page_size] * page_size + r % page_size
    return WritePlan(lens, b_idx, t_idx, dest, full_rows)


def last_tokens(x: torch.Tensor, plan: WritePlan) -> torch.Tensor:
    """Each row's last valid position of ``x`` (B, S, d): the last column
    where every row is full (a slice, which a DTensor takes as it is laid
    out), else a gather by the rows' lengths."""
    if plan.full_rows:
        return x[:, -1]
    last = (plan.lens.long() - 1).clamp(min=0)
    return x[torch.arange(x.shape[0], device=x.device), last]


def grow(alloc: PageAllocator, seqs: List[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One more token for each of ``seqs``: (page table, new lengths)."""
    for s in seqs:
        if alloc.extend(s, 1) is None:
            raise RuntimeError(
                f"the KV pool cannot grow sequence {s} ({alloc.free_pages} pages free)")
    return page_table_from_allocator(alloc, seqs, device)


def write_tokens(k_pool: torch.Tensor, v_pool: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, plan: WritePlan) -> None:
    """Write the valid tokens' K/V (B, S, KVH, D) into one layer's pools at
    the slots of ``plan`` (``write_plan``).  A DTensor pool takes full rows
    only, each rank writing into its own pages (``write_rows_local``)."""
    for pool, new in ((k_pool, k), (v_pool, v)):
        if isinstance(pool, DTensor):
            if not plan.full_rows:
                raise NotImplementedError(
                    "a DTensor pool is written by full rows on consecutive pages only")
            write_rows_local(pool, new)
        else:
            pool.flatten(0, 1)[plan.dest] = new[plan.b_idx, plan.t_idx].to(pool.dtype)


def _stack_period(cfg: Any, spec_tree: Any) -> Any:
    """Prepend the stacked 'layers' (periods) dimension to every spec."""
    n = cfg.n_periods
    return tree_map(
        lambda s: Spec(shape=(n,) + s.shape, axes=("layers",) + s.axes,
                       init=s.init, scale=s.scale, dtype=s.dtype),
        spec_tree,
    )


def _zero_aux(device: torch.device) -> Dict[str, torch.Tensor]:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"moe_load_balance": z, "moe_z_loss": z, "moe_drop_fraction": z}


def _add_aux(a: Dict[str, torch.Tensor], b: Optional[Dict[str, torch.Tensor]]
             ) -> Dict[str, torch.Tensor]:
    return a if b is None else {k: a[k] + b[k] for k in a}


# the products JAX's dots_with_no_batch_dims_saveable keeps: matrix products
# without batch dims (the projections, the MLP); attention's batched
# products and everything elementwise are recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under the JAX package's remat policy: ``"nothing"`` saves no
    activation inside ``fn`` (a non-reentrant checkpoint), ``"dots"`` saves
    the outputs of the matrix products (a selective checkpoint),
    ``"everything"`` saves all (no checkpoint)."""
    if policy == "everything":
        return fn
    if policy == "nothing":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        return lambda *args: checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(_save_dots))
    raise ValueError(f"unknown remat policy {policy!r}")


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
        """The tokens' embeddings; for a vision model the precomputed patch
        embeddings (``vision_embeds``, B x nv x d) take the first nv
        positions, as the JAX package's frontend stub does.  nv more than
        the sequence raises the ``ValueError`` the JAX package raises."""
        x = F.embedding(batch["tokens"], params["embed"])
        if self.cfg.frontend == "vision" and "vision_embeds" in batch:
            vis = batch["vision_embeds"]
            nv, S = vis.shape[1], x.shape[1]
            if nv > S:
                raise ValueError(
                    f"{nv} vision embedding rows do not fit a sequence of {S} tokens: "
                    f"incompatible shapes for broadcasting, {tuple(vis.shape)} into "
                    f"{tuple(x.shape[:2])} + ({x.shape[2]},)")
            x = torch.cat([vis.to(x.dtype), x[:, nv:]], dim=1)
        return x

    def _logits(self, params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
        return x.float() @ self._table(params).float().T

    def _periods(self, params: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Each period's params, ``{pos: block params}``, every stacked leaf
        unbound once (one autograd node per leaf, not one per layer)."""
        cfg = self.cfg
        parts = {str(pos): tree_map(lambda t: t.unbind(0), params["blocks"][str(pos)])
                 for pos in range(len(cfg.pattern))}
        return [{pos: tree_map(lambda leaf: leaf[period], tree)
                 for pos, tree in parts.items()}
                for period in range(cfg.n_periods)]

    def _layers(self, params: Dict[str, Any]):
        """(layer index, its pattern char, its params) in order."""
        pattern = self.cfg.pattern
        for period, blocks in enumerate(self._periods(params)):
            for pos, char in enumerate(pattern):
                yield period * len(pattern) + pos, char, blocks[str(pos)]

    def _ffn(self, p: Dict[str, Any], x: torch.Tensor, out_axes: Optional[tuple] = None
             ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """``x`` plus the block's feed-forward (the MLP, or the MoE layer
        where ``p["ffn"]`` has a router) of its normed input, and the MoE
        layer's aux losses (None for an MLP).  ``out_axes`` constrains the
        feed-forward's output before the sum."""
        if "ffn" not in p:
            return x, None
        h = norm(p["ln2"], self.cfg.norm_type, x)
        aux = None
        if "router" in p["ffn"]:
            out, aux = moe_layer(p["ffn"], self.cfg, h)
        else:
            out = mlp(p["ffn"], self.cfg, h)
        if out_axes is not None:
            out = constrain(out, out_axes)
        return x + out, aux

    # ---- training forward -----------------------------------------------------
    def _apply_block_train(
        self,
        char: str,
        p: Dict[str, Any],
        x: torch.Tensor,
        seg: torch.Tensor,
        pos_ids: torch.Tensor,
        aux: Dict[str, torch.Tensor],
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        x = constrain(x, ("batch", "seq", None))
        h = norm(p["ln1"], cfg.norm_type, x)
        out, _ = _mixer(char, p["mixer"], cfg, h, seg, pos_ids)
        x = x + constrain(out, ("batch", "seq", None))
        x, moe_aux = self._ffn(p, x, out_axes=("batch", "seq", None))
        return x, _add_aux(aux, moe_aux)

    def hidden_states(
        self,
        params: Dict[str, Any],
        batch: Dict[str, torch.Tensor],
        *,
        remat_policy: Optional[str] = "nothing",
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The final-normed hidden states (B, S, d) and the aux losses (0
        for dense models).  Each period of the pattern runs under
        ``remat_policy`` (None: no checkpoint)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        seg, pos_ids = batch["segment_ids"], batch["positions"]
        aux = _zero_aux(x.device)

        def period_body(blocks, x, aux):
            for pos, char in enumerate(cfg.pattern):
                x, aux = self._apply_block_train(char, blocks[str(pos)], x, seg,
                                                 pos_ids, aux)
            return x, aux

        body = period_body if remat_policy is None else _remat(period_body, remat_policy)
        for blocks in self._periods(params):
            x, aux = body(blocks, x, aux)
        return norm(params["final_norm"], cfg.norm_type, x), aux

    def loss(
        self,
        params: Dict[str, Any],
        batch: Dict[str, torch.Tensor],
        *,
        remat_policy: Optional[str] = "nothing",
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x, aux = self.hidden_states(params, batch, remat_policy=remat_policy)
        loss, metrics = chunked_cross_entropy(x, self._table(params), batch["labels"])
        loss = loss + aux["moe_load_balance"] + aux["moe_z_loss"]
        metrics = dict(metrics, **aux, loss=loss)
        return loss, metrics

    # ---- cache allocation ---------------------------------------------------
    def init_paged_cache(
        self,
        layout: PagedCacheLayout,
        dtype: torch.dtype = torch.bfloat16,
        device: Optional[torch.device] = None,
    ) -> Dict[str, Any]:
        """An empty paged cache: zeroed K and V pools of ``(n_attn_layers,
        num_pages, page_size, KVH, D)``, one per attention layer of the
        pattern in layer order, a First-Fit allocator over them, no
        sequences, and no recurrent states yet (``prefill`` gives each
        Mamba/xLSTM layer its state, in layer order, under ``"state"``)."""
        cfg = self.cfg
        if (layout.n_kv_heads, layout.head_dim) != (cfg.n_kv_heads, cfg.head_dim_):
            raise ValueError(
                f"layout has {layout.n_kv_heads} KV heads of {layout.head_dim}, "
                f"the model {cfg.n_kv_heads} of {cfg.head_dim_}")
        n_attn = cfg.pattern.count("A") * cfg.n_periods
        shape = (n_attn, layout.num_pages, layout.page_size,
                 layout.n_kv_heads, layout.head_dim)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "alloc": PageAllocator(layout),
            "seqs": [],
            "len": torch.zeros((0,), dtype=torch.int32, device=device),
            "state": [],
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
        each attention layer writes each valid token's K/V to slot ``i %
        page_size`` of its row's page ``i // page_size``, where i counts the
        row's valid tokens.  Each recurrent layer's final state is recorded.
        """
        cfg = self.cfg
        if cache["seqs"]:
            raise ValueError("prefill takes a cache that holds no sequence")
        seg, pos_ids = batch["segment_ids"], batch["positions"]
        B = seg.shape[0]
        plan = write_plan(cache["alloc"], seg)

        x = self._embed(params, batch)
        n_attn, states = 0, []
        for _, char, p in self._layers(params):
            x = constrain(x, ("batch", "seq", None))
            h = norm(p["ln1"], cfg.norm_type, x)
            out, kept = _mixer(char, p["mixer"], cfg, h, seg, pos_ids)
            if char == "A":
                write_tokens(cache["k"][n_attn], cache["v"][n_attn], *kept, plan)
                n_attn += 1
            else:
                states.append(kept)
            x, _ = self._ffn(p, x + out)
        x = norm(params["final_norm"], cfg.norm_type, x)
        logits = self._logits(params, last_tokens(x, plan))
        cache["seqs"], cache["len"], cache["state"] = list(range(B)), plan.lens, states
        return logits, cache

    # ---- serving: decode ----------------------------------------------------
    def decode_step(
        self,
        params: Dict[str, Any],
        batch: Dict[str, torch.Tensor],  # {"tokens": (B, 1)}
        cache: Dict[str, Any],
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One token for every sequence of the cache, in its order: each
        attention layer attends over its pages, each recurrent layer
        advances its state by the token."""
        cfg = self.cfg
        tokens = batch["tokens"]
        seqs = cache["seqs"]
        if tokens.shape[0] != len(seqs):
            raise ValueError(f"{tokens.shape[0]} tokens for {len(seqs)} sequences")
        table, new_len = grow(cache["alloc"], seqs, tokens.device)
        position = new_len - 1  # 0-based position of the new token

        x = self._embed(params, batch)  # (B, 1, d)
        n_attn = n_rec = 0
        for _, char, p in self._layers(params):
            x = constrain(x, ("batch", None, None))
            h = norm(p["ln1"], cfg.norm_type, x)
            if char == "A":
                out = attention_decode(p["mixer"], cfg, h, position, cache["k"][n_attn],
                                       cache["v"][n_attn], table, new_len)
                n_attn += 1
            else:
                out, cache["state"][n_rec] = _RECURRENT[char][1](
                    p["mixer"], cfg, h, cache["state"][n_rec])
                n_rec += 1
            x, _ = self._ffn(p, x + out)
        x = norm(params["final_norm"], cfg.norm_type, x)
        cache["len"] = new_len
        return self._logits(params, x[:, 0]), cache

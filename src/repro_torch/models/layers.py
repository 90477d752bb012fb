"""Core transformer layers: norms, RoPE, chunked flash attention, MLP, and
decode attention over the First-Fit paged KV cache.

Full-sequence attention (training and prefill) runs on the card through
``kernels.packed_attention``: the Hopper forward and backward kernels, with
the segment-ID masks of the First-Fit sequence packer, GQA and sliding
windows, causal or not, and a cross-attention source of another length
(the encoder-decoder's).  On the CPU it is the JAX package's chunked
online-softmax (flash) form in plain PyTorch (``flash_attention``): peak
memory O(chunk^2) instead of O(S^2), differentiable by autograd.  Decode
attends one new token per sequence against its pages through
``kernels.paged_attention`` (the Hopper kernel on the card): its own K/V
pages, the last ``sliding_window`` tokens of them where the config sets
one, or the encoder's cross K/V pages (``cross_attention_decode``).

Conventions (the JAX package's):
  q: (B, S, H, D)   k/v: (B, S, KVH, D)   segment_ids: (B, S) int32, 0 = pad
  positions: (B, S) int32 — within-segment positions (used for RoPE);
  causality uses absolute sequence indices, so packed segments stay causal.
Parameters are the JAX package's, keyed by the same names; the projections
keep its (d, H, hd) and (H, hd, d) layouts.  ``constrain`` pins the
activations' layout at the JAX package's call sites while a mesh context
is active (``distributed/context.py``); without one it does nothing.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..distributed.context import constrain, current_mesh
from ..kernels.packed_attention import ops as packed_ops
from ..kernels.paged_attention import ops as paged_ops
from ..kernels.shard_local import any_dtensor, shard_local
from .params import Spec

__all__ = [
    "rms_norm",
    "layer_norm",
    "norm",
    "norm_specs",
    "rope",
    "repeat_kv",
    "flash_attention",
    "attention_specs",
    "attention",
    "attention_decode",
    "cross_attention_decode",
    "decode_attention_distributed",
    "write_rows_local",
    "mlp_specs",
    "mlp",
]

_NEG_INF = -0.7 * torch.finfo(torch.float32).max


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: Optional[torch.Tensor],
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    y = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())
    return y.to(dtype)


def layer_norm(
    x: torch.Tensor,
    scale: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm; with scale=bias=None this is OLMo's non-parametric LN."""
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def norm_specs(norm_type: str, d: int) -> Dict[str, Spec]:
    if norm_type == "rmsnorm":
        return {"scale": Spec((d,), ("embed",), init="zeros")}
    if norm_type == "layernorm":
        return {
            "scale": Spec((d,), ("embed",), init="ones"),
            "bias": Spec((d,), ("embed",), init="zeros"),
        }
    if norm_type == "layernorm_np":  # non-parametric (OLMo)
        return {}
    raise ValueError(f"unknown norm type {norm_type!r}")


def norm(params: Dict[str, torch.Tensor], norm_type: str,
         x: torch.Tensor) -> torch.Tensor:
    if norm_type == "rmsnorm":
        return rms_norm(x, params["scale"])
    if norm_type == "layernorm":
        return layer_norm(x, params["scale"], params["bias"])
    if norm_type == "layernorm_np":
        return layer_norm(x, None, None)
    raise ValueError(f"unknown norm type {norm_type!r}")


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Apply RoPE.  x: (B, S, H, D), positions: (B, S)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    angles = positions.float()[..., None] * freqs  # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked flash attention (plain PyTorch; the CPU path)
# ---------------------------------------------------------------------------


def _mask_chunk(q_idx, kv_idx, seg_q, seg_kv, causal: bool,
                window: int) -> torch.Tensor:
    """(B, cq, ck) bool mask: segment match & causality & sliding window."""
    m = (seg_q[:, :, None] == seg_kv[:, None, :]) & (seg_kv[:, None, :] != 0)
    if causal:
        m &= q_idx[None, :, None] >= kv_idx[None, None, :]
    if window > 0:
        m &= (q_idx[None, :, None] - kv_idx[None, None, :]) < window
    return m


def _flash_q_chunk(
    q: torch.Tensor,       # (B, cq, H, D)
    k: torch.Tensor,       # (B, S, H, D) (KV heads pre-repeated to H)
    v: torch.Tensor,       # (B, S, H, D)
    q_start: int,          # absolute index of the chunk's first query
    seg_q: torch.Tensor,   # (B, cq)
    seg_kv: torch.Tensor,  # (B, S)
    *,
    causal: bool,
    window: int,
    chunk_kv: int,
    scale: float,
) -> torch.Tensor:
    B, cq, H, D = q.shape
    S = k.shape[1]
    qf = q.float().transpose(1, 2)  # (B, H, cq, D)
    m_run = torch.full((B, H, cq), _NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((B, H, cq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, cq, D), dtype=torch.float32, device=q.device)
    q_idx = torch.arange(q_start, q_start + cq, dtype=torch.int32, device=q.device)
    q_last = q_start + cq - 1
    for c0 in range(0, S, chunk_kv):
        # a chunk wholly above the causal diagonal leaves (m, l, acc) exactly
        # as they are (every p is 0 and alpha is 1), so it is skipped
        if causal and c0 > q_last:
            break
        k_c = k[:, c0:c0 + chunk_kv].float().transpose(1, 2)  # (B, H, ck, D)
        v_c = v[:, c0:c0 + chunk_kv]
        idx_c = torch.arange(c0, c0 + chunk_kv, dtype=torch.int32, device=q.device)
        # operands exact in fp32, fp32 accumulation
        s = (qf @ k_c.transpose(-1, -2)) * scale  # (B, H, cq, ck)
        mask = _mask_chunk(q_idx, idx_c, seg_q, seg_kv[:, c0:c0 + chunk_kv],
                           causal, window)[:, None]
        s = torch.where(mask, s, _NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        # fully-masked rows: s == m_new == NEG_INF would give p = 1; zero
        # them so padded query positions produce exactly 0
        p = torch.where(mask, p, 0.0)
        alpha = torch.exp(m_run - m_new)
        l_run = alpha * l_run + p.sum(dim=-1)
        # p is rounded to the value type before the PV product, as the JAX
        # package does; the product itself accumulates in fp32
        pv = p.to(v_c.dtype).float() @ v_c.float().transpose(1, 2)
        acc = alpha[..., None] * acc + pv
        m_run = m_new
    out = acc / torch.clamp(l_run[..., None], min=1e-30)
    return out.transpose(1, 2)  # (B, cq, H, D)


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KVH, D) -> (B, S, KVH*n_rep, D)."""
    if n_rep == 1:
        return k
    B, S, KVH, D = k.shape
    return k[:, :, :, None, :].expand(B, S, KVH, n_rep, D).reshape(
        B, S, KVH * n_rep, D)


def flash_attention(
    q: torch.Tensor,               # (B, Sq, H, D)
    k: torch.Tensor,               # (B, Skv, KVH, D)
    v: torch.Tensor,               # (B, Skv, KVH, D)
    segment_ids_q: torch.Tensor,   # (B, Sq)
    segment_ids_kv: torch.Tensor,  # (B, Skv)
    *,
    causal: bool = True,
    window: int = 0,
    chunk_q: int = 512,
    chunk_kv: int = 512,
) -> torch.Tensor:
    """Chunked online-softmax attention with segment masking.  O(c^2) memory.

    On DTensors it runs on each rank's shards, under the kernels' rule
    (``kernels/shard_local.py``): its batched products would merge a
    sharded batch dim with sharded heads, a layout DTensor cannot always
    keep."""
    if any_dtensor(q, k, v, segment_ids_q, segment_ids_kv):
        return shard_local(
            "flash_attention",
            lambda *a: flash_attention(*a, causal=causal, window=window,
                                       chunk_q=chunk_q, chunk_kv=chunk_kv),
            [("q", q, "b.h."), ("k", k, "b.h."), ("v", v, "b.h."),
             ("segment_ids_q", segment_ids_q, "b."),
             ("segment_ids_kv", segment_ids_kv, "b.")], "b.h.")
    B, Sq, H, D = q.shape
    KVH = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    k = constrain(repeat_kv(k, H // KVH), ("batch", None, "heads", None))
    v = constrain(repeat_kv(v, H // KVH), ("batch", None, "heads", None))

    chunk_q = min(chunk_q, Sq)
    chunk_kv = min(chunk_kv, k.shape[1])

    def pad_to(x: torch.Tensor, c: int) -> torch.Tensor:
        rem = (-x.shape[1]) % c  # segment id 0 == masked padding
        if rem == 0:
            return x
        widths = [0, 0] * (x.dim() - 2) + [0, rem]
        return F.pad(x, widths)

    qp, sq = pad_to(q, chunk_q), pad_to(segment_ids_q, chunk_q)
    kp, vp = pad_to(k, chunk_kv), pad_to(v, chunk_kv)
    skv = pad_to(segment_ids_kv, chunk_kv)
    outs = []
    for q0 in range(0, qp.shape[1], chunk_q):
        outs.append(_flash_q_chunk(
            qp[:, q0:q0 + chunk_q], kp, vp, q0,
            sq[:, q0:q0 + chunk_q], skv,
            causal=causal, window=window, chunk_kv=chunk_kv, scale=scale,
        ))
    return torch.cat(outs, dim=1)[:, :Sq].to(q.dtype)


# ---------------------------------------------------------------------------
# Attention block (projections + flash core / paged decode)
# ---------------------------------------------------------------------------


def attention_specs(cfg: Any, cross: bool = False) -> Dict[str, Any]:
    """The block's projections; a cross-attention block (``cross``) has the
    same ones, as in the JAX package."""
    d, hd = cfg.d_model, cfg.head_dim_
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    specs: Dict[str, Any] = {
        "wq": Spec((d, H, hd), ("embed", "heads", "head_dim"), init="scaled"),
        "wk": Spec((d, KVH, hd), ("embed", "kv_heads", "head_dim"), init="scaled"),
        "wv": Spec((d, KVH, hd), ("embed", "kv_heads", "head_dim"), init="scaled"),
        "wo": Spec((H, hd, d), ("heads", "head_dim", "embed"), init="scaled"),
    }
    if cfg.qkv_bias:
        specs["bq"] = Spec((H, hd), ("heads", "head_dim"), init="zeros")
        specs["bk"] = Spec((KVH, hd), ("kv_heads", "head_dim"), init="zeros")
        specs["bv"] = Spec((KVH, hd), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        specs["q_norm"] = Spec((hd,), ("head_dim",), init="zeros")
        specs["k_norm"] = Spec((hd,), ("head_dim",), init="zeros")
    return specs


class _GradAsForward(torch.autograd.Function):
    """The identity, whose backward lays the gradient out as the forward's
    value was laid out (replicated where the value was a pending sum)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        ctx.mesh = t.device_mesh
        ctx.placements = tuple(Replicate() if pl.is_partial() else pl for pl in t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        if tuple(g.placements) != tuple(ctx.placements):
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def _pinned(t: torch.Tensor, units: int) -> torch.Tensor:
    """``t``, whose gradient a DTensor lays out as ``t`` is laid out, where
    the mesh could shard a dim of ``units`` whole units finer than a unit
    (its devices do not divide ``units``); ``t`` itself elsewhere, the pin's
    host time spared."""
    if isinstance(t, DTensor) and units % t.device_mesh.size():
        return _GradAsForward.apply(t)
    return t


def flatten_heads(t: torch.Tensor) -> torch.Tensor:
    """(..., H, hd) -> (..., H * hd), the gradient in whole heads (see
    ``heads_product``)."""
    return _pinned(t.flatten(-2), t.shape[-2])


def heads_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., d) @ (d, *dims) -> (..., *dims), the product taken over the
    flattened weight.  On DTensors the flat columns, the product's and the
    weight gradient's alike, are laid out in whole units of ``dims[0]``:
    DTensor may shard them finer than that splits (8 KV heads' 1024
    columns over a 16-wide axis), a layout it cannot unflatten; such
    shards are gathered."""
    d, dims = w.shape[0], tuple(w.shape[1:])
    w_flat = w.reshape(d, -1)
    if not isinstance(w_flat, DTensor):
        return (x @ w_flat).unflatten(-1, dims)
    out = x @ _pinned(w_flat, dims[0])
    last = out.ndim - 1
    n = 1
    for m, pl in enumerate(out.placements):
        if isinstance(pl, Shard) and pl.dim == last:
            n *= out.device_mesh.size(m)
    if dims[0] % n:
        out = out.redistribute(out.device_mesh, [
            Replicate() if isinstance(pl, Shard) and pl.dim == last else pl
            for pl in out.placements])
    return _pinned(out.unflatten(-1, dims), dims[0])


def _project_qkv(
    p: Dict[str, torch.Tensor], cfg: Any, x: torch.Tensor,
    x_kv: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q from ``x``, k and v from ``x_kv`` (a cross-attention source;
    default ``x``)."""
    x_kv = x if x_kv is None else x_kv
    # the sequence gathered before the projections (as XLA gathers it
    # between sequence-parallel blocks): a DTensor product cannot flatten
    # (B, S) with S sharded
    x_kv = constrain(x_kv, ("batch", None, None))
    k, v = heads_product(x_kv, p["wk"]), heads_product(x_kv, p["wv"])
    if cfg.qkv_bias:
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    # the layout inside the block: heads over model, sequence gathered
    q = constrain(_project_q(p, cfg, x), ("batch", None, "heads", None))
    k = constrain(k, ("batch", None, "kv_heads", None))
    v = constrain(v, ("batch", None, "kv_heads", None))
    return q, k, v


def _project_q(p: Dict[str, torch.Tensor], cfg: Any, x: torch.Tensor) -> torch.Tensor:
    q = heads_product(constrain(x, ("batch", None, None)), p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    return q


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) @ (H, hd, d) -> (B, S, d)."""
    H, hd, d = wo.shape
    return flatten_heads(out) @ _pinned(wo.reshape(H * hd, d), H)


def _sharded_heads(t: torch.Tensor) -> list:
    return [m for m, pl in enumerate(t.placements) if isinstance(pl, Shard) and pl.dim == 2]


def _kv_heads_as_q(q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """K or V for the kernels on DTensors, whose rule wants the KV heads
    sharded as q's heads: where the rules could not shard the KV heads so
    (fewer KV heads than shards), they are repeated to q's heads first and
    laid out as q's, as the JAX package's flash path does."""
    if not isinstance(q, DTensor) or _sharded_heads(q) == _sharded_heads(kv):
        return kv
    return constrain(repeat_kv(kv, q.shape[2] // kv.shape[2]), ("batch", None, "heads", None))


def attention(
    p: Dict[str, torch.Tensor],
    cfg: Any,
    x: torch.Tensor,            # (B, S, d)
    segment_ids: torch.Tensor,  # (B, S)
    positions: torch.Tensor,    # (B, S)
    *,
    causal: bool = True,
    x_kv: Optional[torch.Tensor] = None,             # cross-attention source
    segment_ids_kv: Optional[torch.Tensor] = None,
    positions_kv: Optional[torch.Tensor] = None,
    use_rope: bool = True,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention (training and prefill).  Returns (out, (k,
    v)).  Self-attention by default; with ``x_kv`` the keys and values come
    from that source (B, Skv, d), masked by ``segment_ids_kv``, as the JAX
    package's cross attention.  On the card the attention core is the
    packed-attention kernels (differentiable, causal or not, Sq and Skv
    apart); on the CPU, the plain chunked flash path."""
    x_kv = x if x_kv is None else x_kv
    segment_ids_kv = segment_ids if segment_ids_kv is None else segment_ids_kv
    positions_kv = positions if positions_kv is None else positions_kv
    q, k, v = _project_qkv(p, cfg, x, x_kv)
    if use_rope:  # positions laid out as q and k are: the sequence whole
        q = rope(q, constrain(positions, ("batch", None)), cfg.rope_theta)
        k = rope(k, constrain(positions_kv, ("batch", None)), cfg.rope_theta)
    # the kernels read whole rows of segment ids (as XLA gathers them)
    segment_ids = constrain(segment_ids, ("batch", None))
    segment_ids_kv = constrain(segment_ids_kv, ("batch", None))
    kq, vq = _kv_heads_as_q(q, k), _kv_heads_as_q(q, v)
    if x.device.type == "cpu":
        out = flash_attention(q, kq, vq, segment_ids, segment_ids_kv, causal=causal,
                              window=cfg.sliding_window)
    else:  # the Hopper kernels, or a raise: never the plain version
        out = packed_ops.packed_attention(q, kq, vq, segment_ids, segment_ids_kv,
                                          causal=causal, window=cfg.sliding_window)
    out = constrain(out, ("batch", None, "heads", None))
    return _out_proj(out, p["wo"]), (k, v)


def _page_dims(pool: torch.Tensor) -> Optional[list]:
    """The mesh dims that shard a DTensor pool's pages (its dim 0), in mesh
    order (empty for a pool every rank holds whole); None for a plain
    tensor.  Any other sharded dim raises: the partial softmax below splits
    pages only."""
    if not isinstance(pool, DTensor):
        return None
    dims = []
    for m, pl in enumerate(pool.placements):
        if isinstance(pl, Shard) and pl.dim == 0:
            dims.append(m)
        elif not pl.is_replicate():
            raise ValueError(f"a paged pool of shape {tuple(pool.shape)} has placements "
                             f"{tuple(pool.placements)}; only its pages may be sharded")
    return dims


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def _first_local_page(pool: torch.Tensor, dims: list) -> int:
    """The global index of this rank's first page of a page-sharded pool
    (its shards nest in mesh-dim order, the first dim the major one)."""
    mesh, coord, idx = pool.device_mesh, pool.device_mesh.get_coordinate(), 0
    for m in dims:
        idx = idx * mesh.size(m) + coord[m]
    return idx * pool.to_local().shape[0]


def _write_local(pool: torch.Tensor, dims: list, page: torch.Tensor, slot: torch.Tensor,
                 new: torch.Tensor) -> None:
    """``pool[page, slot] = new`` (B tokens) on a DTensor pool, into each
    rank's own shard (DTensor has no layout rule for the indexed write).
    A pool held whole takes every token.  Where its pages are sharded, each
    rank writes the tokens whose page it holds; the other tokens are
    written where the first of its own goes, with its value (or, if it
    holds none, the shard's first slot with what is there already): every
    index stays in range and no two writes to one place differ, so nothing
    waits for the host."""
    if not dims:
        pool.to_local()[page, slot] = _full(new).to(pool.dtype)
        return
    local = pool.to_local().flatten(0, 1)  # (pages x slots, KVH, D), a view
    n_pages, page_size = pool.to_local().shape[:2]
    lp = page - _first_local_page(pool, dims)
    mine = (lp >= 0) & (lp < n_pages)
    flat = lp.clamp(0, n_pages - 1) * page_size + slot
    new = _full(new).to(local.dtype)
    j = mine.int().argmax().view(1)  # the first token of this rank's, if any
    have = mine.any()
    tgt = torch.where(mine, flat, torch.where(have, flat.index_select(0, j), 0))
    val = torch.where(mine[:, None, None], new,
                      torch.where(have, new.index_select(0, j), local[:1]))
    local[tgt] = val


def write_rows_local(pool: torch.Tensor, new: torch.Tensor) -> None:
    """Prefill's write of full rows into a DTensor pool: row b's S tokens
    (``new``: (B, S, KVH, D), rows laid out over the batch's mesh dims, the
    sequence whole) fill pages b P ... (b + 1) P - 1 in order (P pages a
    row; the full-rows plan of ``transformer.write_plan``), each rank
    writing into the pages it holds.

    The rank's pages must lie among its own rows' slots.  Where ``new``'s
    heads are sharded over a mesh dim that also splits those pages, the
    ranks along it trade their heads of each other's slots in one
    all-to-all: the only collective the two layouts need.  A pool every
    rank holds whole takes every row (``new`` gathered whole first)."""
    dims = _page_dims(pool)
    page_size = pool.shape[1]
    if not dims:
        new = _full(new)
        B, S = new.shape[:2]
        P = -(-S // page_size)
        flat = F.pad(new, (0, 0, 0, 0, 0, P * page_size - S)).flatten(0, 1)
        pool.to_local().flatten(0, 1)[:flat.shape[0]].copy_(flat)
        return
    mesh, coord = new.device_mesh, new.device_mesh.get_coordinate()
    row_dims, head_dims = [], []
    for m, pl in enumerate(new.placements):
        if isinstance(pl, Shard) and pl.dim == 0:
            row_dims.append(m)
        elif isinstance(pl, Shard) and pl.dim == 2:
            head_dims.append(m)
        elif not pl.is_replicate():
            raise ValueError(f"K/V of placements {tuple(new.placements)}: prefill writes "
                             f"rows sharded by batch and heads only")
    local = new.to_local()
    Bl, S = local.shape[:2]
    P = -(-S // page_size)
    row0 = 0
    for m in row_dims:
        row0 = row0 * mesh.size(m) + coord[m]
    n = pool.to_local().shape[0] * page_size            # the slots this rank holds
    off = _first_local_page(pool, dims) * page_size - row0 * Bl * P * page_size
    if off < 0 or off + n > Bl * P * page_size:
        raise ValueError(f"this rank's pages are not among its rows' slots: placements "
                         f"{tuple(pool.placements)} against {tuple(new.placements)}")
    flat = F.pad(local, (0, 0, 0, 0, 0, P * page_size - S)).flatten(0, 1)
    if not head_dims:
        mine = flat[off:off + n]
    elif head_dims == dims[-1:]:  # the ranks along it hold consecutive pages
        m = head_dims[0]
        M, j = mesh.size(m), coord[m]
        base = off - j * n                                # the group's first slot
        got = funcol.all_to_all_single(flat[base:base + M * n].contiguous(), None, None,
                                       (mesh, m))
        # got: M blocks of this rank's slots, block i holding rank i's heads
        mine = got.unflatten(0, (M, n)).transpose(0, 1).flatten(1, 2)
    else:
        raise ValueError(f"K/V heads sharded over mesh dims {head_dims}, pages over {dims}")
    pool.to_local().flatten(0, 1).copy_(mine)


def decode_attention_distributed(
    q: torch.Tensor,           # (B, H, D)
    k_pool: torch.Tensor,      # (num_pages, page_size, KVH, D), pages sharded
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, max_pages) int32, -1 = unused slot
    seq_lens: torch.Tensor,    # (B,) valid tokens per sequence
    *,
    window: int = 0,           # > 0: each sequence's last `window` tokens only
) -> Optional[torch.Tensor]:
    """Decode attention over a paged pool whose pages a mesh shards: the
    JAX package's distributed flash-decode, on pages.

    The serving layout shards the pools by page over the data and model
    axes (``distributed.sharding``: ``pages``), so a sequence's tokens lie
    on any rank, and the paged kernel, which reads whole page tables,
    cannot run on a shard.  Each rank takes q, the table and the lengths
    whole (a few MB), scores the tokens of its own pages against their
    sequence's q, and keeps per sequence the partials of an online softmax:
    the max (combined by an all-reduce max), then the sum of the weights
    and the weighted sum of the values under that max (two all-reduce
    sums), all in fp32, of (B, H)- and (B, H, D)-sized tensors.  Returns
    (B, H, D) in q's dtype, replicated; None when no mesh context is active
    or the pools' pages are not sharded (callers take the paged kernel).
    """
    dims = _page_dims(k_pool)
    if current_mesh() is None or not dims:
        return None
    qf, table, lens = _full(q).float(), _full(page_table).long(), _full(seq_lens).long()
    # the local pages as (pages, KVH, slots, D) in fp32: one pass that casts
    # and lays the products' operands out
    kl, vl = (pool.to_local().permute(0, 2, 1, 3).to(
        torch.float32, memory_format=torch.contiguous_format) for pool in (k_pool, v_pool))
    n_pages, KVH, page_size, D = kl.shape
    B, H, _ = qf.shape
    G = H // KVH
    # each local page's sequence and first position; slot n_pages takes the
    # table entries that are not this rank's
    lp = table - _first_local_page(k_pool, dims)
    mine = (table >= 0) & (lp >= 0) & (lp < n_pages)
    at = torch.where(mine, lp, n_pages).flatten()
    seq_of = torch.full((n_pages + 1,), B, dtype=torch.long, device=kl.device)
    seq_of = seq_of.scatter(0, at, torch.arange(B, device=kl.device).repeat_interleave(
        table.shape[1]))[:n_pages]
    pos0 = torch.zeros((n_pages + 1,), dtype=torch.long, device=kl.device)
    pos0 = pos0.scatter(0, at, (torch.arange(table.shape[1], device=kl.device)
                                * page_size).repeat(B))[:n_pages]
    lens_of = torch.cat([lens, lens.new_zeros(1)])[seq_of]          # 0 for no sequence
    pos = pos0[:, None] + torch.arange(page_size, device=kl.device)
    valid = pos < lens_of[:, None]
    if window > 0:  # the JAX package's window: idx >= cache_len - window
        valid &= pos >= lens_of[:, None] - window
    q_of = torch.cat([qf, qf.new_zeros(1, H, D)])[seq_of].reshape(n_pages, KVH, G, D)
    s = (q_of @ kl.transpose(-1, -2)) / math.sqrt(D)                # (pages, KVH, G, slots)
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, -torch.inf)
    mesh = k_pool.device_mesh

    def all_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
        for m in dims:
            t = funcol.all_reduce(t, op, (mesh, m))
        return t

    idx = seq_of[:, None, None].expand(n_pages, KVH, G)
    m = torch.full((B + 1, KVH, G), -torch.inf, device=kl.device)
    m = all_reduce(m.scatter_reduce(0, idx, s.amax(-1), "amax")[:B], "max")
    m = torch.cat([m, m.new_zeros(1, KVH, G)])
    p = torch.where(valid, torch.exp(s - m[seq_of][..., None]), 0.0)
    l = torch.zeros((B + 1, KVH, G), device=kl.device).index_add(0, seq_of, p.sum(-1))
    acc = torch.zeros((B + 1, KVH, G, D), device=kl.device).index_add(0, seq_of, p @ vl)
    l, acc = all_reduce(l[:B], "sum"), all_reduce(acc[:B], "sum")
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).reshape(B, H, D).to(q.dtype)
    return DTensor.from_local(out, mesh, [Replicate()] * mesh.ndim, run_check=False)


def attention_decode(
    p: Dict[str, torch.Tensor],
    cfg: Any,
    x: torch.Tensor,           # (B, 1, d)
    position: torch.Tensor,    # (B,) within-sequence position of the token
    k_pool: torch.Tensor,      # (num_pages, page_size, KVH, D), written in place
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, max_pages) int32, -1 = unused slot
    cache_len: torch.Tensor,   # (B,) int32 valid entries *including* this token
) -> torch.Tensor:
    """One decode step: write the token's K/V into its page, attend over the
    sequence's pages with the paged kernel.

    The token goes to slot ``(cache_len - 1) % page_size`` of page
    ``page_table[b, (cache_len - 1) // page_size]``, which the allocator
    gave it.  The pools are updated in place: the cache is never copied.
    With ``cfg.sliding_window`` the token attends to the last that many
    tokens (itself included), as the JAX package's decode does; the pages
    before them stay allocated, as JAX's dense cache keeps them.
    """
    B = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x)
    pos = position.reshape(B, 1)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    page_size = k_pool.shape[1]
    at = cache_len.long() - 1
    page = page_table.long().gather(1, (at // page_size)[:, None])[:, 0]
    slot = at % page_size
    dims = _page_dims(k_pool)
    if dims is None:
        k_pool[page, slot] = k[:, 0].to(k_pool.dtype)
        v_pool[page, slot] = v[:, 0].to(v_pool.dtype)
    else:  # each rank writes into its own shard
        _write_local(k_pool, dims, page, slot, k[:, 0])
        _write_local(v_pool, dims, page, slot, v[:, 0])
    return _out_proj(_paged_core(q[:, 0].to(k_pool.dtype), k_pool, v_pool, page_table,
                                 cache_len, cfg.sliding_window).to(x.dtype)[:, None],
                     p["wo"])


def _paged_core(q, k_pool, v_pool, page_table, seq_lens, window: int = 0) -> torch.Tensor:
    """The distributed flash-decode where a mesh shards the pools' pages,
    as the JAX package wires it; the paged kernel otherwise."""
    out = decode_attention_distributed(q, k_pool, v_pool, page_table, seq_lens,
                                       window=window)
    if out is None:
        if isinstance(k_pool, DTensor):  # the host's table and lengths, replicated
            mesh = k_pool.device_mesh
            page_table, seq_lens = (
                t if isinstance(t, DTensor) else
                DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
                for t in (page_table, seq_lens))
        out = paged_ops.paged_attention(q, k_pool, v_pool, page_table, seq_lens,
                                        window=window)
    return out


def cross_attention_decode(
    p: Dict[str, torch.Tensor],
    cfg: Any,
    x: torch.Tensor,           # (B, 1, d)
    k_pool: torch.Tensor,      # (num_pages, page_size, KVH, D): the cross K/V
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, max_pages) int32, -1 = unused slot
    enc_len: torch.Tensor,     # (B,) int32 valid encoder positions
) -> torch.Tensor:
    """One decode step's cross attention: the token's query (no RoPE)
    against the encoder K/V that prefill wrote into the sequence's cross
    pages, through the paged kernel, with no window (as in the JAX
    package).  Nothing is written."""
    q = _project_q(p, cfg, x)
    out = _paged_core(q[:, 0].to(k_pool.dtype), k_pool, v_pool, page_table, enc_len)
    return _out_proj(out.to(x.dtype)[:, None], p["wo"])


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg: Any, d_ff: Optional[int] = None) -> Dict[str, Spec]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "w_gate": Spec((d, f), ("embed", "mlp"), init="scaled"),
            "w_up": Spec((d, f), ("embed", "mlp"), init="scaled"),
            "w_down": Spec((f, d), ("mlp", "embed"), init="scaled"),
        }
    return {
        "w_up": Spec((d, f), ("embed", "mlp"), init="scaled"),
        "w_down": Spec((f, d), ("mlp", "embed"), init="scaled"),
    }


def mlp(p: Dict[str, torch.Tensor], cfg: Any, x: torch.Tensor) -> torch.Tensor:
    x = constrain(x, ("batch", None, None))  # the sequence gathered
    if cfg.act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")  # jax.nn.gelu's default
    h = constrain(h, ("batch", None, "mlp"))
    return h @ p["w_down"]

"""Public wrapper for packed attention: the Hopper kernels for CUDA tensors,
the plain PyTorch version for CPU tensors, both differentiable.

``packed_attention`` takes the model's layout (B, S, H, D) with separate KV
heads, in the argument order of the JAX package's wrapper.  On a CUDA
tensor it is a ``torch.autograd.Function`` whose forward launches the
forward kernel and saves each row's logsumexp, and whose backward launches
the backward kernels.  The JAX wrapper pads to block multiples with segment
0 and repeats the KV heads; the kernels mask ragged tails and index KV head
``h // (H // KVH)`` themselves, so the result is the same with neither.

On DTensors it runs shard-locally when only the batch and head dims are
sharded (``kernels/shard_local.py``; q's heads and the KV heads over the
same mesh dims) and raises on any other layout.

A tensor that does not lie on the CPU goes through the operators
``repro_torch::packed_attention_fwd`` and ``_bwd``
(``kernels/custom_ops.py``): the kernels on the card, fakes that do no work
on meta stand-ins.  Their FLOPs are the PERF.md bounds' (4 D per visible
(query, key) pair and head forward, 10 D backward) over the pairs that the
causal flag and the window leave visible in one segment a row: the
formulas see shapes, not the segment ids that make the kernels skip tiles.

``launches_fwd`` and ``launches_bwd`` count the forward and backward
launches this process made through ``packed_attention``; a run resets them
to 0 and reads them back to show that its path went through the kernels.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

from ..custom_ops import define, nbytes
from ..shard_local import any_dtensor, shard_local
from .kernel import packed_flash_attention, packed_flash_attention_bwd
from .ref import packed_attention_ref, visible_mask

__all__ = ["packed_attention", "packed_attention_plain", "launches_fwd",
           "launches_bwd"]

launches_fwd = 0
launches_bwd = 0
_count_lock = threading.Lock()


def _count(fwd: int = 0, bwd: int = 0) -> None:
    global launches_fwd, launches_bwd
    with _count_lock:
        launches_fwd += fwd
        launches_bwd += bwd


def _fwd_launch(q, k, v, seg_q, seg_kv, causal: bool, window: int):
    out, lse = packed_flash_attention(q, k, v, seg_q, seg_kv, causal=causal,
                                      window=window)
    if out.numel():  # an empty output launches nothing
        _count(fwd=1)
    return out, lse


def _bwd_launch(q, k, v, seg_q, seg_kv, out, dout, lse, causal: bool, window: int):
    dq, dk, dv = packed_flash_attention_bwd(q, k, v, seg_q, seg_kv, out, dout, lse,
                                            causal=causal, window=window)
    if dq.numel() and dk.numel():
        _count(bwd=1)
    return dq, dk, dv


def _fwd_plain(q, k, v, seg_q, seg_kv, causal: bool, window: int):
    """The forward's outputs in plain PyTorch: ``packed_attention_plain``
    and each row's logsumexp of its scaled visible scores (+inf for a row
    that sees no key, as the kernel writes it)."""
    rep = q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.repeat_interleave(rep, dim=2).float()) / math.sqrt(q.shape[3])
    mask = visible_mask(seg_q, seg_kv, causal=causal, window=window)[:, None]
    lse = torch.logsumexp(s.masked_fill(~mask, -torch.inf), dim=-1)
    lse = torch.where(mask.any(-1), lse, torch.inf)
    out = packed_attention_plain(q, k, v, seg_q, seg_kv, causal=causal, window=window)
    return out.contiguous(), lse


def _bwd_plain(q, k, v, seg_q, seg_kv, out, dout, lse, causal: bool, window: int):
    """(dq, dk, dv) of the plain version in fp32, written out (an operator's
    kernel runs below autograd): dV = P^T dO, dS = P (dO V^T - rowsum(dO V^T
    P)), dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D), each KV head's summed
    over its query heads."""
    B, Sq, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    qf = q.float().transpose(1, 2)                                  # (B, H, Sq, D)
    kf, vf = (t.float().repeat_interleave(G, dim=2).transpose(1, 2) for t in (k, v))
    mask = visible_mask(seg_q, seg_kv, causal=causal, window=window)[:, None]
    p = torch.softmax((qf @ kf.transpose(-1, -2) * scale).masked_fill(~mask, -torch.inf), -1)
    p = torch.where(torch.isnan(p), 0.0, p)
    do = dout.float().transpose(1, 2)
    dp = do @ vf.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = ds @ kf * scale
    dk, dv = ds.transpose(-1, -2) @ qf * scale, p.transpose(-1, -2) @ do

    def per_kv_head(g: torch.Tensor) -> torch.Tensor:  # (B, H, S, D) -> (B, S, KVH, D)
        return g.unflatten(1, (KVH, G)).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype).contiguous(),
            per_kv_head(dk).to(k.dtype).contiguous(), per_kv_head(dv).to(v.dtype).contiguous())


def _fwd_fake(q, k, v, seg_q, seg_kv, causal: bool, window: int):
    B, Sq, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, Sq), dtype=torch.float32)


def _bwd_fake(q, k, v, seg_q, seg_kv, out, dout, lse, causal: bool, window: int):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def visible_pairs(B: int, Sq: int, Skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs of one head that the causal flag and the
    window leave visible when each row is one segment (``ref.visible_mask``
    of all-ones ids): query i sees key j if j <= i (causal) and i - j <
    window (window > 0)."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i + 1, Skv) if causal else np.full(Sq, Skv, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(Sq, dtype=np.int64)
    return B * int(np.clip(hi - lo, 0, None).sum())


def _pairs_flops(per_pair: int, q_shape, k_shape, causal: bool, window: int) -> int:
    B, Sq, H, D = q_shape
    return per_pair * D * H * visible_pairs(B, Sq, k_shape[1], causal, window)


def _fwd_flops(q_shape, k_shape, v_shape, sq_shape, skv_shape, causal, window,
               *args, out_shape=None, **kwargs) -> int:
    return _pairs_flops(4, q_shape, k_shape, causal, window)  # QK^T and P.V


def _bwd_flops(q_shape, k_shape, v_shape, sq_shape, skv_shape, out_shape_, dout_shape,
               lse_shape, causal, window, *args, out_shape=None, **kwargs) -> int:
    return _pairs_flops(10, q_shape, k_shape, causal, window)  # S, dP, dV, dK, dQ


def _fwd_moved(q, k, v, seg_q, seg_kv, causal, window, out) -> float:
    return nbytes(q, k, v, seg_q, seg_kv, *out)


def _bwd_moved(q, k, v, seg_q, seg_kv, out, dout, lse, causal, window, grads) -> float:
    return nbytes(q, k, v, seg_q, seg_kv, out, dout, lse, *grads)


_FWD = define(
    "packed_attention_fwd",
    "(Tensor q, Tensor k, Tensor v, Tensor segment_ids_q, Tensor segment_ids_kv, "
    "bool causal, int window) -> (Tensor, Tensor)",
    cuda=_fwd_launch, cpu=_fwd_plain, fake=_fwd_fake, flops=_fwd_flops, moved=_fwd_moved)
_BWD = define(
    "packed_attention_bwd",
    "(Tensor q, Tensor k, Tensor v, Tensor segment_ids_q, Tensor segment_ids_kv, "
    "Tensor out, Tensor dout, Tensor lse, bool causal, int window) "
    "-> (Tensor, Tensor, Tensor)",
    cuda=_bwd_launch, cpu=_bwd_plain, fake=_bwd_fake, flops=_bwd_flops, moved=_bwd_moved)


class _PackedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, causal: bool, window: int):
        out, lse = _FWD(q, k, v, seg_q, seg_kv, causal, window)
        ctx.save_for_backward(q, k, v, seg_q, seg_kv, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg_q, seg_kv, out, lse = ctx.saved_tensors
        dq, dk, dv = _BWD(q, k, v, seg_q, seg_kv, out, dout.contiguous(), lse,
                          ctx.causal, ctx.window)
        return dq, dk, dv, None, None, None, None


def packed_attention_plain(q, k, v, segment_ids_q, segment_ids_kv, *,
                           causal: bool = True, window: int = 0) -> torch.Tensor:
    """The plain version in model layout, differentiable by autograd: KV
    heads repeated, ``ref.packed_attention_ref``.  The CPU path, and the
    oracle the kernels are held to on the card."""
    rep = q.shape[2] // k.shape[2]
    kf = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    vf = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    out = packed_attention_ref(
        q.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2), segment_ids_q,
        segment_ids_kv, causal=causal, window=window)
    return out.transpose(1, 2)


def packed_attention(
    q: torch.Tensor,               # (B, Sq, H, D)
    k: torch.Tensor,               # (B, Skv, KVH, D)
    v: torch.Tensor,               # (B, Skv, KVH, D)
    segment_ids_q: torch.Tensor,   # (B, Sq), 0 = padding
    segment_ids_kv: torch.Tensor,  # (B, Skv)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Segment-masked attention (see ``ref.packed_attention_ref``) in model
    layout; returns (B, Sq, H, D) in q's dtype.

    A CUDA tensor launches the kernels or raises; only a tensor that lies on
    the CPU takes the plain version.
    """
    if any_dtensor(q, k, v, segment_ids_q, segment_ids_kv):
        return shard_local(
            "packed_attention",
            lambda *a: packed_attention(*a, causal=causal, window=window),
            [("q", q, "b.h."), ("k", k, "b.h."), ("v", v, "b.h."),
             ("segment_ids_q", segment_ids_q, "b."),
             ("segment_ids_kv", segment_ids_kv, "b.")], "b.h.")
    if q.device.type == "cpu":
        return packed_attention_plain(q, k, v, segment_ids_q, segment_ids_kv,
                                      causal=causal, window=window)
    return _PackedAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(),
        segment_ids_q.to(torch.int32).contiguous(),
        segment_ids_kv.to(torch.int32).contiguous(), bool(causal), int(window))

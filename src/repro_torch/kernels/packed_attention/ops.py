"""Public wrapper for packed attention: the Hopper kernels for CUDA tensors,
the plain PyTorch version for CPU tensors, both differentiable.

``packed_attention`` takes the model's layout (B, S, H, D) with separate KV
heads, in the argument order of the JAX package's wrapper.  On a CUDA
tensor it is a ``torch.autograd.Function`` whose forward launches the
forward kernel and saves each row's logsumexp, and whose backward launches
the backward kernels.  When a backward will follow (grad mode on and an
input that requires a gradient) the forward also writes and saves the
output's residual (the fp32 output less the bf16 one), from which the
backward takes its delta = rowsum(dO * O) as the fp32 output gives it;
serving's forward writes none, and neither does an fp32 forward (its
output is the fp32 output: the residual comes back empty).  The JAX
wrapper pads to block multiples
with segment 0 and repeats the KV heads; the kernels mask ragged tails and
index KV head ``h // (H // KVH)`` themselves, so the result is the same
with neither.

On DTensors it runs shard-locally when only the batch and head dims are
sharded (``kernels/shard_local.py``; q's heads and the KV heads over the
same mesh dims) and raises on any other layout.

A tensor that does not lie on the CPU goes through the operators
``repro_torch::packed_attention_fwd`` and ``_bwd``
(``kernels/custom_ops.py``): the kernels on the card, the kernels'
arithmetic in plain PyTorch on the CPU (``ref.packed_attention_bwd_ref``),
fakes that do no work on meta stand-ins.  The forward's ``residual``
argument asks for the residual (its third output; an empty tensor
without it).  Their FLOPs are the PERF.md bounds' (4 D per visible
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
from .ref import packed_attention_bwd_ref, packed_attention_ref, visible_mask

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


def _fwd_launch(q, k, v, seg_q, seg_kv, causal: bool, window: int, residual: bool):
    out, lse, *lo = packed_flash_attention(q, k, v, seg_q, seg_kv, causal=causal,
                                           window=window, residual=residual)
    if out.numel():  # an empty output launches nothing
        _count(fwd=1)
    return out, lse, lo[0] if residual else q.new_empty(0)


def _bwd_launch(q, k, v, seg_q, seg_kv, out, out_lo, dout, lse, causal: bool, window: int):
    dq, dk, dv = packed_flash_attention_bwd(q, k, v, seg_q, seg_kv, out, out_lo, dout, lse,
                                            causal=causal, window=window)
    if dq.numel() and dk.numel():
        _count(bwd=1)
    return dq, dk, dv


def _residual(q, residual: bool) -> bool:
    """Whether the forward writes a residual: asked for, and below fp32."""
    return residual and q.dtype != torch.float32


def _fwd_plain(q, k, v, seg_q, seg_kv, causal: bool, window: int, residual: bool):
    """The forward's outputs in plain PyTorch: ``packed_attention_plain``,
    each row's logsumexp of its scaled visible scores (+inf for a row that
    sees no key, as the kernel writes it) and, with ``residual``, the fp32
    output less the rounded one, in q's dtype (empty for fp32 inputs, as
    the kernel writes none)."""
    rep = q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.repeat_interleave(rep, dim=2).float()) / math.sqrt(q.shape[3])
    mask = visible_mask(seg_q, seg_kv, causal=causal, window=window)[:, None]
    lse = torch.logsumexp(s.masked_fill(~mask, -torch.inf), dim=-1)
    lse = torch.where(mask.any(-1), lse, torch.inf)
    o32 = packed_attention_plain(q.float(), k.float(), v.float(), seg_q, seg_kv,
                                 causal=causal, window=window)
    out = o32.to(q.dtype)
    out_lo = (o32 - out.float()).to(q.dtype) if _residual(q, residual) else q.new_empty(0)
    return out.contiguous(), lse, out_lo.contiguous()


def _bwd_plain(q, k, v, seg_q, seg_kv, out, out_lo, dout, lse, causal: bool, window: int):
    """(dq, dk, dv) written out as the kernels compute them
    (``ref.packed_attention_bwd_ref``; an operator's kernel runs below
    autograd), in the inputs' dtypes."""
    dq, dk, dv = packed_attention_bwd_ref(q, k, v, seg_q, seg_kv, out, out_lo, dout, lse,
                                          causal=causal, window=window)
    return (dq.to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous())


def _fwd_fake(q, k, v, seg_q, seg_kv, causal: bool, window: int, residual: bool):
    B, Sq, H, _ = q.shape
    return (torch.empty_like(q), q.new_empty((B, H, Sq), dtype=torch.float32),
            torch.empty_like(q) if _residual(q, residual) else q.new_empty(0))


def _bwd_fake(q, k, v, seg_q, seg_kv, out, out_lo, dout, lse, causal: bool, window: int):
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


def _bwd_flops(q_shape, k_shape, v_shape, sq_shape, skv_shape, out_shape_, out_lo_shape,
               dout_shape, lse_shape, causal, window, *args, out_shape=None,
               **kwargs) -> int:
    return _pairs_flops(10, q_shape, k_shape, causal, window)  # S, dP, dV, dK, dQ


def _fwd_moved(q, k, v, seg_q, seg_kv, causal, window, residual, out) -> float:
    # out_lo: empty without the residual, and in fp32
    return nbytes(q, k, v, seg_q, seg_kv, *out)


def _bwd_moved(q, k, v, seg_q, seg_kv, out, out_lo, dout, lse, causal, window,
               grads) -> float:
    return nbytes(q, k, v, seg_q, seg_kv, out, out_lo, dout, lse, *grads)  # out_lo: empty in fp32


_FWD = define(
    "packed_attention_fwd",
    "(Tensor q, Tensor k, Tensor v, Tensor segment_ids_q, Tensor segment_ids_kv, "
    "bool causal, int window, bool residual) -> (Tensor, Tensor, Tensor)",
    cuda=_fwd_launch, cpu=_fwd_plain, fake=_fwd_fake, flops=_fwd_flops, moved=_fwd_moved)
_BWD = define(
    "packed_attention_bwd",
    "(Tensor q, Tensor k, Tensor v, Tensor segment_ids_q, Tensor segment_ids_kv, "
    "Tensor out, Tensor out_lo, Tensor dout, Tensor lse, bool causal, int window) "
    "-> (Tensor, Tensor, Tensor)",
    cuda=_bwd_launch, cpu=_bwd_plain, fake=_bwd_fake, flops=_bwd_flops, moved=_bwd_moved)


class _PackedAttention(torch.autograd.Function):
    """``residual`` is decided by the caller: grad mode is off in here."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, causal: bool, window: int, residual: bool):
        out, lse, out_lo = _FWD(q, k, v, seg_q, seg_kv, causal, window, residual)
        if residual:
            ctx.save_for_backward(q, k, v, seg_q, seg_kv, out, out_lo, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg_q, seg_kv, out, out_lo, lse = ctx.saved_tensors
        dq, dk, dv = _BWD(q, k, v, seg_q, seg_kv, out, out_lo, dout.contiguous(), lse,
                          ctx.causal, ctx.window)
        return dq, dk, dv, None, None, None, None, None


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
    residual = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return _PackedAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(),
        segment_ids_q.to(torch.int32).contiguous(),
        segment_ids_kv.to(torch.int32).contiguous(), bool(causal), int(window), residual)

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

``launches_fwd`` and ``launches_bwd`` count the forward and backward
launches this process made through ``packed_attention``; a run resets them
to 0 and reads them back to show that its path went through the kernels.
"""

from __future__ import annotations

import threading

import torch

from ..shard_local import any_dtensor, shard_local
from .kernel import packed_flash_attention, packed_flash_attention_bwd
from .ref import packed_attention_ref

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


class _PackedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, causal: bool, window: int):
        out, lse = packed_flash_attention(q, k, v, seg_q, seg_kv,
                                          causal=causal, window=window)
        if out.numel():  # an empty output launches nothing
            _count(fwd=1)
        ctx.save_for_backward(q, k, v, seg_q, seg_kv, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg_q, seg_kv, out, lse = ctx.saved_tensors
        dq, dk, dv = packed_flash_attention_bwd(
            q, k, v, seg_q, seg_kv, out, dout.contiguous(), lse,
            causal=ctx.causal, window=ctx.window)
        if dq.numel() and dk.numel():
            _count(bwd=1)
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

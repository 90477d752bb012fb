"""What the inputs need: operations and bytes, and the card's peaks.

Everything here is counted from shapes and segment ids, never from what a
kernel did, so a kernel that skips work it need not do reads faster and one
that does extra work reads slower.  The peaks are NVIDIA's data sheet for one
H100 SXM (dense, no sparsity), the figures ``repro_torch.launch.analysis.HW``
holds too.

Attention is causal inside a document: query i sees key j when both carry
the same non-zero segment id and j <= i.  A segment of m tokens thus has
m (m + 1) / 2 visible pairs whether or not its tokens are contiguous.  Per
visible pair and head the forward takes two products of D (scores and
P.V: 4 D operations), the backward five (S again, dP, dV, dK, dQ: 10 D).
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np

__all__ = ["PEAKS", "visible_pairs", "attention_fwd_ops", "attention_bwd_ops",
           "attention_fwd_bytes", "attention_bwd_bytes", "roofline_s",
           "matmul_params", "train_flops", "prefill_flops"]

PEAKS: Dict[str, float] = {
    "bf16_flops": 989e12,        # tensor cores, bf16 dense
    "hbm_bytes_per_s": 3.35e12,  # HBM3
}


def visible_pairs(segment_ids: np.ndarray) -> int:
    """Visible (query, key) pairs of causal attention inside documents over
    rows of segment ids (0 = padding), one head."""
    seg = np.asarray(segment_ids)
    seg = seg.reshape(-1, seg.shape[-1]) if seg.ndim > 1 else seg[None]
    total = 0
    for row in seg:
        m = np.bincount(row[row > 0])
        total += int((m * (m + 1) // 2).sum())
    return total


def attention_fwd_ops(segment_ids: np.ndarray, heads: int, head_dim: int) -> int:
    return 4 * head_dim * heads * visible_pairs(segment_ids)


def attention_bwd_ops(segment_ids: np.ndarray, heads: int, head_dim: int) -> int:
    return 10 * head_dim * heads * visible_pairs(segment_ids)


def attention_fwd_bytes(rows: int, seq: int, heads: int, kv_heads: int, head_dim: int,
                        itemsize: int, residual: bool) -> int:
    """Bytes the forward reads once and writes once: q, k, v and both
    segment-id arguments in; the output, its fp32 row logsumexps and, when
    a backward follows, the output's residual out."""
    q = rows * seq * heads * head_dim * itemsize
    kv = 2 * rows * seq * kv_heads * head_dim * itemsize
    seg = 2 * rows * seq * 4
    out = q * (2 if residual else 1)
    lse = rows * heads * seq * 4
    return q + kv + seg + out + lse


def attention_bwd_bytes(rows: int, seq: int, heads: int, kv_heads: int, head_dim: int,
                        itemsize: int) -> int:
    """Bytes the backward reads once and writes once: q, k, v, the segment
    ids, the output, its residual, dO and the logsumexps in; dQ, dK, dV
    out."""
    q = rows * seq * heads * head_dim * itemsize
    kv = 2 * rows * seq * kv_heads * head_dim * itemsize
    seg = 2 * rows * seq * 4
    lse = rows * heads * seq * 4
    return (q + kv + seg + 3 * q + lse) + (q + kv)


def roofline_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the memory's."""
    return max(ops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_per_s"])


def matmul_params(cfg: Dict) -> int:
    """Weights a token multiplies through in the layers (projections and
    the SwiGLU MLP), the head left out."""
    d, H, KVH = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, f = cfg["head_dim"], cfg["intermediate_size"]
    per_layer = d * H * hd + 2 * d * KVH * hd + H * hd * d + 3 * d * f
    return cfg["num_hidden_layers"] * per_layer


def _head_rows(cfg: Dict) -> int:
    return cfg.get("embedding_size", cfg["vocab_size"])


def train_flops(cfg: Dict, segment_ids: Iterable[np.ndarray],
                labels: Iterable[np.ndarray]) -> float:
    """Operations one training step needs for its real tokens: 2 per weight
    and token forward and twice that backward, the head for the tokens that
    carry a label, attention's visible pairs forward and backward.  Padding
    and recomputation count as no work."""
    L, H, hd, d = (cfg["num_hidden_layers"], cfg["num_attention_heads"], cfg["head_dim"],
                   cfg["hidden_size"])
    total = 0.0
    for seg, lab in zip(segment_ids, labels):
        real = int((np.asarray(seg) > 0).sum())
        labelled = int((np.asarray(lab) >= 0).sum())
        total += 6.0 * real * matmul_params(cfg) + 6.0 * labelled * d * _head_rows(cfg)
        total += L * (4 + 10) * hd * H * visible_pairs(seg)
    return total


def prefill_flops(cfg: Dict, prompt_lengths: Iterable[int]) -> float:
    """Operations prefill needs for its real prompt tokens: 2 per weight and
    token, attention's visible pairs, the head for each prompt's last
    token.  Padded positions count as no work."""
    L, H, hd, d = (cfg["num_hidden_layers"], cfg["num_attention_heads"], cfg["head_dim"],
                   cfg["hidden_size"])
    total = 0.0
    for n in prompt_lengths:
        total += 2.0 * n * matmul_params(cfg) + 2.0 * d * cfg["vocab_size"]
        total += L * 4 * hd * H * (n * (n + 1) // 2)
    return total

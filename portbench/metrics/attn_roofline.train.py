"""The packed-attention kernels' share of their roofline in the traced train
steps: the least time the card could take for the calls (each call the
larger of its operations over the bf16 peak and its bytes over the
memory's, counted from the step's segment ids by ``counts``) over the
device time of the forward, delta, dK/dV and dQ kernels.  Every launch
counts, the backward's recomputed forward too."""

from portbench import counts

FWD = ("packed_attn_fwd",)
BWD = ("packed_attn_delta", "packed_attn_dkdv", "packed_attn_dq")


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    fwd_s, n_fwd = tr.kernel_s(*FWD)
    bwd_s, _ = tr.kernel_s(*BWD)
    _, n_bwd = tr.kernel_s("packed_attn_dkdv")
    segs = tr.work["segment_ids"]
    if not n_fwd or not n_bwd or n_fwd % len(segs) or n_bwd % len(segs):
        return None
    c = rec.config
    H, KVH, hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    size = 2 if c["compute_dtype"] == "bfloat16" else 4
    bound = 0.0
    for seg in segs:
        B, S = seg.shape
        fwd = counts.roofline_s(counts.attention_fwd_ops(seg, H, hd),
                                counts.attention_fwd_bytes(B, S, H, KVH, hd, size, True))
        bwd = counts.roofline_s(counts.attention_bwd_ops(seg, H, hd),
                                counts.attention_bwd_bytes(B, S, H, KVH, hd, size))
        bound += n_fwd // len(segs) * fwd + n_bwd // len(segs) * bwd
    return 100.0 * bound / (fwd_s + bwd_s)

"""The packed-attention forward's share of its roofline in the traced
prefill cycle: the least time the card could take for its calls (each the
larger of its operations over the bf16 peak and its bytes over the
memory's; operations from the real prompts' visible pairs, bytes of the
padded rows the port takes) over the forward kernel's device time."""

import numpy as np

from portbench import counts


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    fwd_s, n_fwd = tr.kernel_s("packed_attn_fwd")
    batches = tr.work["lengths"]
    if not n_fwd or n_fwd % len(batches):
        return None
    c = rec.config
    H, KVH, hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    size = 2 if c["dtype"] == "bfloat16" else 4
    bound = 0.0
    for lengths in batches:
        S = max(lengths)
        seg = (np.arange(S)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
        bound += n_fwd // len(batches) * counts.roofline_s(
            counts.attention_fwd_ops(seg, H, hd),
            counts.attention_fwd_bytes(len(lengths), S, H, KVH, hd, size, False))
    return 100.0 * bound / fwd_s

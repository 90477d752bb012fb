"""Plain PyTorch version of packed flash attention.

Dense masked attention in fp32: the CPU path of ``ops.packed_attention``
and the oracle the Hopper kernels are held to on the card.  Its autograd is
the plain version of the backward kernel; ``packed_attention_bwd_ref`` is
the backward kernels' own arithmetic (P from the forward's logsumexps,
delta from its output and residual), written out in fp32, which
the operators' CPU route runs.  ``packed_attention_tf32`` and
``packed_attention_bwd_tf32`` model the float32 kernels' products on the
tensor cores (3xTF32, or one pass of plain TF32 for comparison); the tests
and the card check hold them to the reference, and no path of the port
runs them.  ``rel_l2`` is the error measure
the kernels are held to by it.  ``tile_schedule`` is the kernels' rule for
which (query tile, key tile) pairs they compute and which of those need a
mask, in plain PyTorch; ``census_rule`` is what the kernels' own count of
their tiles (``kernel.tile_census``) must equal under that rule.
"""

from __future__ import annotations

import math

import torch

__all__ = ["KERNEL_TILES", "census_rule", "packed_attention_bwd_ref",
           "packed_attention_bwd_tf32", "packed_attention_ref", "packed_attention_tf32",
           "rel_l2", "tf32_round", "tf32_split", "tile_counts", "tile_schedule",
           "tile_shares", "visible_mask"]

FULL, MASKED = "full", "masked"
# each D = 64/128 kernel's (query, key) tiles, by its name in the tile census
KERNEL_TILES = {"forward": (128, 128), "dk/dv": (64, 128), "dq": (128, 128)}


def visible_mask(segment_ids_q: torch.Tensor, segment_ids_kv: torch.Tensor, *,
                 causal: bool = True, window: int = 0) -> torch.Tensor:
    """(B, Sq, Skv) bool: query i sees key j (same nonzero segment, j <= i
    if causal, i - j < window if window > 0)."""
    Sq, Skv = segment_ids_q.shape[1], segment_ids_kv.shape[1]
    q_ids = torch.arange(Sq, device=segment_ids_q.device)[:, None]
    kv_ids = torch.arange(Skv, device=segment_ids_q.device)[None, :]
    mask = (segment_ids_q[:, :, None] == segment_ids_kv[:, None, :]) & (
        segment_ids_kv[:, None, :] != 0)
    if causal:
        mask &= (q_ids >= kv_ids)[None]
    if window > 0:
        mask &= (q_ids - kv_ids < window)[None]
    return mask


def packed_attention_ref(
    q: torch.Tensor,               # (B, H, Sq, D)
    k: torch.Tensor,               # (B, H, Skv, D)  (KV heads pre-repeated)
    v: torch.Tensor,               # (B, H, Skv, D)
    segment_ids_q: torch.Tensor,   # (B, Sq) int32, 0 = padding
    segment_ids_kv: torch.Tensor,  # (B, Skv)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    scale = 1.0 / math.sqrt(q.shape[3])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = visible_mask(segment_ids_q, segment_ids_kv, causal=causal, window=window)
    s = s.masked_fill(~mask[:, None], -torch.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)  # fully-masked rows -> zero output
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def _heads_first(q, k, v):
    """(B, S, H, D) q and (B, S, KVH, D) k, v as fp32 (B, H, S, D), the KV
    heads repeated for their G query heads."""
    G = q.shape[2] // k.shape[2]
    kf, vf = (t.float().repeat_interleave(G, dim=2).transpose(1, 2) for t in (k, v))
    return q.float().transpose(1, 2), kf, vf


def _per_kv_head(g: torch.Tensor, KVH: int) -> torch.Tensor:
    """(B, H, S, D) gradients of the G = H / KVH query heads of each KV head
    summed, as (B, S, KVH, D)."""
    return g.unflatten(1, (KVH, g.shape[1] // KVH)).sum(2).transpose(1, 2)


def packed_attention_bwd_ref(
    q: torch.Tensor,               # (B, Sq, H, D)
    k: torch.Tensor,               # (B, Skv, KVH, D)
    v: torch.Tensor,               # (B, Skv, KVH, D)
    segment_ids_q: torch.Tensor,   # (B, Sq)
    segment_ids_kv: torch.Tensor,  # (B, Skv)
    out: torch.Tensor,             # (B, Sq, H, D) the forward's output
    out_lo: torch.Tensor,          # (B, Sq, H, D) the fp32 output less out, or empty
    dout: torch.Tensor,            # (B, Sq, H, D)
    lse: torch.Tensor,             # (B, H, Sq) the forward's logsumexps
    *,
    causal: bool = True,
    window: int = 0,
):
    """(dq, dk, dv) in fp32 and model layout, computed as the backward
    kernels compute them: P = exp(S / sqrt(D) - lse) on the visible pairs,
    dP = dO V^T, delta = rowsum(dO * (out + out_lo)), dS = P (dP - delta),
    dV = P^T dO, dK = dS^T Q / sqrt(D), dQ = dS K / sqrt(D), each KV head's
    summed over its G = H / KVH query heads.  With ``out_lo`` zero, delta
    comes from the rounded output alone; an empty ``out_lo`` (the fp32
    forward writes none) takes delta from ``out`` itself."""
    D = q.shape[3]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf = _heads_first(q, k, v)                              # (B, H, S, D)
    mask = visible_mask(segment_ids_q, segment_ids_kv, causal=causal, window=window)[:, None]
    s = qf @ kf.transpose(-1, -2) * scale
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
    do = dout.float().transpose(1, 2)
    o = (out.float() + out_lo.float() if out_lo.numel() else out.float()).transpose(1, 2)
    delta = (do * o).sum(-1, keepdim=True)
    ds = p * (do @ vf.transpose(-1, -2) - delta)
    dq = ds @ kf * scale
    dk, dv = ds.transpose(-1, -2) @ qf * scale, p.transpose(-1, -2) @ do
    KVH = k.shape[2]
    return dq.transpose(1, 2), _per_kv_head(dk, KVH), _per_kv_head(dv, KVH)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    10 explicit mantissa bits, to nearest with ties away from zero, the low
    13 bits of the pattern zero (subnormals keep their scale; a value past
    the largest TF32 rounds to infinity); infinities and NaNs pass
    through.  Bit arithmetic on the int32 view: the sign-magnitude pattern
    plus half the dropped part rounds the magnitude away from zero."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    finite = (bits & 0x7F800000) != 0x7F800000
    return torch.where(finite, rounded, bits).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi), the two parts the float32
    kernels store for the tensor cores (x - hi is exact in fp32)."""
    hi = tf32_round(x)
    return hi, tf32_round(x.to(torch.float32) - hi)


def _tf32_mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the tensor cores take it from split operands, summed in fp32:
    3 passes lo.hi + hi.lo + hi.hi (3xTF32), or 1 pass hi.hi (plain TF32)."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    if passes == 1:
        return a_hi @ b_hi
    if passes != 3:
        raise ValueError(f"passes is 1 or 3, got {passes}")
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def packed_attention_tf32(
    q: torch.Tensor,               # (B, Sq, H, D)
    k: torch.Tensor,               # (B, Skv, KVH, D)
    v: torch.Tensor,               # (B, Skv, KVH, D)
    segment_ids_q: torch.Tensor,   # (B, Sq)
    segment_ids_kv: torch.Tensor,  # (B, Skv)
    *,
    causal: bool = True,
    window: int = 0,
    passes: int = 3,
):
    """(out (B, Sq, H, D), lse (B, H, Sq)) of the float32 forward with its
    products, S = Q K^T and P.V (P unnormalised, as the kernel holds it), on
    TF32-split operands (``_tf32_mm``); the softmax, masks and sums in fp32.
    A row that sees no key gives 0 and lse +inf."""
    qf, kf, vf = _heads_first(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[3])
    mask = visible_mask(segment_ids_q, segment_ids_kv, causal=causal, window=window)[:, None]
    s = torch.where(mask, _tf32_mm(qf, kf.transpose(-1, -2), passes) * scale, -torch.inf)
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isinf(m), 0.0, m)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = _tf32_mm(p, vf, passes) / torch.where(l > 0, l, 1.0)
    lse = torch.where(l > 0, m + torch.log(l), torch.inf)[..., 0]
    return out.transpose(1, 2).contiguous(), lse


def packed_attention_bwd_tf32(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids_q: torch.Tensor,
    segment_ids_kv: torch.Tensor,
    out: torch.Tensor,             # (B, Sq, H, D) the fp32 output
    dout: torch.Tensor,            # (B, Sq, H, D)
    lse: torch.Tensor,             # (B, H, Sq)
    *,
    causal: bool = True,
    window: int = 0,
    passes: int = 3,
):
    """(dq, dk, dv) of the float32 backward in model layout:
    ``packed_attention_bwd_ref``'s arithmetic (delta = rowsum(dO * out) in
    fp32) with its five products, S, dP = dO V^T, dQ = dS K, dK = dS^T Q and
    dV = P^T dO, on TF32-split operands."""
    qf, kf, vf = _heads_first(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[3])
    mask = visible_mask(segment_ids_q, segment_ids_kv, causal=causal, window=window)[:, None]
    s = _tf32_mm(qf, kf.transpose(-1, -2), passes) * scale
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
    do = dout.float().transpose(1, 2)
    delta = (do * out.float().transpose(1, 2)).sum(-1, keepdim=True)
    ds = p * (_tf32_mm(do, vf.transpose(-1, -2), passes) - delta)
    dq = _tf32_mm(ds, kf, passes) * scale
    dk = _tf32_mm(ds.transpose(-1, -2), qf, passes) * scale
    dv = _tf32_mm(p.transpose(-1, -2), do, passes)
    KVH = k.shape[2]
    return dq.transpose(1, 2), _per_kv_head(dk, KVH), _per_kv_head(dv, KVH)


def rel_l2(got: torch.Tensor, want: torch.Tensor, block: int = 64):
    """(||got - want|| / ||want||, the same ratio's largest value over the
    blocks of ``block`` rows along dim 1 and one head along dim 2), in fp32.

    For (B, S, H, D) tensors the blocks are the kernels' 64-row tiles, so an
    error confined to one tile of one head shows at its own scale, however
    small the tile's entries are beside the tensor's largest.  A block whose
    reference is all zero reads 0 if ``got`` is zero there too, else inf.
    ``block=0`` gives the whole tensor's ratio twice (for tensors of other
    layouts, such as weight gradients).
    """
    err, ref = (got.float() - want.float()), want.float()

    def ratio(e2: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
        return torch.where(r2 > 0, (e2 / torch.where(r2 > 0, r2, 1.0)).sqrt(),
                           torch.where(e2 > 0, torch.inf, 0.0))

    whole = ratio(err.square().sum(), ref.square().sum()).item()
    if block == 0:
        return whole, whole
    B, S = err.shape[:2]
    pad = (-S) % block
    err, ref = err.reshape(B, S, err.shape[2], -1), ref.reshape(B, S, ref.shape[2], -1)
    if pad:
        err = torch.nn.functional.pad(err, (0, 0, 0, 0, 0, pad))
        ref = torch.nn.functional.pad(ref, (0, 0, 0, 0, 0, pad))
    shape = (B, (S + pad) // block, block, err.shape[2], err.shape[3])
    blocks = ratio(err.reshape(shape).square().sum((2, 4)),
                   ref.reshape(shape).square().sum((2, 4)))
    return whole, blocks.max().item()


def _summaries(seg: torch.Tensor, tile: int):
    """Per tile of ``tile`` rows of a (S,) row of ids (rows past S read as
    0): (lo, hi) of its nonzero ids (hi = 0 if none) and whether all its
    ids are one nonzero id."""
    S = seg.shape[0]
    n = -(-S // tile)
    ids = torch.zeros(n * tile, dtype=torch.int64)
    ids[:S] = seg.to(torch.int64).cpu()
    ids = ids.reshape(n, tile)
    nz = ids != 0
    big = torch.iinfo(torch.int64).max
    lo = torch.where(nz, ids, big).min(dim=1).values
    hi = ids.max(dim=1).values
    uniform = nz.all(dim=1) & (lo == hi)
    return lo.tolist(), hi.tolist(), uniform.tolist()


def _key_range(q0: int, bq: int, bk: int, Skv: int, causal: bool, window: int):
    """The key tiles a query tile [q0, q0 + bq) can see: from the window's
    first to the causal diagonal."""
    end = -(-Skv // bk)
    if causal:
        end = min(end, (q0 + bq - 1) // bk + 1)
    lo = q0 - window + 1  # the first key the tile's first query sees
    begin = lo // bk if window > 0 and lo > 0 else 0
    return begin, max(end, begin)


def tile_schedule(seg_q: torch.Tensor, seg_kv: torch.Tensor, bq: int, bk: int, *,
                  causal: bool = True, window: int = 0):
    """The pairs of (bq-query tile, bk-key tile) the packed kernels compute.

    For each row of the batch and each query tile, the kept key tiles in the
    causal/window range as ``(key tile, class)``: a tile is skipped when the
    nonzero segment ids of the two tiles do not overlap (no pair of it can
    be visible); it is ``FULL`` when both tiles hold one nonzero segment id,
    the same, and the pair lies wholly inside the causal and window limits
    (every pair is visible: the kernel applies no mask); ``MASKED``
    otherwise.  Rows past the end read as segment 0.  The kernels
    (``csrc/packed_attention.cu``: ``pair_class``, ``key_range``,
    ``query_range``) apply the same rule: the forward and dQ with 128 x 128
    tiles, dK/dV with 64 queries by 128 keys.
    """
    B, Sq = seg_q.shape
    Skv = seg_kv.shape[1]
    out = []
    for b in range(B):
        qlo, qhi, quni = _summaries(seg_q[b], bq)
        klo, khi, kuni = _summaries(seg_kv[b], bk)
        row = []
        for qt in range(len(qlo)):
            q0 = qt * bq
            begin, end = _key_range(q0, bq, bk, Skv, causal, window)
            kept = []
            for kt in range(begin, end):
                k0 = kt * bk
                if qhi[qt] == 0 or khi[kt] == 0 or qhi[qt] < klo[kt] or khi[kt] < qlo[qt]:
                    continue
                inside = ((not causal or k0 + bk - 1 <= q0)
                          and (window <= 0 or q0 + bq - 1 - k0 < window))
                full = quni[qt] and kuni[kt] and qlo[qt] == klo[kt] and inside
                kept.append((kt, FULL if full else MASKED))
            row.append(kept)
        out.append(row)
    return out


def tile_counts(seg_q: torch.Tensor, seg_kv: torch.Tensor, bq: int, bk: int, *,
                causal: bool = True, window: int = 0):
    """The counts of the tile pairs in the kernels' causal/window range that
    ``tile_schedule`` skips, computes masked and computes unmasked: per
    head, what the kernels' tile census (``kernel.tile_census``) counts."""
    Sq, Skv = seg_q.shape[1], seg_kv.shape[1]
    total = seg_q.shape[0] * sum(
        end - begin for begin, end in (_key_range(qt * bq, bq, bk, Skv, causal, window)
                                       for qt in range(-(-Sq // bq))))
    counts = {FULL: 0, MASKED: 0}
    for row in tile_schedule(seg_q, seg_kv, bq, bk, causal=causal, window=window):
        for kept in row:
            for _, c in kept:
                counts[c] += 1
    return {"skipped": total - counts[FULL] - counts[MASKED], "masked": counts[MASKED],
            "full": counts[FULL]}


def census_rule(seg_q: torch.Tensor, seg_kv: torch.Tensor, H: int, KVH: int, *,
                causal: bool = True, window: int = 0):
    """What the kernels' tile census (``kernel.tile_census``) counts over one
    forward and one backward: ``tile_counts`` at each kernel's tiles, once
    per head (per KV head in dK/dV, whose blocks serve a KV head's G query
    heads)."""
    return {kern: {c: n * (KVH if kern == "dk/dv" else H)
                   for c, n in tile_counts(seg_q, seg_kv, bq, bk, causal=causal,
                                           window=window).items()}
            for kern, (bq, bk) in KERNEL_TILES.items()}


def tile_shares(counts):
    """Tile counts (``tile_counts``, or a kernel's census) as the shares of
    their total skipped, full and masked, with the total."""
    total = sum(counts.values())
    share = (lambda x: x / total) if total else (lambda x: 0.0)
    return {"skipped": share(counts["skipped"]), "full": share(counts["full"]),
            "masked": share(counts["masked"]), "tiles": total}

#!/usr/bin/env python3
"""How the packed kernels' roundings move dQ, modelled in fp64 on the CPU.

A row of dS = P (dP - delta) sums to (exact delta - the delta used), and
dQ = dS K / sqrt(D) carries that sum times the keys' mean: where keys hold
most of their energy in one mean per document (seamless-m4t-medium's
encoder output), the delta has to be nearly exact.  This models the
kernels' arithmetic on a cross attention with such keys (and values) and
prints dQ's relative l2 to the exact gradient, in fp64, for the outputs
delta can be taken from:

- ``exact``: the exact output;
- ``bf16 output``: the forward's bf16 output alone;
- ``fp32 output``: the forward's fp32 output, P rounded to bf16 for P V
  (as an online softmax over tiles of 128 keys in base 2 rounds it), to
  bf16 and its rounding residual;
- ``renormalised``: that output with P's rounded weights summing to one
  (``csrc/packed_attention.cu``: what the forward's residual carries).

Each rounds dS to bf16 for dS K, as the kernels do.  Inputs are bf16
values drawn from ``--seed``: queries scaled by ``--q-scale``, keys and
values unit noise plus one mean per document of ``--keys-mean`` and
``--values-mean`` times unit noise.  Run from the root of a checkout:

    python3 tools/delta_rounding_probe.py [--keys-mean 4] [--values-mean 2]
"""

from __future__ import annotations

import argparse
import json
import math

import torch


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).double()


def _rounded_weights(s: torch.Tensor, tile: int):
    """The weights P V takes, rescaled to the row's final max, as an online
    softmax over key tiles rounds them (base 2), with the row sums of the
    unrounded (l) and the rounded (lt) weights."""
    m = torch.full(s.shape[:-1], -math.inf, dtype=torch.float64)
    tiles = []
    for t0 in range(0, s.shape[-1], tile):
        st = s[..., t0:t0 + tile] * math.log2(math.e)
        m = torch.maximum(m, st.amax(-1))
        tiles.append((t0, torch.nan_to_num(torch.exp2(st - m[..., None])), m.clone()))
    w = torch.zeros_like(s)
    l, lt = torch.zeros_like(m), torch.zeros_like(m)
    for t0, p, mt in tiles:
        scale = torch.exp2(mt - m)[..., None]
        w[..., t0:t0 + p.shape[-1]] = _bf16(p) * scale
        l += (p * scale).sum(-1)
        lt += (_bf16(p) * scale).sum(-1)
    return w, l, lt


def probe(B=2, Sq=512, Skv=1024, H=16, D=64, keys_mean=4.0, values_mean=2.0,
          q_scale=0.125, seed=1, tile=128):
    """dQ's relative l2 to the exact gradient for each choice of delta, and
    the share of the keys' energy in their documents' means."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)

    seg_q, seg_kv = torch.ones(B, Sq, dtype=torch.int32), torch.ones(B, Skv, dtype=torch.int32)
    for b in range(B):  # two documents a side
        seg_q[b, Sq * (b + 1) // (B + 1):] = 2
        seg_kv[b, Skv * (b + 1) // (B + 1):] = 2
    q, k, v, do = randn(B, Sq, H, D) * q_scale, randn(B, Skv, H, D), randn(B, Skv, H, D), \
        randn(B, Sq, H, D)
    for b in range(B):
        for sid in (1, 2):
            m = seg_kv[b] == sid
            k[b, m] += keys_mean * randn(1, H, D)
            v[b, m] += values_mean * randn(1, H, D)
    q, k, v, do = _bf16(q), _bf16(k), _bf16(v), _bf16(do)
    mask = (seg_q[:, :, None] == seg_kv[:, None, :])[:, None]
    s = (torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)).masked_fill(~mask, -math.inf)
    p = torch.softmax(s, -1)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)

    def dq_with(o: torch.Tensor, round_ds: bool = True) -> torch.Tensor:
        delta = (do * o).sum(-1).transpose(1, 2)[..., None]
        ds = p * (dp - delta)
        return torch.einsum("bhqk,bkhd->bqhd", _bf16(ds) if round_ds else ds, k) / math.sqrt(D)

    exact_o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    truth = dq_with(exact_o, round_ds=False)
    w, l, lt = _rounded_weights(s, tile)
    pv = torch.einsum("bhqk,bkhd->bqhd", w, v)
    o32 = pv / l.transpose(1, 2)[..., None]
    hi = _bf16(o32)
    centred = k.clone()
    for b in range(B):
        for sid in (1, 2):
            m = seg_kv[b] == sid
            centred[b, m] -= k[b, m].mean(0)
    rel = {name: ((dq_with(o) - truth).norm() / truth.norm()).item() for name, o in (
        ("exact", exact_o), ("bf16 output", hi), ("fp32 output", hi + _bf16(o32 - hi)),
        ("renormalised", pv / lt.transpose(1, 2)[..., None]))}
    return {"dq_rel_l2": rel,
            "key_mean_energy_share": 1.0 - (centred.norm() / k.norm()).item() ** 2}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keys-mean", type=float, default=4.0)
    ap.add_argument("--values-mean", type=float, default=2.0)
    ap.add_argument("--q-scale", type=float, default=0.125)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    print(json.dumps(probe(keys_mean=args.keys_mean, values_mean=args.values_mean,
                           q_scale=args.q_scale, seed=args.seed)))


if __name__ == "__main__":
    main()

"""Mixture-of-Experts layer with capacity-binned dispatch.

The dispatch is the paper's technique applied at the token level: experts
are *bins* with a fixed capacity (``capacity_factor * tokens * top_k / E``
slots, rounded up to an aligned multiple), and routed tokens are *items*
packed into them.  Tokens that overflow an expert's bin are dropped
(GShard-style), exactly like a worker that cannot fit another PE.

The dispatch is sort-based, as in the JAX package: flatten the (token,
expert) assignments, sort them by expert (a stable sort, so a bin keeps its
tokens in token order and the same tokens overflow), give each its position
in its expert's bin by a count per expert, scatter into an ``(E, C, d)``
buffer, run the expert FFNs, and combine back with the router's gates.

The dispatch is group-local, as in the JAX package: the tokens split into G
groups along the batch dim, G being the number of batch shards of the
active mesh layout (``distributed.context.batch_shard_count``; G = 1 with
no mesh context).  Each group routes, sorts and fills its own capacity
bins (the capacity is per group: each shard drops its own overflow), which
the port computes as one dispatch over G x E bins.  On DTensors the
dispatch and the combine run on each rank's own groups (the router
gathered whole), and only the expert FFN between them runs as DTensor
products laid out by the rules.  On the card a SwiGLU
layer with G = 1 runs its experts through
the grouped-matmul kernel (``kernels.grouped_matmul.ops.expert_ffn_swiglu``),
whose tiles take 128-row bins; elsewhere the experts are a batched product
over 8-aligned bins, as the JAX package computes them off the TPU.  The
capacity, and with it which tokens overflow, follows the route.

Nothing in the dispatch reads a tensor back to the host.  The combine
gathers each token's K expert outputs back into ``(T, K, d)`` and sums them
in fp32 by a reduction over K, which uses no atomics: a second run on the
same inputs gives the same bits.  (The JAX package scatter-adds the
contributions in the working type; in fp32 the two agree to rounding.)
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..distributed.context import batch_shard_count, constrain
from ..kernels.grouped_matmul.ops import expert_ffn_swiglu
from .params import Spec

__all__ = ["moe_specs", "moe_layer", "expert_capacity"]


def expert_capacity(
    num_tokens: int, num_experts: int, top_k: int, factor: float,
    align: int = 128,
) -> int:
    """Capacity per expert bin, rounded up to an ``align`` multiple: 128 for
    the grouped-matmul kernel's row tiles, 8 for the batched product."""
    raw = int(math.ceil(num_tokens * top_k * factor / num_experts))
    return max(align, ((raw + align - 1) // align) * align)


def _top_k_iterative(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last dim as the JAX package takes it: k passes of
    argmax, each masking its pick to -inf.  ``argmax`` takes the first of
    equal maxima, so ties go to the lower expert and the picks come in
    descending order (``torch.topk`` orders ties otherwise).  Returns
    (values, int32 indices), each ``(..., k)``."""
    masked = probs
    vals, idxs = [], []
    for _ in range(k):
        i = masked.argmax(dim=-1, keepdim=True)
        vals.append(masked.gather(-1, i))
        idxs.append(i.to(torch.int32))
        masked = masked.scatter(-1, i, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def moe_specs(cfg: Any) -> Dict[str, Spec]:
    assert cfg.moe is not None
    d, e, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.expert_d_ff
    specs = {
        "router": Spec((d, e), ("embed", None), init="scaled"),
        "w_up": Spec((e, d, f), ("experts", "embed", "mlp"), init="scaled"),
        "w_down": Spec((e, f, d), ("experts", "mlp", "embed"), init="scaled"),
    }
    if cfg.act == "swiglu":
        specs["w_gate"] = Spec((e, d, f), ("experts", "embed", "mlp"), init="scaled")
    return specs


def moe_layer(
    p: Dict[str, torch.Tensor],
    cfg: Any,
    x: torch.Tensor,  # (B, S, d)
    *,
    use_gmm_kernel: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Top-k routed MoE with capacity bins.  Returns (out (B, S, d), aux
    losses).  Every token is routed, padding included, and takes capacity,
    as in the JAX package."""
    mcfg = cfg.moe
    B, S, d = x.shape
    E, K = mcfg.num_experts, mcfg.top_k
    T = B * S
    G = batch_shard_count(B)
    Tg = (B // G) * S
    # the kernel route wherever a kernel wrapper takes it: every tensor that
    # does not lie on the CPU (the card, and a dry-run's meta stand-ins)
    kernel_path = (use_gmm_kernel and cfg.act == "swiglu" and x.device.type != "cpu"
                   and G == 1)
    C = expert_capacity(Tg, E, K, mcfg.capacity_factor, align=128 if kernel_path else 8)
    x = constrain(x, ("batch", None, None))  # the sequence gathered
    xg = constrain(x.reshape(G, Tg, d), ("batch", None, None))
    router = p["router"]
    lay = None  # on DTensors: (mesh, the groups' placements)
    if isinstance(xg, DTensor):
        # each rank dispatches its own groups: groups over the batch mesh
        # dims, whole on the others
        lay = (xg.device_mesh, [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
                                for pl in xg.placements])
        xg = xg.redistribute(*lay).to_local()
        router = router.full_tensor() if isinstance(router, DTensor) else router
        G = xg.shape[0]
        T = G * Tg
    xt = xg.reshape(T, d)

    # ---- routing and capacity-bin packing, per group -------------------------
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k_iterative(probs, K)  # (T, K)
    # renormalize the selected gates (Mixtral/Qwen convention)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp(min=1e-9)

    # bin g * E + e is expert e's bin of group g: token t is in group t // Tg
    group = torch.arange(T * K, device=x.device) // (Tg * K)
    flat_bin = group * E + expert_idx.reshape(-1).long()    # (T*K,)
    order = torch.argsort(flat_bin, stable=True)          # sort by destination
    sorted_bin = flat_bin[order]
    sorted_token = order // K
    counts = torch.zeros(G * E, dtype=torch.int32, device=x.device).index_add_(
        0, flat_bin, torch.ones_like(flat_bin, dtype=torch.int32))
    starts = torch.cumsum(counts, 0) - counts             # exclusive prefix sum
    pos_in_bin = torch.arange(T * K, device=x.device) - starts[sorted_bin]
    keep = pos_in_bin < C                                 # bin overflow -> drop
    dest = torch.where(keep, sorted_bin * C + pos_in_bin, G * E * C)
    buf = xt.new_zeros((G * E * C + 1, d))
    buf[dest] = xt[sorted_token]                          # the last row takes the drops
    # (G, E, C, d): groups over the batch axes, experts over model
    buf = buf[:G * E * C].view(G, E, C, d)
    if lay is not None:
        buf = DTensor.from_local(buf, *lay, run_check=False)
    buf = constrain(buf, ("batch", "experts", None, None))

    # ---- the expert FFN ------------------------------------------------------
    if kernel_path:
        sizes = counts.clamp(max=C)
        if lay is not None:  # one group, the same on every rank: laid out as the experts
            sizes = constrain(DTensor.from_local(sizes, lay[0], [Replicate()] * lay[0].ndim,
                                                 run_check=False), ("experts",))
        out_buf = expert_ffn_swiglu(buf[0], p["w_gate"], p["w_up"], p["w_down"], sizes)[None]
    else:
        if cfg.act == "swiglu":
            h = F.silu(torch.einsum("gecd,edf->gecf", buf, p["w_gate"])) * torch.einsum(
                "gecd,edf->gecf", buf, p["w_up"])
        else:  # jax.nn.gelu's default is the tanh form
            h = F.gelu(torch.einsum("gecd,edf->gecf", buf, p["w_up"]), approximate="tanh")
        h = constrain(h, ("batch", "experts", None, "mlp"))
        out_buf = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    out_buf = constrain(out_buf, ("batch", "experts", None, None))
    if lay is not None:
        out_buf = out_buf.redistribute(*lay).to_local()

    # ---- combine: each token's K contributions, summed in fp32 --------------
    gathered = out_buf.reshape(G * E * C, d)[torch.where(keep, dest, 0)].float()
    gates_sorted = gate_vals.reshape(-1)[order]
    contrib = torch.where(keep[:, None], gathered * gates_sorted[:, None], 0.0)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(T * K, device=x.device)
    out = contrib[inverse].view(T, K, d).sum(dim=1).to(x.dtype)
    out = out.view(G, Tg, d)
    if lay is not None:
        out = DTensor.from_local(out, *lay, run_check=False)
    out = constrain(out, ("batch", None, None))

    # ---- aux losses ----------------------------------------------------------
    # Switch-style load balance: E * sum_e (fraction_e * prob_e), averaged
    # over groups (the global statistic when groups are equal-sized)
    frac = counts.view(G, E).float() / max(1, Tg * K)
    mean_prob = probs.view(G, Tg, E).mean(dim=1)
    lb_g = torch.sum(frac * mean_prob, dim=-1)                        # (G,)
    z_g = torch.logsumexp(logits, dim=-1).square().view(G, Tg).mean(dim=1)
    drop_g = (~keep).view(G, Tg * K).sum(dim=1)
    if lay is not None:  # each rank's groups, averaged over every group
        lb_g, z_g, drop_g = (DTensor.from_local(t, *lay, run_check=False)
                             for t in (lb_g, z_g, drop_g))
    lb_loss = E * torch.mean(lb_g)
    z_loss = z_g.mean()
    dropped = drop_g.sum() / max(1, B * S * K)
    aux = {
        "moe_load_balance": lb_loss * mcfg.load_balance_loss,
        "moe_z_loss": z_loss * mcfg.router_z_loss,
        "moe_drop_fraction": dropped,
    }
    return out.reshape(B, S, d), aux

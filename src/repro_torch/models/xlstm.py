"""xLSTM blocks, mLSTM (matrix memory) and sLSTM (scalar memory), in plain
PyTorch.

The JAX package's formulation: exponential gating with the max-state
stabilizer, the recurrences in fp32 through the chunked, remat-bounded
scan (``scan_utils.chunked_scan``).  The mLSTM's per-head state is a (dh x
dh) matrix (linear-attention form), the sLSTM's a per-unit scalar triple
with per-head hidden feedback.  Decode carries the states: O(1) per token.
Segment ids play no part, as in the JAX package.

Block structure (xLSTM paper Fig. 9/10, simplified):
  mLSTM block: up-proj (2x) -> [path: causal conv -> silu -> q, k;  v]
               -> mLSTM -> headwise RMS norm -> (* silu(gate)) -> down-proj
  sLSTM block: sLSTM -> headwise RMS norm -> gated FFN (factor 4/3)
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.context import constrain
from ..kernels.shard_local import any_dtensor, shard_local
from .layers import flatten_heads, heads_product, rms_norm
from .params import Spec
from .scan_utils import chunked_scan
from .ssm import causal_depthwise_conv

__all__ = [
    "mlstm_specs",
    "mlstm_forward",
    "mlstm_decode_step",
    "mlstm_init_state",
    "slstm_specs",
    "slstm_forward",
    "slstm_decode_step",
    "slstm_init_state",
]

State = Dict[str, torch.Tensor]


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -F.softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm_dims(cfg: Any) -> Tuple[int, int, int]:
    du = int(cfg.xlstm.m_proj_factor * cfg.d_model)
    H = cfg.n_heads
    return du, H, du // H


def mlstm_specs(cfg: Any) -> Dict[str, Spec]:
    d = cfg.d_model
    du, H, dh = _mlstm_dims(cfg)
    k = cfg.xlstm.conv_kernel
    return {
        "up": Spec((d, 2 * du), ("embed", "mlp"), init="scaled"),
        "conv_w": Spec((k, du), (None, "mlp"), init="scaled"),
        "conv_b": Spec((du,), ("mlp",), init="zeros"),
        "wq": Spec((du, H, dh), ("mlp", "heads", "head_dim"), init="scaled"),
        "wk": Spec((du, H, dh), ("mlp", "heads", "head_dim"), init="scaled"),
        "wv": Spec((du, H, dh), ("mlp", "heads", "head_dim"), init="scaled"),
        "wi": Spec((du, H), ("mlp", "heads"), init="scaled"),
        "wf": Spec((du, H), ("mlp", "heads"), init="scaled"),
        "bi": Spec((H,), ("heads",), init="zeros"),
        "bf": Spec((H,), ("heads",), init="ones"),  # bias toward remembering
        "out_norm": Spec((dh,), ("head_dim",), init="zeros"),
        "down": Spec((du, d), ("mlp", "embed"), init="scaled"),
    }


def _state_inputs(state: State, names: Tuple[str, ...]) -> List[Tuple[str, Any, str]]:
    """A carried state's recurrent leaves as ``shard_local`` inputs, laid
    out as ``cache_shardings`` lays them: batch, then heads."""
    return [(n, constrain(state[n], ("batch", "heads") + (None,) * (state[n].dim() - 2)),
             "bh" + "." * (state[n].dim() - 2)) for n in names]


def _mlstm_scan(q, k, v, ig, fg, state: Optional[State],
                chunk_size: int) -> Tuple[torch.Tensor, State]:
    """q, k, v: (B, S, H, dh); ig, fg: (B, S, H) raw gate logits; ``state``
    None starts from the initial state.

    On DTensors it runs on each rank's own rows and heads
    (``kernels/shard_local.py``): a step is elementwise over the batch and
    the heads, so each rank's shard is a whole scan of its own, its state
    made there; the inputs are laid out by batch and heads first (once a
    layer), where a step would otherwise reduce a partial sum every step."""
    names = ("C", "n", "m")
    if any_dtensor(q, k, v, ig, fg):
        bh = ("batch", None, "heads", None)
        ins = [(n, constrain(t, bh), "b.h.") for n, t in (("q", q), ("k", k), ("v", v))]
        ins += [(n, constrain(t, bh[:3]), "b.h") for n, t in (("ig", ig), ("fg", fg))]
        if state is not None:
            ins += _state_inputs(state, names)

        def local(q, k, v, ig, fg, *st):
            h, out = _mlstm_scan(q, k, v, ig, fg, dict(zip(names, st)) if st else None,
                                 chunk_size)
            return (h,) + tuple(out[n] for n in names)

        h, *st = shard_local("mlstm scan", local, ins, ("b.h.", "bh..", "bh.", "bh"))
        return h, dict(zip(names, st))
    B, _, H, dh = q.shape
    if state is None:
        state = _mlstm_fresh(B, H, dh, q.device)
    scale = 1.0 / math.sqrt(dh)

    def step(carry, xs):
        C, n, m = carry  # (B, H, dh, dh), (B, H, dh), (B, H)
        q_t, k_t, v_t, i_t, f_t = xs
        logf = _log_sigmoid(f_t)
        m_new = torch.maximum(logf + m, i_t)
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(logf + m - m_new)
        C = f_p[..., None, None] * C + i_p[..., None, None] * (
            v_t[..., :, None] * k_t[..., None, :] * scale)
        n = f_p[..., None] * n + i_p[..., None] * k_t * scale
        num = (C * q_t[..., None, :]).sum(-1)  # (B, H, dh); merges no dims
        den = torch.maximum((n * q_t).sum(-1).abs(), torch.exp(-m_new))
        return (C, n, m_new), num / den[..., None]

    xs = tuple(a.float().transpose(0, 1) for a in (q, k, v, ig, fg))  # time-major
    (C, n, m), hs = chunked_scan(step, (state["C"], state["n"], state["m"]), xs,
                                 chunk_size=chunk_size)
    return hs.transpose(0, 1), {"C": C, "n": n, "m": m}  # (B, S, H, dh)


def mlstm_forward(
    p: Dict[str, torch.Tensor],
    cfg: Any,
    x: torch.Tensor,
    *,
    state: Optional[State] = None,
    chunk_size: int = 128,
) -> Tuple[torch.Tensor, State]:
    S = x.shape[1]
    x = constrain(x, ("batch", None, None))  # the sequence gathered
    up = constrain(x @ p["up"], ("batch", None, "mlp"))
    xm, z = up.chunk(2, dim=-1)  # (B, S, du)
    if state is None:
        conv_in, trim = xm, 0
    else:
        conv_in = torch.cat([state["conv"].to(xm.dtype), xm], dim=1)
        trim = state["conv"].shape[1]
    c = F.silu(causal_depthwise_conv(conv_in, p["conv_w"], p["conv_b"])[:, trim:])

    q, k = heads_product(c, p["wq"]), heads_product(c, p["wk"])
    v = heads_product(xm, p["wv"])
    ig = c @ p["wi"] + p["bi"]
    fg = c @ p["wf"] + p["bf"]
    h, new_inner = _mlstm_scan(q, k, v, ig, fg, state, chunk_size)
    h = flatten_heads(rms_norm(h, p["out_norm"])).to(x.dtype)  # (B, S, du)
    out = (h * F.silu(z)) @ p["down"]
    kk = cfg.xlstm.conv_kernel - 1
    if S >= kk:
        tail = xm[:, -kk:]
    elif state is None:
        tail = F.pad(xm, (0, 0, kk - S, 0))
    else:
        tail = torch.cat([state["conv"][:, S - kk:].to(xm.dtype), xm], dim=1)
    return out, dict(new_inner, conv=tail.float())


def mlstm_decode_step(p: Dict[str, torch.Tensor], cfg: Any, x: torch.Tensor,
                      state: State) -> Tuple[torch.Tensor, State]:
    return mlstm_forward(p, cfg, x, state=state, chunk_size=1)


def _mlstm_fresh(batch: int, H: int, dh: int, device: Optional[torch.device]) -> State:
    """The mLSTM's initial recurrent state (C, n, m) in fp32."""
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, dh, dh), **f32), "n": torch.zeros((batch, H, dh), **f32),
            "m": torch.full((batch, H), -1e30, **f32)}


def mlstm_init_state(cfg: Any, batch: int,
                     device: Optional[torch.device] = None) -> State:
    du, H, dh = _mlstm_dims(cfg)
    kk = cfg.xlstm.conv_kernel - 1
    return dict(_mlstm_fresh(batch, H, dh, device),
                conv=torch.zeros((batch, kk, du), dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_specs(cfg: Any) -> Dict[str, Spec]:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    dff = int(cfg.xlstm.s_proj_factor * d)
    return {
        "wx": Spec((d, 4, H, dh), ("embed", None, "heads", "head_dim"), init="scaled"),
        "wr": Spec((4, H, dh, dh), (None, "heads", "head_dim", None), init="scaled"),
        "b": Spec((4, H, dh), (None, "heads", "head_dim"), init="zeros"),
        "out_norm": Spec((dh,), ("head_dim",), init="zeros"),
        "ffn_gate": Spec((d, dff), ("embed", "mlp"), init="scaled"),
        "ffn_up": Spec((d, dff), ("embed", "mlp"), init="scaled"),
        "ffn_down": Spec((dff, d), ("mlp", "embed"), init="scaled"),
    }


def _slstm_scan(gx: torch.Tensor, wr: torch.Tensor, b: torch.Tensor,
                state: Optional[State], chunk_size: int) -> Tuple[torch.Tensor, State]:
    """gx: (B, S, 4, H, dh) input contributions to i, f, z, o; wr: (4, H,
    dh, dh) recurrent weights; b: (4, H, dh); ``state`` None starts from
    the initial state.  On DTensors it runs on each rank's own rows and
    heads, as ``_mlstm_scan`` does."""
    names = ("c", "n", "h", "m")
    if any_dtensor(gx, wr, b):
        ins = [("gx", constrain(gx, ("batch", None, None, "heads", None)), "b..h."),
               ("wr", constrain(wr, (None, "heads", None, None)), ".h.."),
               ("b", constrain(b, (None, "heads", None)), ".h.")]
        if state is not None:
            ins += _state_inputs(state, names)

        def local(gx, wr, b, *st):
            h, out = _slstm_scan(gx, wr, b, dict(zip(names, st)) if st else None,
                                 chunk_size)
            return (h,) + tuple(out[n] for n in names)

        h, *st = shard_local("slstm scan", local, ins, ("b.h.",) + ("bh.",) * 4)
        return h, dict(zip(names, st))
    if state is None:
        B, _, _, H, dh = gx.shape
        state = _slstm_fresh(B, H, dh, gx.device)
    wr_f, b_f = wr.float(), b.float()

    def step(carry, x_t):
        c, n, h, m = carry  # each (B, H, dh)
        # (B, 4, H, dh) as a broadcast product and a sum: a batched product
        # would merge the batch and head dims, both sharded on a mesh
        rec = (h[:, None, :, None, :] * wr_f).sum(-1)
        g = x_t + rec + b_f
        i_t, f_t, z_t, o_t = g.unbind(1)
        logf = _log_sigmoid(f_t)
        m_new = torch.maximum(logf + m, i_t)
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(logf + m - m_new)
        c = f_p * c + i_p * torch.tanh(z_t)
        n = f_p * n + i_p
        h_new = torch.sigmoid(o_t) * c / torch.clamp(n, min=1e-6)
        return (c, n, h_new, m_new), h_new

    (c, n, h, m), hs = chunked_scan(
        step, (state["c"], state["n"], state["h"], state["m"]),
        gx.float().transpose(0, 1), chunk_size=chunk_size)
    return hs.transpose(0, 1), {"c": c, "n": n, "h": h, "m": m}


def slstm_forward(
    p: Dict[str, torch.Tensor],
    cfg: Any,
    x: torch.Tensor,
    *,
    state: Optional[State] = None,
    chunk_size: int = 128,
) -> Tuple[torch.Tensor, State]:
    x = constrain(x, ("batch", None, None))  # the sequence gathered
    # (B, S, 4, H, dh), the product taken over (d, H, 4, dh): flattening
    # the heads, which a mesh shards, after the gates would lay the
    # product's columns out strided
    gx = heads_product(x, p["wx"].transpose(1, 2)).transpose(2, 3)
    h, new_state = _slstm_scan(gx, p["wr"], p["b"], state, chunk_size)
    h = flatten_heads(rms_norm(h, p["out_norm"])).to(x.dtype)  # (B, S, d)
    # gated FFN (projection factor 4/3)
    y = F.silu(h @ p["ffn_gate"]) * (h @ p["ffn_up"])
    return y @ p["ffn_down"], new_state


def slstm_decode_step(p: Dict[str, torch.Tensor], cfg: Any, x: torch.Tensor,
                      state: State) -> Tuple[torch.Tensor, State]:
    return slstm_forward(p, cfg, x, state=state, chunk_size=1)


def _slstm_fresh(batch: int, H: int, dh: int, device: Optional[torch.device]) -> State:
    """The sLSTM's initial state (c, n, h, m) in fp32."""
    f32 = dict(dtype=torch.float32, device=device)
    z = torch.zeros((batch, H, dh), **f32)
    return {"c": z, "n": z, "h": z, "m": torch.full((batch, H, dh), -1e30, **f32)}


def slstm_init_state(cfg: Any, batch: int,
                     device: Optional[torch.device] = None) -> State:
    return _slstm_fresh(batch, cfg.n_heads, cfg.d_model // cfg.n_heads, device)

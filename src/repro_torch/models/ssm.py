"""Mamba-1 selective SSM block (jamba's 'M' layers), in plain PyTorch.

The recurrence runs as the chunked, remat-bounded scan of
``scan_utils.chunked_scan``, as in the JAX package: ``h_t = exp(dt A) h +
(dt x) B_t``, ``y_t = h_t . C_t``, with the scan state and the conv window
kept in fp32.  Decode carries (conv window, ssm state): O(1) per token.
Segment ids play no part, as in the JAX package: a right-padded prompt's
final state has run over its padding.

Parameters keep the JAX package's names and layouts (``mamba_specs``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.context import constrain
from ..kernels.shard_local import any_dtensor, shard_local
from .params import Spec
from .scan_utils import chunked_scan

__all__ = ["mamba_specs", "mamba_forward", "mamba_decode_step", "mamba_init_state",
           "causal_depthwise_conv", "MambaState"]

MambaState = Dict[str, torch.Tensor]  # {"conv": (B, k-1, di), "ssm": (B, di, ds)}


def mamba_specs(cfg: Any) -> Dict[str, Spec]:
    s = cfg.ssm
    d = cfg.d_model
    di = s.inner(d)
    r = s.rank(d)
    ds = s.d_state
    return {
        "in_proj": Spec((d, 2 * di), ("embed", "mlp"), init="scaled"),
        "conv_w": Spec((s.d_conv, di), (None, "mlp"), init="scaled", scale=1.0),
        "conv_b": Spec((di,), ("mlp",), init="zeros"),
        "x_proj": Spec((di, r + 2 * ds), ("mlp", None), init="scaled"),
        "dt_proj": Spec((r, di), (None, "mlp"), init="scaled"),
        "dt_bias": Spec((di,), ("mlp",), init="zeros"),
        "A_log": Spec((di, ds), ("mlp", None), init="ones"),
        "D": Spec((di,), ("mlp",), init="ones"),
        "out_proj": Spec((di, d), ("mlp", "embed"), init="scaled"),
    }


def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, di), w: (k, di): a depthwise causal conv as k shifted
    multiply-adds, in the JAX package's order: ``w[k - 1]`` takes the
    current token, ``w[k - 1 - i]`` the token i steps back.

    On DTensors it runs on each rank's own rows and channels
    (``kernels/shard_local.py``): it is elementwise over the batch and the
    channels and shifts along the sequence, which is whole.  (torch 2.11's
    DTensor gets the shifts' pad backward wrong on a (1, 1) mesh.)"""
    if any_dtensor(x, w, b):
        return shard_local(
            "causal conv", causal_depthwise_conv,
            [("x", constrain(x, ("batch", None, "mlp")), "b.c"),
             ("w", constrain(w, (None, "mlp")), ".c"), ("b", constrain(b, ("mlp",)), "c")],
            "b.c")
    k = w.shape[0]
    out = x * w[k - 1]
    for i in range(1, k):
        shifted = F.pad(x[:, :-i], (0, 0, i, 0))
        out = out + shifted * w[k - 1 - i]
    return out + b


def _ssm_scan(
    dt: torch.Tensor,    # (B, S, di) softplus'd, fp32
    x: torch.Tensor,     # (B, S, di) post-conv activations, fp32
    Bmat: torch.Tensor,  # (B, S, ds)
    Cmat: torch.Tensor,  # (B, S, ds)
    A: torch.Tensor,     # (di, ds) negative
    h0: Optional[torch.Tensor],  # (B, di, ds); None: zeros
    chunk_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan: h_t = exp(dt A) h + (dt x) B_t;  y_t = h_t . C_t.

    On DTensors it runs on each rank's own rows and channels
    (``kernels/shard_local.py``): a step is elementwise over the batch and
    d_inner and contracts d_state, which is never split, so each rank's
    shard is a whole scan of its own, its state made there.  B and C are
    first made whole over the channels' mesh dim (one reduction a layer):
    left partial, every step reduced them again."""
    if any_dtensor(dt, x, Bmat, Cmat, A):
        rows, whole = ("batch", None, "mlp"), ("batch", None, None)
        ins = [("dt", constrain(dt, rows), "b.c"), ("x", constrain(x, rows), "b.c"),
               ("B", constrain(Bmat, whole), "b.."), ("C", constrain(Cmat, whole), "b.."),
               ("A", constrain(A, ("mlp", None)), "c.")]
        if h0 is not None:
            ins.append(("h0", constrain(h0, ("batch", "mlp", None)), "bc."))
        return shard_local(
            "mamba scan", lambda *a: _ssm_scan(*a[:5], a[5] if h0 is not None else None,
                                               chunk_size), ins, ("bc.", "b.c"))
    if h0 is None:
        h0 = dt.new_zeros((dt.shape[0], dt.shape[2], Bmat.shape[2]))

    def step(h, xs):
        dt_t, x_t, b_t, c_t = xs  # (B, di), (B, di), (B, ds), (B, ds)
        a = torch.exp(dt_t[..., None] * A[None])            # (B, di, ds)
        inc = (dt_t * x_t)[..., None] * b_t[:, None, :]     # (B, di, ds)
        h = a * h + inc
        y = (h @ c_t[..., None])[..., 0]                    # (B, di)
        return h, y

    xs = tuple(t.transpose(0, 1) for t in (dt, x, Bmat, Cmat))  # time-major
    h, ys = chunked_scan(step, h0, xs, chunk_size=chunk_size)
    return h, ys.transpose(0, 1)  # (B, S, di)


def _dt_b_c(p: Dict[str, torch.Tensor], cfg: Any, xc: torch.Tensor):
    """The input-dependent step sizes (softplus'd) and B, C of ``xc``."""
    r, ds = cfg.ssm.rank(cfg.d_model), cfg.ssm.d_state
    dbc = xc @ p["x_proj"]  # (..., r + 2 ds)
    dt_raw, Bmat, Cmat = dbc.split([r, ds, ds], dim=-1)
    dt = F.softplus(dt_raw @ p["dt_proj"] + p["dt_bias"])
    return dt, Bmat, Cmat


def mamba_forward(
    p: Dict[str, torch.Tensor],
    cfg: Any,
    x: torch.Tensor,  # (B, S, d)
    *,
    state: Optional[MambaState] = None,
    chunk_size: int = 128,
) -> Tuple[torch.Tensor, MambaState]:
    """Full-sequence Mamba block.  Returns (out, final_state)."""
    s = cfg.ssm
    S = x.shape[1]

    x = constrain(x, ("batch", None, None))  # the sequence gathered
    xz = constrain(x @ p["in_proj"], ("batch", None, "mlp"))
    x_in, z = xz.chunk(2, dim=-1)  # (B, S, di) each
    if state is not None:
        conv_in = torch.cat([state["conv"].to(x_in.dtype), x_in], dim=1)
        conv_out = causal_depthwise_conv(conv_in, p["conv_w"], p["conv_b"])
        conv_out = conv_out[:, state["conv"].shape[1]:]
        h0 = state["ssm"].float()
    else:
        conv_out = causal_depthwise_conv(x_in, p["conv_w"], p["conv_b"])
        h0 = None

    xc = F.silu(conv_out)
    dt, Bmat, Cmat = _dt_b_c(p, cfg, xc)
    A = -torch.exp(p["A_log"].float())
    h, y = _ssm_scan(dt.float(), xc.float(), Bmat.float(), Cmat.float(), A, h0,
                     chunk_size)
    y = (y + xc.float() * p["D"].float()).to(x.dtype)
    y = y * F.silu(z)
    out = y @ p["out_proj"]
    k1 = s.d_conv - 1
    tail = x_in[:, -k1:] if S >= k1 else F.pad(x_in, (0, 0, k1 - S, 0))
    return out, {"conv": tail.float(), "ssm": h}


def mamba_decode_step(
    p: Dict[str, torch.Tensor],
    cfg: Any,
    x: torch.Tensor,    # (B, 1, d)
    state: MambaState,  # conv window (B, k-1, di) + ssm state (B, di, ds)
) -> Tuple[torch.Tensor, MambaState]:
    """O(1) single-token Mamba step."""
    x_in, z = (x @ p["in_proj"]).chunk(2, dim=-1)  # (B, 1, di)
    window = torch.cat([state["conv"].to(x_in.dtype), x_in], dim=1)  # (B, k, di)
    conv = (window * p["conv_w"]).sum(dim=1) + p["conv_b"]
    xc = F.silu(conv)  # (B, di)
    dt, Bmat, Cmat = _dt_b_c(p, cfg, xc)
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt.float()[..., None] * A[None])
    inc = (dt * xc).float()[..., None] * Bmat.float()[:, None, :]
    h = a * state["ssm"] + inc
    y = (h @ Cmat.float()[..., None])[..., 0]
    y = (y + xc.float() * p["D"].float()).to(x.dtype)
    y = y[:, None, :] * F.silu(z)
    return y @ p["out_proj"], {"conv": window[:, 1:].float(), "ssm": h}


def mamba_init_state(cfg: Any, batch: int,
                     device: Optional[torch.device] = None) -> MambaState:
    s = cfg.ssm
    di = s.inner(cfg.d_model)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, di), dtype=torch.float32, device=device),
        "ssm": torch.zeros((batch, di, s.d_state), dtype=torch.float32, device=device),
    }

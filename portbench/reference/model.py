"""A plain decoder transformer in float32, TF32 off: the reference for every
configuration the benchmark runs.

Pre-norm blocks: a non-parametric LayerNorm (OLMo) or an RMSNorm with a
weight (Qwen3); attention with grouped KV heads, an RMSNorm on each head of
q and k where the configuration has qk-norm, rotary embeddings of the
rotate-half form (angle position x theta^(-i / (hd / 2)), in float64), causal
inside each document; a SwiGLU MLP; a tied or untied head.  Tokens are held
as one (T, d) matrix of the real tokens of every row, so padding takes no
work; attention runs document by document, in blocks of queries.

``Precision("fp8")`` is the control: every matrix product's operands are
rounded to float8 e4m3 (gradients to e5m2) with one scale a tensor, as an
fp8 training or serving path would compute, and K/V are kept in e4m3.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["Precision", "exact_fp32", "Tokens", "forward_layers", "train_loss",
           "prefill", "adamw_step", "lr_at"]

_E4M3, _E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


@contextlib.contextmanager
def exact_fp32():
    """float32 products in float32: TF32 off while the reference runs."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def quantize(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under one scale (its largest magnitude
    maps to the type's largest), back in ``x``'s dtype."""
    fmax = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / fmax, torch.ones_like(amax))
    return ((x / scale).clamp(-fmax, fmax).to(dtype).to(x.dtype) * scale).to(x.dtype)


class _Fp8Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = quantize(a, _E4M3), quantize(b, _E4M3)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = quantize(g, _E5M2)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class Precision:
    """How the reference multiplies: "fp32" (the reference) or "fp8" (the
    control)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a @ b if self.name == "fp32" else _Fp8Product.apply(a, b)

    def kept(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor as the cache keeps it."""
        return x if self.name == "fp32" else quantize(x.detach(), _E4M3)


class Tokens:
    """The real tokens of a batch as documents: ``ids`` (T,), ``pos`` (T,)
    positions inside each document, and ``docs`` [(start, length)] in T."""

    def __init__(self, ids: torch.Tensor, pos: torch.Tensor, docs: List[Tuple[int, int]]):
        self.ids, self.pos, self.docs = ids, pos, docs

    @classmethod
    def from_documents(cls, docs: Sequence[torch.Tensor], device) -> "Tokens":
        spans, start = [], 0
        for d in docs:
            spans.append((start, len(d)))
            start += len(d)
        ids = torch.cat([torch.as_tensor(d, dtype=torch.long) for d in docs]).to(device)
        pos = torch.cat([torch.arange(len(d)) for d in docs]).to(device)
        return cls(ids, pos, spans)


def _norm(cfg: Dict, x: torch.Tensor, weight: Optional[torch.Tensor]) -> torch.Tensor:
    if cfg["norm"] == "layernorm_np":
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + cfg["layer_norm_eps"])
    y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + cfg["rms_norm_eps"])
    return y * weight


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, hd) rotated by the angles of ``pos`` (T,)."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = pos.double()[:, None] * inv
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# a block of queries at most this many scores (heads x queries x keys)
_SCORES_PER_BLOCK = 1 << 28


def _attention(q, k, v, docs, prec: Precision) -> torch.Tensor:
    """Causal attention inside each document: q (T, H, hd), k, v (T, KVH, hd)."""
    H, hd = q.shape[1], q.shape[2]
    rep = H // k.shape[1]
    outs = []
    for start, n in docs:
        qd = q[start:start + n].transpose(0, 1)                       # (H, n, hd)
        kd = k[start:start + n].repeat_interleave(rep, dim=1).transpose(0, 1)
        vd = v[start:start + n].repeat_interleave(rep, dim=1).transpose(0, 1)
        block = max(1, min(n, _SCORES_PER_BLOCK // (H * n)))
        for i in range(0, n, block):
            j = min(n, i + block)
            s = prec.mm(qd[:, i:j], kd[:, :j].transpose(-1, -2)) / math.sqrt(hd)
            keep = (torch.arange(i, j, device=q.device)[:, None]
                    >= torch.arange(j, device=q.device)[None, :])
            p = torch.softmax(s.masked_fill(~keep, -torch.inf), dim=-1)
            outs.append(prec.mm(p, vd[:, :j]).transpose(0, 1))       # (j - i, H, hd)
    return torch.cat(outs, dim=0)


def _layer(cfg: Dict, prec: Precision, tok: Tokens, x: torch.Tensor,
           w: Dict[str, torch.Tensor], cached: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block on x (T, d); returns (x, k, v), k after its norm and RoPE,
    and with ``cached`` K and V as the cache keeps them, which attention
    then reads."""
    T = x.shape[0]
    H, KVH, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    h = _norm(cfg, x, w.get("ln1"))
    q = prec.mm(h, w["wq"]).view(T, H, hd)
    k = prec.mm(h, w["wk"]).view(T, KVH, hd)
    v = prec.mm(h, w["wv"]).view(T, KVH, hd)
    if cfg["qk_norm"]:
        q = _norm(dict(cfg, norm="rmsnorm"), q, w["q_norm"])
        k = _norm(dict(cfg, norm="rmsnorm"), k, w["k_norm"])
    q, k = _rope(q, tok.pos, cfg["rope_theta"]), _rope(k, tok.pos, cfg["rope_theta"])
    if cached:
        k, v = prec.kept(k), prec.kept(v)
    a = _attention(q, k, v, tok.docs, prec).reshape(T, H * hd)
    x = x + prec.mm(a, w["wo"])
    h = _norm(cfg, x, w.get("ln2"))
    x = x + prec.mm(F.silu(prec.mm(h, w["w_gate"])) * prec.mm(h, w["w_up"]), w["w_down"])
    return x, k, v


_LAYER_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "ln1", "ln2",
                 "q_norm", "k_norm")


def layer_weights(weights: Dict[str, torch.Tensor], l: int) -> Dict[str, torch.Tensor]:
    """Layer ``l``'s weights in float32."""
    return {n: weights[n][l].float() for n in _LAYER_LEAVES if n in weights}


def forward_layers(cfg: Dict, weights: Dict[str, torch.Tensor], tok: Tokens, prec: Precision,
                   *, remat: bool = False,
                   on_kv: Optional[Callable[[int, torch.Tensor, torch.Tensor], None]] = None
                   ) -> torch.Tensor:
    """The final-normed hidden states (T, d).  ``remat`` recomputes each
    layer in the backward (only its input is kept); ``on_kv(l, k, v)`` sees
    each layer's K and V."""
    x = weights["embed"][tok.ids].float()
    for l in range(cfg["num_hidden_layers"]):
        w = layer_weights(weights, l)
        if remat:
            x = checkpoint(lambda x_, w_: _layer(cfg, prec, tok, x_, w_)[0], x, w,
                           use_reentrant=False)
        else:
            x, k, v = _layer(cfg, prec, tok, x, w, cached=on_kv is not None)
            if on_kv is not None:
                on_kv(l, k, v)
    return _norm(cfg, x, weights["final_norm"].float() if "final_norm" in weights else None)


def _table(cfg: Dict, weights: Dict[str, torch.Tensor]) -> torch.Tensor:
    return weights["embed" if cfg["tie_word_embeddings"] else "lm_head"].float()


def _ce_chunk(cfg, prec, h, table, labels, z_loss):
    logits = prec.mm(h, table.T)
    lse = torch.logsumexp(logits, dim=-1)
    valid = labels >= 0
    picked = logits.gather(-1, labels.clamp(min=0)[:, None])[:, 0]
    return ((lse - picked) * valid).sum(), (lse.square() * valid).sum()


def train_loss(cfg: Dict, weights: Dict[str, torch.Tensor], tok: Tokens, labels: torch.Tensor,
               prec: Precision, *, z_loss: float, chunk: int = 4096) -> torch.Tensor:
    """Mean next-token cross-entropy over the tokens with a label (>= 0),
    plus ``z_loss`` times the mean squared logsumexp over them."""
    h = forward_layers(cfg, weights, tok, prec, remat=True)
    table = _table(cfg, weights)
    ce = zl = h.new_zeros(())
    for i in range(0, h.shape[0], chunk):
        c, z = checkpoint(_ce_chunk, cfg, prec, h[i:i + chunk], table, labels[i:i + chunk],
                          z_loss, use_reentrant=False)
        ce, zl = ce + c, zl + z
    n = (labels >= 0).sum().clamp(min=1)
    return ce / n + z_loss * zl / n


def prefill(cfg: Dict, weights: Dict[str, torch.Tensor], tok: Tokens, prec: Precision,
            on_kv: Callable[[int, torch.Tensor, torch.Tensor], None]) -> torch.Tensor:
    """Each document's last-token logits (docs, V) over the published
    vocabulary, each layer's K and V handed to ``on_kv``."""
    with torch.no_grad():
        h = forward_layers(cfg, weights, tok, prec, on_kv=on_kv)
        last = torch.tensor([s + n - 1 for s, n in tok.docs], device=h.device)
        return prec.mm(h[last], _table(cfg, weights)[:cfg["vocab_size"]].T)


def lr_at(opt: Dict, step: int) -> float:
    """Linear warm-up to the peak over ``warmup_steps``, then a cosine to
    ``min_lr_ratio`` of it at ``decay_steps``."""
    lr = opt["learning_rate"]
    if step < opt["warmup_steps"]:
        return lr * step / max(1, opt["warmup_steps"])
    frac = min(1.0, max(0.0, (step - opt["warmup_steps"])
                        / max(1, opt["decay_steps"] - opt["warmup_steps"])))
    return lr * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5 * (1 + math.cos(math.pi * frac)))


def adamw_step(opt: Dict, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: Dict[str, Dict[str, torch.Tensor]], step: int) -> None:
    """AdamW in place, step ``step`` (1-based): the gradients clipped to a
    global norm of ``grad_clip_norm``, bias-corrected moments, decoupled
    weight decay on every leaf."""
    gnorm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
    scale = torch.clamp(opt["grad_clip_norm"] / gnorm.clamp(min=1e-9), max=1.0)
    b1, b2, lr = opt["b1"], opt["b2"], lr_at(opt, step)
    for name, p in params.items():
        g = grads[name] * scale
        m = state.setdefault("m", {}).setdefault(name, torch.zeros_like(p))
        v = state.setdefault("v", {}).setdefault(name, torch.zeros_like(p))
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        u = (m / (1 - b1 ** step)) / (torch.sqrt(v / (1 - b2 ** step)) + opt["eps"])
        p.sub_(lr * (u + opt["weight_decay"] * p))

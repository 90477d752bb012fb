"""AdamW with warmup+cosine schedule and global-norm clipping.

The JAX package's optimizer, with the same fp32 math.  Optimizer state
mirrors the parameter tree (nested dicts of tensors); master params are
fp32 and the forward's cast to the compute dtype happens in the train step.
The update is functional, as in the JAX package: it returns new tensors and
leaves its inputs as they are.  Every scalar stays a 0-dim tensor on the
parameters' device, so a step never waits on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

from ..models.params import tree_leaves, tree_map

__all__ = ["OptimizerConfig", "init_opt_state", "adamw_update", "global_norm",
           "lr_at"]

Tree = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.learning_rate * torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    frac = torch.clamp(
        (step - cfg.warmup_steps) / max(1, cfg.decay_steps - cfg.warmup_steps),
        0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.learning_rate * cos)


def init_opt_state(params: Tree) -> Dict[str, Any]:
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(torch.zeros_like, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Tree) -> torch.Tensor:
    squares: List[torch.Tensor] = [
        g.float().square().sum() for g in tree_leaves(tree)]
    return torch.stack(squares).sum().sqrt()


def adamw_update(
    params: Tree,
    grads: Tree,
    state: Dict[str, Any],
    cfg: OptimizerConfig,
) -> Tuple[Tree, Dict[str, Any], Dict[str, torch.Tensor]]:
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(torch.float32)
    mhat_scale = 1.0 / (1 - b1 ** t)
    vhat_scale = 1.0 / (1 - b2 ** t)
    lr = lr_at(cfg, step)

    def moments(m_: torch.Tensor, v_: torch.Tensor, g: torch.Tensor):
        g = g.float() * scale
        return b1 * m_ + (1 - b1) * g, b2 * v_ + (1 - b2) * g * g

    mv = tree_map(moments, state["m"], state["v"], grads)
    m = tree_map(lambda pair: pair[0], mv)
    v = tree_map(lambda pair: pair[1], mv)

    def upd(p: torch.Tensor, m_: torch.Tensor, v_: torch.Tensor) -> torch.Tensor:
        u = (m_ * mhat_scale) / (torch.sqrt(v_ * vhat_scale) + cfg.eps)
        u = u + cfg.weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype)

    new_params = tree_map(upd, params, m, v)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, {"m": m, "v": v, "step": step}, metrics

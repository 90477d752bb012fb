"""Training step builder: mixed precision, microbatching, grad compression.

``make_train_step`` returns a ``(params, opt_state, batch) -> (params,
opt_state, metrics)`` function, as the JAX package's does: the gradient of
``model.loss`` by autograd (through the packed-attention kernels on the
card), then AdamW.  Master params and the optimizer state stay fp32; the
forward runs on a copy cast to ``compute_dtype``.

Distributed-optimization options, off by default as in the JAX package:
  - ``microbatches > 1``: gradient accumulation, summed in fp32;
  - ``compressor``: int8 quantization with error feedback of the
    (microbatch-averaged) gradients before AdamW
    (``distributed/compression.py``); the error feedback lives in
    ``opt_state["ef"]``, out of the AdamW core;
  - ``grad_shardings``: with the params as DTensors on a mesh, the compute
    copy and the gradients are redistributed to these (the parameters')
    shardings (``distributed/sharding.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..models.params import tree_leaves, tree_map, tree_unflatten
from .optimizer import OptimizerConfig, adamw_update

__all__ = ["make_train_step", "cast_params_for_compute"]

Tree = Any


def _cast(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if p.dim() >= 2 and p.is_floating_point():
        return p.to(dtype)
    return p


def cast_params_for_compute(params: Tree, dtype: torch.dtype = torch.bfloat16) -> Tree:
    """Cast >=2-D float params to ``dtype`` for compute; keep vectors fp32."""
    return tree_map(lambda p: _cast(p, dtype), params)


def _redistribute(t: torch.Tensor, sharding: Any) -> torch.Tensor:
    """A DTensor ``t`` moved to ``sharding``'s placements; a plain tensor as
    it is."""
    if isinstance(t, DTensor) and tuple(t.placements) != sharding.placements:
        return t.redistribute(t.device_mesh, sharding.placements)
    return t


def _microbatch_split(batch: Dict[str, torch.Tensor], n: int) -> List[Dict[str, torch.Tensor]]:
    """(B, ...) -> n batches of (B/n, ...)."""
    for x in batch.values():
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by {n} microbatches")
    return [{k: x.chunk(n, dim=0)[i] for k, x in batch.items()} for i in range(n)]


def make_train_step(
    model: Any,
    opt_cfg: OptimizerConfig,
    *,
    remat_policy: Optional[str] = "nothing",
    microbatches: int = 1,
    compute_dtype: torch.dtype = torch.bfloat16,
    compressor: Optional[Any] = None,
    grad_shardings: Optional[Tree] = None,
    grad_reduce_dtype: str = "bf16",
) -> Callable[[Tree, Dict[str, Any], Dict[str, torch.Tensor]],
              Tuple[Tree, Dict[str, Any], Dict[str, torch.Tensor]]]:
    """Build the train step for a model with a ``.loss(params, batch)``.

    ``grad_reduce_dtype="bf16"`` differentiates through the compute copy of
    the params, so the gradients come out in the compute dtype and are cast
    to fp32 by the optimizer, as the JAX package does; ``"f32"``
    differentiates through the cast, giving fp32 gradients.  Microbatch
    gradients are summed in fp32 and averaged.  ``grad_shardings`` (a tree
    of ``Sharding`` shaped as the params) pins the compute copy and the
    gradients to the parameter placements.
    """
    if grad_reduce_dtype not in ("bf16", "f32"):
        raise ValueError(f"unknown grad_reduce_dtype {grad_reduce_dtype!r}")
    bf16_reduce = grad_reduce_dtype == "bf16"

    pin = (lambda leaves: leaves) if grad_shardings is None else (
        lambda leaves: [_redistribute(t, s) for t, s in
                        zip(leaves, tree_leaves(grad_shardings), strict=True)])

    def compute_grads(params: Tree, batch: Dict[str, torch.Tensor]):
        if bf16_reduce:
            wrt = [t.detach().requires_grad_(True) for t in
                   pin([_cast(p, compute_dtype) for p in tree_leaves(params)])]
            compute = tree_unflatten(params, wrt)
        else:
            wrt = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
            compute = cast_params_for_compute(tree_unflatten(params, wrt), compute_dtype)
        with torch.enable_grad():
            loss, metrics = model.loss(compute, batch, remat_policy=remat_policy)
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        grads = pin([torch.zeros_like(w) if g is None else g for w, g in zip(wrt, grads)])
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten(params, grads)

    def train_step(
        params: Tree, opt_state: Dict[str, Any], batch: Dict[str, torch.Tensor]
    ) -> Tuple[Tree, Dict[str, Any], Dict[str, torch.Tensor]]:
        if microbatches > 1:
            gsum = lsum = None
            for mb in _microbatch_split(batch, microbatches):
                loss, _, grads = compute_grads(params, mb)
                if gsum is None:
                    gsum, lsum = tree_map(lambda g: g.float(), grads), loss
                else:
                    gsum = tree_map(lambda a, g: a + g.float(), gsum, grads)
                    lsum = lsum + loss
            grads = tree_map(lambda g: g / microbatches, gsum)
            metrics: Dict[str, torch.Tensor] = {"loss": lsum / microbatches}
        else:
            _, metrics, grads = compute_grads(params, batch)
        ef_state = opt_state.get("ef")
        opt_core = {k: v for k, v in opt_state.items() if k != "ef"}
        if compressor is not None:
            grads, ef_state = compressor.apply(grads, ef_state)
        params_new, opt_new, opt_metrics = adamw_update(params, grads, opt_core, opt_cfg)
        if ef_state is not None:
            opt_new["ef"] = ef_state
        return params_new, opt_new, dict(metrics, **opt_metrics)

    return train_step

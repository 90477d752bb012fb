"""Int8 gradient compression with error feedback.

The JAX package's distributed-optimization option for bandwidth-bound
multi-pod training: gradients are quantized to int8 with one scale per
tensor, and the quantization error is carried forward (error feedback,
Seide et al. / Karimireddy et al.) so the compression is unbiased over
time.  The arithmetic is the JAX package's, in fp32: with ``stochastic=False``
(abs, max, divide, round half to even, clip) the results are its bits.

Two of its rules are kept as they are:

  - the scale is the *global* max |g|: on a sharded DTensor gradient the
    max is taken over every shard (DTensor reduces its partial max);
  - each ``apply`` re-derives its noise from ``seed``: a ``torch.Generator``
    seeded with it on every call, one uniform draw in [-0.5, 0.5) per leaf
    in leaf order, so every call draws the same noise (the JAX package
    splits ``PRNGKey(seed)`` anew on every call).  A sharded leaf's noise is
    drawn at the leaf's full shape on every rank and each rank keeps its own
    shard, so the noise does not depend on the layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from ..models.params import tree_leaves, tree_map, tree_unflatten

__all__ = ["GradCompressor"]

Tree = Any


def _uniform_noise(g: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Uniform [-0.5, 0.5) noise of ``g``'s full shape from ``gen``, laid
    out as ``g`` is."""
    noise = torch.rand(tuple(g.shape), generator=gen, dtype=torch.float32,
                       device=gen.device) - 0.5
    if isinstance(g, DTensor):
        return distribute_tensor(noise, g.device_mesh, g.placements, src_data_rank=None)
    return noise


@dataclasses.dataclass(frozen=True)
class GradCompressor:
    """Quantize gradients to int8 with error feedback."""

    bits: int = 8
    stochastic: bool = True
    seed: int = 0

    def init_state(self, params: Tree) -> Tree:
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)

    def _quant_one(
        self, g: torch.Tensor, err: torch.Tensor, noise: Optional[torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        g = g.float() + err
        qmax = float(2 ** (self.bits - 1) - 1)
        scale = torch.clamp(g.abs().amax(), min=1e-12) / qmax
        x = g / scale
        if noise is not None:
            x = x + noise
        q = torch.clamp(torch.round(x), -qmax, qmax).to(torch.int8)
        deq = q.float() * scale
        return deq, g - deq

    def apply(self, grads: Tree, ef_state: Optional[Tree]) -> Tuple[Tree, Tree]:
        """(dequantized gradients, new error-feedback state), both fp32 and
        shaped as ``grads``; ``ef_state`` None starts from zeros."""
        leaves = tree_leaves(grads)
        if ef_state is None:
            ef_state = self.init_state(grads)
        errs = tree_leaves(ef_state)
        gen = None
        if self.stochastic and leaves:
            device = leaves[0].device
            gen = torch.Generator(device=device).manual_seed(self.seed)
        outs = [self._quant_one(g, e, None if gen is None else _uniform_noise(g, gen))
                for g, e in zip(leaves, errs, strict=True)]
        return (tree_unflatten(grads, [o[0] for o in outs]),
                tree_unflatten(grads, [o[1] for o in outs]))

"""Activation-sharding context.

Models call ``constrain(x, axes)`` at layer boundaries with *logical* axis
names, at the JAX package's call sites; while a mesh context is active (set
by the training driver) a DTensor is redistributed there to the placements
that the parameters' rules resolve for its shape.  Without a context it is
a no-op, so model code stays mesh-agnostic and every single-device path
computes exactly what it computed before.  A plain tensor passes through
unchanged inside a context too: only a DTensor has a layout to pin.

This is what pins the distributed layout: batch over the data axes,
sequence over ``model`` between blocks (sequence parallelism), heads/mlp
over ``model`` inside blocks.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from .sharding import Rules, Sharding, axes_to_pspec, axis_sizes, make_rules

__all__ = ["activation_sharding", "constrain", "current_mesh", "batch_shard_count"]

_STATE = threading.local()


@contextlib.contextmanager
def activation_sharding(mesh: Any, rules: Optional[Rules] = None):
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = (mesh, rules or make_rules(mesh))
    try:
        yield
    finally:
        _STATE.ctx = prev


def current_mesh() -> Any:
    ctx = getattr(_STATE, "ctx", None)
    return ctx[0] if ctx else None


def batch_shard_count(batch_size: int) -> int:
    """How many ways the active layout shards a batch dim of this size.

    The MoE layer's dispatch-group count: routing, sorting and the
    capacity-bin scatter are then local to a batch shard by construction.
    1 when no mesh context is active.
    """
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None:
        return 1
    mesh, rules = ctx
    entry = axes_to_pspec(("batch",), (batch_size,), rules, mesh)[0]
    if entry is None:
        return 1
    sizes = axis_sizes(mesh)
    n = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        n *= sizes[a]
    return n


def constrain(x: torch.Tensor, axes: Tuple[Optional[str], ...]) -> torch.Tensor:
    """Pin a DTensor's layout to the logical ``axes`` if a mesh context is
    active; otherwise return ``x`` as it is."""
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None:
        return x
    mesh, rules = ctx
    if len(axes) != x.dim():
        raise ValueError(f"axes {axes} rank != array rank {x.dim()}")
    if not isinstance(x, DTensor):
        return x
    placements = Sharding(mesh, axes_to_pspec(axes, tuple(x.shape), rules, mesh)).placements
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)

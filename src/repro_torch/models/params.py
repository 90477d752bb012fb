"""Minimal functional parameter system, as in the JAX package.

Models declare parameters as ``Spec`` trees (shape + dtype + logical axis
names + initializer); params are plain nested dicts of tensors keyed by the
same paths as the JAX package's (``blocks/<pos>/mixer/wq``, ...), with the
layers stacked over periods in the leading dimension.  From one spec tree:

  - ``init_params``       — tensors drawn from a seeded ``torch.Generator``
                            under the JAX package's init rules, on any
                            device (the full-width weights are drawn on the
                            card, leaf by leaf);
  - ``params_from_numpy`` — the JAX package's own parameters, carried across
                            as numpy arrays keyed by the same paths (the
                            layout is the same, so this is a copy);
  - ``abstract_params``   — meta-tensor stand-ins, the dry-run path: shapes
                            and dtypes, nothing allocated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["Spec", "init_params", "params_from_numpy", "abstract_params", "tree_bytes",
           "tree_map", "tree_paths", "tree_leaves", "tree_unflatten"]

Tree = Any


@dataclasses.dataclass(frozen=True)
class Spec:
    """Declaration of one parameter tensor."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis per dim (None = replicated)
    init: str = "normal"  # normal | zeros | ones | scaled (fan-in)
    scale: float = 1.0
    dtype: torch.dtype = torch.float32

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"spec shape {self.shape} and axes {self.axes} rank mismatch"
            )


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` to every leaf of a nested dict (and the same leaf of
    each tree in ``rest``, which share its structure), keeping the
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_paths(tree: Tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs in sorted key order, as ``jax.tree.flatten``
    orders the leaves of nested dicts."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in tree_paths(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def tree_leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(template: Tree, leaves: List[Any]) -> Tree:
    """A tree shaped like ``template`` (empty dicts included) holding
    ``leaves`` in the order of ``tree_paths(template)``."""
    it = iter(leaves)

    def build(tree: Tree) -> Tree:
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _std(spec: Spec) -> float:
    if spec.init == "normal":
        return spec.scale
    # fan-in scaled: the JAX package takes the fan-in from shape[-2], so a
    # (d, H, hd) projection is scaled by H and a stacked (n, d) leaf by n
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    return spec.scale / math.sqrt(max(1, fan_in))


# the fp32 draw of a leaf is made in slices of at most this many bytes, each
# written into the leaf's preallocated tensor, so drawing a leaf costs its
# own memory plus one bounded temporary (a stacked expert leaf of
# qwen3-moe-30b-a3b is 38.7 GB in fp32)
DRAW_SLICE_BYTES = 256 << 20


def _init_one(spec: Spec, generator: torch.Generator, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """One leaf: fp32 normals drawn slice by slice over the flattened leaf,
    scaled, and cast into a tensor of ``dtype``.  The slices are cut by fp32
    bytes whatever ``dtype`` is, so a bf16 leaf is the fp32 leaf cast."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init not in ("normal", "scaled"):
        raise ValueError(f"unknown init {spec.init!r}")
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    flat, std = out.view(-1), _std(spec)
    step = max(1, DRAW_SLICE_BYTES // 4)
    for i in range(0, flat.numel(), step):
        n = min(step, flat.numel() - i)
        flat[i:i + n] = torch.randn(n, generator=generator, dtype=torch.float32,
                                    device=device).mul_(std)
    return out


def init_params(
    specs: Tree,
    generator: torch.Generator,
    dtype: Optional[torch.dtype] = None,
    device: Optional[torch.device] = None,
) -> Tree:
    """Materialize a spec tree, leaf by leaf in sorted path order.

    Draws are fp32 normals from ``generator`` (which must live on
    ``device``), scaled, then cast to ``dtype`` (default: each spec's own),
    in slices of at most ``DRAW_SLICE_BYTES`` of fp32 (``_init_one``).
    The rules are the JAX package's; the numbers are not, since the two
    frameworks' generators differ: to compare the two packages on the same
    weights, use ``params_from_numpy``.
    """
    device = torch.device(device if device is not None else generator.device)

    def build(tree: Tree) -> Tree:
        if isinstance(tree, dict):  # sorted keys, as jax.tree.flatten
            return {k: build(tree[k]) for k in sorted(tree)}
        return _init_one(tree, generator, dtype or tree.dtype, device)

    return build(specs)


def params_from_numpy(
    tree: Tree,
    dtype: Optional[torch.dtype] = None,
    device: Optional[torch.device] = None,
) -> Tree:
    """The JAX package's parameters (a pytree turned into numpy arrays,
    keyed by the same ``Spec`` paths) as torch tensors on ``device``."""

    def one(a: Any) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":  # ml_dtypes; torch cannot read it
            a = a.astype(np.float32)
        t = torch.from_numpy(np.array(a))  # a writable copy
        return t.to(device=device, dtype=dtype or t.dtype)

    return tree_map(one, tree)


def abstract_params(specs: Tree, dtype: Optional[torch.dtype] = None) -> Tree:
    """Meta tensors of each spec's shape in ``dtype`` (default: the spec's
    own): the dry-run's parameters, zero allocation.  Their dicts are in
    sorted key order, as ``init_params`` builds the card's: ``tree_map``
    walks a tree in its dicts' order, and so does the optimizer, whose
    peak falls in the update of the last leaf it walks."""
    def build(tree: Tree) -> Tree:
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        return torch.empty(tree.shape, dtype=dtype or tree.dtype, device="meta")

    return build(specs)


def tree_bytes(tree: Tree) -> int:
    """Total bytes of a tree's tensors (a DTensor counts its global shape)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))

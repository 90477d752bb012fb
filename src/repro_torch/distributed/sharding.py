"""Logical-axis sharding rules -> DTensor placements.

Parameters and inputs carry *logical* axis names (``models.params.Spec``);
this module maps them onto mesh axes with the JAX package's divisibility-
and conflict-aware resolution:

  - an axis rule is an ordered tuple of candidate mesh axes; each candidate
    is taken greedily if (a) it is not already used by an earlier dim of the
    same tensor and (b) the accumulated shard count divides the dim size;
  - so one rule table serves every architecture: ``kv_heads -> ("model",)``
    shards qwen2's 8 KV heads nowhere on a 16-wide model axis (replicate)
    but olmo's 16 heads 16-way; ``experts -> ("model",)`` gives qwen3-moe's
    128 experts expert parallelism and falls back to d_ff (``mlp``) for
    grok's 8;
  - batch and sequence rules compose: ``kv_seq -> (data..., "model")``.

A resolved spec is a tuple with one entry per tensor dim: ``None``
(replicated), a mesh axis name, or a tuple of names (the dim split over
several axes, the first the major one) -- the counterpart of JAX's
``PartitionSpec``.  The rule functions take anything that names its axes
and their sizes: a ``DeviceMesh`` (``mesh_dim_names``, ``size(i)``) or a
``MeshShape``, so the rules are usable with no process group.

``Sharding`` turns a spec into DTensor placements: mesh dim ``m`` gets
``Shard(i)`` when its axis appears in entry ``i`` and ``Replicate()``
otherwise.  A mesh dim of size 1 gets ``Replicate()`` either way: its one
device holds the whole dim under both, and DTensor refuses some views of a
dim it counts as sharded (the squeeze of a size-1 dim, a flatten).  DTensor nests the shards of one tensor dim in mesh-dim order
and JAX in the order of the entry's tuple; every rule lists its axes in
mesh order, so the two agree, and a spec that would nest otherwise raises.

Training layout: FSDP over the data axes (the params' ``embed`` dim) x
tensor parallelism over ``model`` (heads / mlp / vocab); the ``pod`` axis
extends FSDP and data parallelism across pods.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = [
    "MeshShape",
    "Rules",
    "Sharding",
    "make_rules",
    "axes_to_pspec",
    "spec_to_pspec",
    "param_shardings",
    "batch_shardings",
    "cache_shardings",
]

Rules = Dict[str, Tuple[str, ...]]
PSpec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices or a process group."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def axis_names(mesh: Any) -> Tuple[str, ...]:
    if isinstance(mesh, MeshShape):
        return mesh.axis_names
    if mesh.mesh_dim_names is None:
        raise ValueError("the mesh has no axis names (mesh_dim_names)")
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh: Any) -> Dict[str, int]:
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return {name: mesh.size(i) for i, name in enumerate(axis_names(mesh))}


def make_rules(mesh: Any, layout: str = "tp") -> Rules:
    """The JAX package's three layouts.

    ``"tp"``: batch over the data axes, tensor parallelism over ``model``
    (heads / mlp / vocab / experts), sequence parallelism between blocks.
    ``"fsdp"``: the same 2-D parameter storage, activations batch-sharded
    over every mesh axis and nothing else.  ``"serve"``: weights replicated
    over the data axes, tensor parallelism over ``model`` only.
    """
    axes = axis_names(mesh)
    data_axes = tuple(a for a in axes if a != "model")  # ("pod","data") or ("data",)
    params = {
        "vocab": ("model",),
        "embed": data_axes,            # FSDP storage of the d dim
        "mlp": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": (),
        "experts": ("model",),
        "layers": (),
    }
    shared = {
        "batch_data": data_axes,       # batch over data only (CE chunks)
        "kv_seq": data_axes + ("model",),
        "pages": data_axes + ("model",),
    }
    if layout == "tp":
        return {**params, **shared, "batch": data_axes, "seq": ("model",)}
    if layout == "fsdp":
        return {**params, **shared, "batch": data_axes + ("model",), "seq": ()}
    if layout == "serve":
        return {**params, **shared, "embed": (), "batch": data_axes, "seq": ("model",)}
    raise ValueError(f"unknown layout {layout!r}")


def _resolve_dim(name: Optional[str], size: int, rules: Rules, mesh: Any,
                 used: set) -> Any:
    if name is None:
        return None
    sizes = axis_sizes(mesh)
    chosen = []
    prod = 1
    for ax in rules.get(name, ()):
        if ax in used:
            continue
        if size % (prod * sizes[ax]) != 0:
            continue
        chosen.append(ax)
        prod *= sizes[ax]
    used.update(chosen)
    if not chosen:
        return None
    return tuple(chosen) if len(chosen) > 1 else chosen[0]


def axes_to_pspec(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
                  rules: Rules, mesh: Any) -> PSpec:
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} rank != shape {tuple(shape)} rank")
    used: set = set()
    return tuple(_resolve_dim(name, size, rules, mesh, used)
                 for name, size in zip(axes, shape))


def spec_to_pspec(spec: Any, rules: Rules, mesh: Any) -> PSpec:
    """The spec of a ``models.params.Spec`` (anything with ``axes`` and
    ``shape``; this module imports nothing of ``models``, which imports it)."""
    return axes_to_pspec(spec.axes, spec.shape, rules, mesh)


def _entry_axes(entry: Any) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A resolved spec on a mesh: the counterpart of JAX's NamedSharding."""

    mesh: Any
    spec: PSpec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        names = axis_names(self.mesh)
        sizes = axis_sizes(self.mesh)
        out = [Replicate() for _ in names]
        for i, entry in enumerate(self.spec):
            axes = _entry_axes(entry)
            dims = [names.index(a) for a in axes]
            if dims != sorted(dims):
                raise ValueError(
                    f"spec {self.spec}: dim {i} nests {axes} against the mesh order "
                    f"{names}; DTensor would lay it out otherwise")
            for m in dims:
                if sizes[names[m]] > 1:
                    out[m] = Shard(i)
        return tuple(out)


def param_shardings(specs: Any, mesh: Any, rules: Optional[Rules] = None) -> Any:
    rules = rules or make_rules(mesh)

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return Sharding(mesh, spec_to_pspec(node, rules, mesh))

    return walk(specs)


def distribute(tensor: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """``tensor`` (the same full value on every rank) as a DTensor laid out
    by ``sharding``; each rank keeps its own shard, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(tensor, sharding.mesh, sharding.placements,
                             src_data_rank=None)


# ---------------------------------------------------------------------------
# Input batches and caches
# ---------------------------------------------------------------------------

_BATCH_AXES = {
    # training / prefill inputs
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "segment_ids": ("batch", "seq"),
    "positions": ("batch", "seq"),
    "vision_embeds": ("batch", None, "embed"),
    "enc_embeds": ("batch", "seq", "embed"),
    "enc_segment_ids": ("batch", "seq"),
}


def batch_shardings(batch: Dict[str, Any], mesh: Any, rules: Optional[Rules] = None,
                    *, decode: bool = False) -> Dict[str, Sharding]:
    """Shardings for a batch dict (by key), from each leaf's ``shape``."""
    rules = rules or make_rules(mesh)
    out = {}
    for key, leaf in batch.items():
        shape = tuple(leaf.shape)
        if decode and key == "tokens":
            axes: Tuple[Optional[str], ...] = ("batch", None)
        else:
            axes = _BATCH_AXES.get(key, ("batch",) + (None,) * (len(shape) - 1))
        out[key] = Sharding(mesh, axes_to_pspec(axes, shape, rules, mesh))
    return out


def _cache_leaf_axes(path: Tuple[str, ...], shape: Tuple[int, ...]) -> Tuple:
    """Logical axes for a leaf of the JAX package's caches, keyed by its
    path and rank.

    Dense KV caches are (layers, B, S, KVH, hd): batch over data, cache
    sequence over whatever remains (the whole mesh for B=1).  Recurrent
    states (mamba/xlstm) are small: batch and the inner dim.
    """
    name = path[-1] if path else ""
    if name in ("k", "v", "ck", "cv") and len(shape) == 5:
        return ("layers", "batch", "kv_seq", "kv_heads", None)
    if name == "len":
        return ("batch",)
    if name == "enc_segment_ids":
        return ("batch", None)
    if name == "conv":  # (layers, B, k-1, di)
        return ("layers", "batch", None, "mlp")
    if name == "ssm":  # (layers, B, di, ds)
        return ("layers", "batch", "mlp", None)
    if name == "C" and len(shape) == 5:  # (layers, B, H, dh, dh)
        return ("layers", "batch", "heads", None, None)
    if name in ("n", "m", "c", "h"):
        return ("layers", "batch", "heads") + (None,) * (len(shape) - 3)
    # fallback: batch on dim 1 if rank >= 2 (layers-stacked), else replicate
    if len(shape) >= 2:
        return ("layers", "batch") + (None,) * (len(shape) - 2)
    return (None,) * len(shape)


# the port's paged pools: (n_attn_layers, num_pages, page_size, KVH, D)
_PAGED_POOL_AXES = ("layers", "pages", None, "kv_heads", None)


def cache_shardings(cache: Any, mesh: Any, rules: Optional[Rules] = None) -> Any:
    """Shardings for every tensor of a cache (nested dicts and lists), by
    its path; anything else (the page allocator, sequence ids) maps to
    None.  In the port's paged cache (``init_paged_cache``, the one with an
    ``"alloc"``) the K and V pools, self and cross, are laid out by page,
    not by batch; the cross page table is whole on every rank, as the self
    table each decode step makes; and each recurrent layer's state is its
    own (batch first, no stacked layers dim)."""
    rules = rules or make_rules(mesh)
    paged = isinstance(cache, dict) and "alloc" in cache

    def walk(node: Any, path: Tuple[str, ...]) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),)) for i, v in enumerate(node))
        if not isinstance(node, torch.Tensor):
            return None
        shape = tuple(node.shape)
        if paged and len(path) == 1 and path[0] in ("k", "v", "ck", "cv"):
            axes = _PAGED_POOL_AXES
        elif paged and path == ("cross_table",):
            axes = (None, None)
        elif paged and path[0] == "state":
            axes = _cache_leaf_axes(path, (1,) + shape)[1:]
        else:
            axes = _cache_leaf_axes(path, shape)
        return Sharding(mesh, axes_to_pspec(axes, shape, rules, mesh))

    return walk(cache, ())

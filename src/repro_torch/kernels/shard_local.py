"""The kernels' wrappers on DTensors: shard-local where the layout allows it,
an error everywhere else.

A kernel takes data pointers and cannot see a DTensor.  Each wrapper names
the dims of its inputs and output that may be sharded, by role (``b`` a
batch dim, ``h`` a head dim, ``e`` an expert dim, ``f`` an output-column
dim; ``.`` a dim that must stay whole).  When every input is a DTensor on
one mesh, each shards only such dims, evenly, and each role is sharded over
the same mesh dims in every input that has it, every rank's shard is a
whole problem of its own: the wrapper runs on the local tensors (the
kernel on the card, the plain version on the CPU) and the result (or each
of a tuple of results) is wrapped back as a DTensor sharded by the same
roles.  ``to_local`` and ``from_local`` are differentiable, so the
gradients take the same way back; each local input's gradient is made
contiguous on its way out (DTensor reshapes a gradient as a view of its
local tensor, which a transposed gradient, such as a time-major scan's,
cannot give).
Any other layout (a sharded sequence or contraction dim, a partial sum, a
plain tensor beside DTensors) raises ``ValueError`` naming the op and the
placements: nothing is gathered and nothing drops to the plain version.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["any_dtensor", "shard_local"]


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient comes back contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def any_dtensor(*tensors: torch.Tensor) -> bool:
    return any(isinstance(t, DTensor) for t in tensors)


def shard_local(
    op: str,
    fn: Callable[..., torch.Tensor],
    inputs: Sequence[Tuple[str, torch.Tensor, str]],  # (name, tensor, roles)
    out_roles: Union[str, Tuple[str, ...]],
) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """``fn`` of the local shards of ``inputs``, as a DTensor whose dim i is
    sharded as role ``out_roles[i]`` is in the inputs; a tuple of them where
    ``fn`` returns a tuple, ``out_roles`` holding one string for each."""
    mesh = None
    sharded_by: Dict[str, Tuple[int, ...]] = {}
    for name, t, roles in inputs:
        if not isinstance(t, DTensor):
            raise ValueError(f"{op}: {name} is a plain tensor beside DTensor inputs")
        if mesh is None:
            mesh = t.device_mesh
        elif t.device_mesh != mesh:
            raise ValueError(f"{op}: {name} lies on another mesh")
        by_role: Dict[str, list] = {}
        for m, pl in enumerate(t.placements):
            if isinstance(pl, Replicate):
                continue
            if isinstance(pl, Shard) and roles[pl.dim] != ".":
                by_role.setdefault(roles[pl.dim], []).append(m)
                continue
            allowed = [i for i, r in enumerate(roles) if r != "."]
            raise ValueError(
                f"{op}: {name} of shape {tuple(t.shape)} has placements "
                f"{tuple(t.placements)}; only its dims {allowed} may be "
                f"sharded, the rest must be replicated")
        for dim, role in enumerate(roles):
            if role == ".":
                continue
            dims = tuple(by_role.get(role, ()))
            n = 1
            for m in dims:
                n *= mesh.size(m)
            if t.shape[dim] % n:
                raise ValueError(
                    f"{op}: {name} dim {dim} ({t.shape[dim]}) does not split evenly "
                    f"over mesh dims {dims} (placements {tuple(t.placements)})")
            if sharded_by.setdefault(role, dims) != dims:
                raise ValueError(
                    f"{op}: {name} shards its '{role}' dim over mesh dims {dims} "
                    f"(placements {tuple(t.placements)}); another input shards it "
                    f"over {sharded_by[role]}")
    out = fn(*(_ContiguousGrad.apply(t.to_local()) for _, t, _ in inputs))

    def wrap(local: torch.Tensor, roles: str) -> torch.Tensor:
        placements = [Replicate() for _ in range(mesh.ndim)]
        for i, role in enumerate(roles):
            for m in sharded_by.get(role, ()):
                placements[m] = Shard(i)
        return DTensor.from_local(local, mesh, placements, run_check=False)

    if isinstance(out_roles, str):
        return wrap(out, out_roles)
    return tuple(wrap(o, r) for o, r in zip(out, out_roles, strict=True))

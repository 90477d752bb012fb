"""Mesh construction.

Functions, never module-level constants, as in the JAX package: importing
this module starts no process group and touches no device.

A mesh spans the ranks of the default process group.  ``make_local_mesh``
starts a one-rank group itself when there is none (NCCL on the card, gloo
on the CPU); the production meshes of 256 and 512 ranks exist only under a
launcher that started that many (``torchrun``), or under the ``fake``
backend, which lays tensors out without moving data.
"""

from __future__ import annotations

import math
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_production_mesh", "make_local_mesh"]


def _device_type(device_type: Optional[str]) -> str:
    """The mesh's device type: the caller's, else the card, which must be
    there (the CPU is asked for by name, as the launchers' ``--device
    cpu``)."""
    if device_type is not None:
        return device_type
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device_type='cpu' for a mesh on the CPU")
    return "cuda"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ensure_process_group(device_type: Optional[str] = None) -> None:
    """Start the process group if none is running: NCCL for the card, gloo
    for the CPU; the launcher's ranks under ``torchrun`` (its ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``), else one rank on
    ``localhost``."""
    if dist.is_initialized():
        return
    device_type = _device_type(device_type)
    kwargs = {}
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", torch.cuda.current_device()))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    backend = "nccl" if device_type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, **kwargs)  # env://, the launcher's
        return
    dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1, **kwargs)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod.

    The ``pod`` axis extends data parallelism across pods: gradient
    reduction crosses pods, everything else stays pod-local.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != math.prod(shape):
        raise RuntimeError(
            f"the {'x'.join(map(str, shape))} production mesh needs a process group "
            f"of that many ranks (a launcher, or the 'fake' backend); have {have}")
    return init_device_mesh(_device_type(device_type), shape, mesh_dim_names=axes)


def make_local_mesh(device_type: Optional[str] = None) -> DeviceMesh:
    """Every rank of the process group on the data axis: (n, 1)."""
    _ensure_process_group(device_type)
    n = dist.get_world_size()
    return init_device_mesh(_device_type(device_type), (n, 1),
                            mesh_dim_names=("data", "model"))

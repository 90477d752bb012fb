"""The kernels' entries as ``torch.library`` operators (namespace
``repro_torch``), each with the work it does.

An entry has three implementations: ``CUDA`` launches the Hopper kernel
(and counts the launch), ``CPU`` is its plain PyTorch version, and a fake
one gives the outputs' shapes and dtypes and does nothing, for fake and
meta tensors alike.  The wrappers (``ops.py``) send every tensor that does
not lie on the CPU through the operator, so a dry-run on meta stand-ins
takes the kernel route, as the card does, and launches nothing.  The
operators are registered with the low-level ``torch.library.Library``
API: its dispatch costs about 2 us a call on the host, where
``torch.library.custom_op`` costs about 20.

Each entry's work is registered beside it (``define``): its FLOPs, a
``torch.utils.flop_counter`` formula, so that ``FlopCounterMode`` counts
it, and the bytes it must move, each input read once and each output
written once (``BYTES``), as the kernels' bounds in PERF.md count them.
Both see shapes and dtypes only, never values, so the count of a step on
meta stand-ins is the count of the same step on the card; where the work
depends on values (a grouped matmul's live rows, a packed row's segments,
a sequence's length) the formula counts the dense work the shapes allow.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch
from torch.utils.flop_counter import register_flop_formula

__all__ = ["LIB", "BYTES", "define", "nbytes"]

LIB = torch.library.Library("repro_torch", "FRAGMENT")
# op packet -> f(*args, out) -> bytes the kernel must move
BYTES: Dict[Any, Callable[..., float]] = {}


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def define(name: str, schema: str, *, cuda: Callable, cpu: Callable, fake: Callable,
           flops: Callable[..., int], moved: Callable[..., float]) -> Any:
    """Define ``repro_torch::<name>`` with ``schema`` (the part after the
    name), its CUDA, CPU and fake implementations, its FLOP formula (over
    the arguments' shapes, ``flop_counter``'s convention) and its bytes
    (over the arguments and the output); return the op packet."""
    LIB.define(name + schema)
    LIB.impl(name, cuda, "CUDA")
    LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=LIB)
    op = getattr(torch.ops.repro_torch, name)
    register_flop_formula(op)(flops)
    BYTES[op] = moved
    return op

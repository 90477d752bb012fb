"""Public wrappers for the grouped matmul: the Hopper kernel for CUDA
tensors, the plain PyTorch version for CPU tensors; and the SwiGLU expert
FFN built from three of them.

On DTensors ``gmm`` runs shard-locally when only the expert dim (of x, w
and the group sizes alike) and w's output columns are sharded
(``kernels/shard_local.py``), and raises on any other layout, a sharded
contraction dim among them.

A tensor that does not lie on the CPU goes through the operator
``repro_torch::gmm`` (``kernels/custom_ops.py``): the kernel on the card, a
fake that does no work on meta stand-ins.  Its FLOPs are the dense
``2 E C d f`` over every capacity row: the formula sees shapes, not
``group_sizes``, whose live rows the kernel's bound counts.

``launches`` counts the kernel launches this process made through ``gmm``
(``expert_ffn_swiglu`` adds 3 a call); a run resets it to 0 and reads it
back to show that its main path went through the kernel.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..custom_ops import define, nbytes
from ..shard_local import any_dtensor, shard_local
from .kernel import grouped_matmul
from .ref import grouped_matmul_ref

__all__ = ["gmm", "expert_ffn_swiglu", "launches"]

launches = 0
_count_lock = threading.Lock()
_timing = threading.local()  # the (start, end) events of this thread's next launch


def _launch(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    global launches
    out = grouped_matmul(x, w, group_sizes, getattr(_timing, "events", None))
    if out.numel():  # an empty output launches nothing
        with _count_lock:
            launches += 1
    return out


def _fake(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))


def _flops(x_shape, w_shape, gs_shape, *args, out_shape=None, **kwargs) -> int:
    E, C, d = x_shape
    return 2 * E * C * d * w_shape[2]


_GMM = define("gmm", "(Tensor x, Tensor w, Tensor group_sizes) -> Tensor",
              cuda=_launch, cpu=grouped_matmul_ref, fake=_fake, flops=_flops,
              moved=nbytes)  # x, w and the sizes read, out written


def gmm(
    x: torch.Tensor,            # (E, C, d)
    w: torch.Tensor,            # (E, d, f)
    group_sizes: torch.Tensor,  # (E,) int32
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None,
) -> torch.Tensor:
    """Grouped matmul over capacity bins (see ``ref.grouped_matmul_ref``).

    A CUDA tensor launches the kernel or raises; only a tensor that lies on
    the CPU takes the plain version.  ``events`` time the launch (see
    ``kernel.grouped_matmul``); the plain version takes none.
    """
    if any_dtensor(x, w, group_sizes):
        return shard_local(
            "gmm", lambda *a: gmm(*a, events=events),
            [("x", x, "e.."), ("w", w, "e.f"), ("group_sizes", group_sizes, "e")], "e.f")
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, w, group_sizes)
    _timing.events = events
    try:
        return _GMM(x, w, group_sizes)
    finally:
        _timing.events = None


def expert_ffn_swiglu(
    x: torch.Tensor,            # (E, C, d) capacity-packed tokens
    w_gate: torch.Tensor,       # (E, d, f)
    w_up: torch.Tensor,         # (E, d, f)
    w_down: torch.Tensor,       # (E, f, d)
    group_sizes: torch.Tensor,  # (E,) int32
) -> torch.Tensor:
    """``silu(gmm(x, w_gate)) * gmm(x, w_up)``, then ``gmm(., w_down)``: the
    experts' SwiGLU FFN over the occupied rows of each bin, ``(E, C, d)``.

    On the card the three products are kernel launches, whose outputs carry
    no gradient: there, with autograd recording and an input that requires
    grad, this raises rather than train through them silently.  The JAX
    package's kernel route has no gradient either (``pallas_call`` has no
    transpose and ``ops.gmm`` no ``custom_vjp``): ``jax.grad`` through it
    raises ``NotImplementedError``, which ``tests/test_torch_moe.py`` pins.
    """
    if x.device.type != "cpu" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w_gate, w_up, w_down)):
        raise NotImplementedError(
            "the grouped-matmul kernel has no backward, as the reference's "
            "kernel route has none (jax.grad through ops.gmm raises): MoE "
            "training on one card is not ported by design, ROADMAP queue 1 item 12")
    h = F.silu(gmm(x, w_gate, group_sizes)) * gmm(x, w_up, group_sizes)
    return gmm(h, w_down, group_sizes)

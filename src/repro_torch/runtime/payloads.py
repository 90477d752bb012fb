"""Pluggable PE payloads: what a live processing element *does* per message.

A payload is an async callable ``(msg, clock) -> None`` awaited by the PE
task while it holds the message; when it returns, the message is complete.
Two built-ins:

- ``sleep`` — a calibrated timed wait: the PE occupies its slot for exactly
  ``msg.duration`` scenario seconds, so service times mirror the stream
  generator's distributions and the live runtime's scheduling dynamics are
  directly comparable to the discrete-event simulator.
- ``torch`` — launches the hand-written Hopper grouped-matmul kernel
  (``kernels.grouped_matmul.ops.gmm``) once per message in a worker thread,
  waits for it on a CUDA event, then pads with a calibrated sleep up to
  ``msg.duration``.  The master keeps brokering and the IRM keeps packing
  while the card computes.

Payloads resolve by name through ``make_payload`` so scenarios/CLI can
select them (``--payload torch``), mirroring ``core.binpack.make_packer``.
Each payload also exposes ``run_sync(msg, time_scale)``, the blocking
variant a process-backed transport executes on its worker-side PE threads
(``runtime.transport.MultiprocTransport``), which returns the message's
device ms, and ``kernel_launches()``; the transport sends both back to the
master with each completion.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.grouped_matmul import ops
from .annotations import worker_side

__all__ = ["SleepPayload", "TorchPayload", "make_payload", "PAYLOADS"]


class SleepPayload:
    """Occupy the PE for ``msg.duration`` scenario seconds (timed wait)."""

    name = "sleep"

    async def __call__(self, msg, clock) -> None:
        await clock.sleep(msg.duration)

    @worker_side
    def run_sync(self, msg, time_scale: float) -> Optional[float]:
        """Blocking variant for a transport's worker-process PE thread;
        returns the message's device ms: ``None``, as it uses no device."""
        if msg.duration > 0:
            time.sleep(msg.duration * time_scale)

    def kernel_launches(self) -> int:
        """Kernel launches made for this payload: none."""
        return 0


def _standard_normal_f32(rng: np.random.Generator,
                         shape: Tuple[int, ...]) -> np.ndarray:
    """``rng.standard_normal(shape)`` cast to float32, drawn one leading
    slice at a time: the same values in the same order, without holding
    the whole float64 draw (4.3 GB for a 128x2048x2048 weight) at once."""
    out = np.empty(shape, np.float32)
    for i in range(shape[0]):
        out[i] = rng.standard_normal(shape[1:])
    return out


def _tensor(a, dtype, device) -> torch.Tensor:
    """``a`` on ``device``; copies on the host only where ``a`` is not
    already a writable C-contiguous array of ``dtype``."""
    return torch.from_numpy(np.require(a, dtype, ["C", "W"])).to(device)


class TorchPayload:
    """Run the grouped-matmul kernel per message, padded to ``msg.duration``.

    The tensors are ``default_rng(0)`` draws — ``x (experts, rows, dim)``,
    then ``w (experts, dim, dim)`` — with every bin full.  ``device``
    defaults to ``"cuda"``; with no card that raises: the plain CPU version
    runs only when asked for with ``device="cpu"``.  On the card each
    message's device time (CUDA events recorded just around its kernel
    launch) is appended to ``device_ms``.
    """

    name = "torch"

    def __init__(self, experts: int = 4, rows: int = 64, dim: int = 64,
                 device=None):
        rng = np.random.default_rng(0)
        x = _standard_normal_f32(rng, (experts, rows, dim))
        w = _standard_normal_f32(rng, (experts, dim, dim))
        self._setup(x, w, np.full((experts,), rows, np.int32), device)

    @classmethod
    def from_numpy(cls, x: np.ndarray, w: np.ndarray, sizes: np.ndarray,
                   device=None) -> "TorchPayload":
        """A payload over given arrays (e.g. another payload's state)."""
        self = cls.__new__(cls)
        self._setup(x, w, sizes, device)
        return self

    def _setup(self, x, w, sizes, device) -> None:
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchPayload runs on a CUDA device and none is "
                    "available; pass device='cpu' to run its plain version"
                )
            device = "cuda"
        self.device = torch.device(device)
        self._launches0 = ops.launches
        self._x = _tensor(x, np.float32, self.device)
        self._w = _tensor(w, np.float32, self.device)
        self._sizes = _tensor(sizes, np.int32, self.device)
        # serialises enqueueing, so each message's event pair brackets its
        # own launch and no other thread's
        self._launch_lock = threading.Lock()
        self.device_ms: List[float] = []
        self._compute()  # build/load the kernel outside any message's budget
        self.device_ms.clear()

    def kernel_launches(self) -> int:
        """Kernel launches this process made since the payload was set up,
        its warm-up included (read from ``ops.launches``)."""
        return ops.launches - self._launches0

    @worker_side
    def _compute(self) -> torch.Tensor:
        """One grouped matmul; returns once its result is ready."""
        return self._timed_compute()[0]

    @worker_side
    def _timed_compute(self) -> Tuple[torch.Tensor, Optional[float]]:
        """One grouped matmul and, on the card, its device ms."""
        if self.device.type != "cuda":
            return ops.gmm(self._x, self._w, self._sizes), None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(self.device), self._launch_lock:
            out = ops.gmm(self._x, self._w, self._sizes, (start, end))
        end.synchronize()
        ms = start.elapsed_time(end)
        self.device_ms.append(ms)
        return out, ms

    async def __call__(self, msg, clock) -> None:
        loop = asyncio.get_running_loop()
        wall0 = time.perf_counter()
        await loop.run_in_executor(None, self._compute)
        spent_virtual = (time.perf_counter() - wall0) / clock.time_scale
        await clock.sleep(msg.duration - spent_virtual)

    @worker_side
    def run_sync(self, msg, time_scale: float) -> Optional[float]:
        """Blocking variant for a transport's worker-process PE thread:
        the kernel runs on the PE thread itself, then pads to the
        message's calibrated duration.  Returns the message's device ms
        (``None`` off the card)."""
        wall0 = time.perf_counter()
        _, ms = self._timed_compute()
        remaining = msg.duration * time_scale - (time.perf_counter() - wall0)
        if remaining > 0:
            time.sleep(remaining)
        return ms


PAYLOADS: Dict[str, Callable[[], object]] = {
    "sleep": SleepPayload,
    "torch": TorchPayload,
}


def make_payload(name: str, **kwargs):
    """Resolve a payload by name (mirrors ``core.binpack.make_packer``)."""
    try:
        factory = PAYLOADS[name]
    except KeyError:
        raise ValueError(
            f"unknown payload {name!r}; available: {sorted(PAYLOADS)}"
        ) from None
    return factory(**kwargs)

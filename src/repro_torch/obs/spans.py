"""Spans and counters on the model path, on the profiler's clock.

The train step and prefill record where their work happens, so that a
reader can join it to the device operations a ``torch.profiler`` session
records (``portbench/metrics/`` does).  Recording follows the session: a
span or counter is recorded only while a session records on the calling
thread (``torch._C._autograd._profiler_enabled()``, one C call at a span's
entry).  Outside one, ``span`` returns a shared null context and ``count``
returns at once, allocating nothing; there is no other switch.

- A span is ``Span(name, start_ns, end_ns, id, parent, thread, step,
  marks)``, stamped with ``time.time_ns()``, the clock kineto stamps device
  operations with.  Its parent is the innermost span open on its thread,
  or the one it is given: a span opened on another thread, as autograd's
  device thread runs a CUDA backward, names its parent.  A span with no
  parent starts a step (a train step, a prefill batch): it and every span
  below it carry that step's id.
- A counter increment is ``Count(name, t_ns, value)``; a reader sums those
  inside a window as it takes the spans inside it.
- A span marked on a CUDA tensor (``mark=t``) launches a marker kernel
  (``MARKER``, ``torch.cuda._sleep(0)``'s) on ``t``'s device at its start
  and at its end, and keeps their indices in ``marks``: the k-th marker
  launched is the k-th ``MARKER`` operation the device runs.  The device
  operations between a span's two markers are exactly the work it
  launched, in stream order, without a synchronization that would let the
  device run dry; only while recording: an untraced step launches none.

Records stay in memory, one buffer for the process as the profiler session
it follows is one, until ``drain()`` takes them.  They are not runtime
protocol events, so they do not go through ``EventBus.emit`` and its
manifest (rule R6).  This module is the model path's one measurement clock:
rule R5 allows its wall-clock reads, as it allows ``runtime/clock.py``'s.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Callable, List, NamedTuple, Optional, Tuple, Union

import torch

__all__ = ["MARKER", "Count", "Span", "backward", "count", "drain", "recording", "span"]

#: True while a profiler session records on the calling thread.
recording: Callable[[], bool] = torch._C._autograd._profiler_enabled

#: A substring of the marker kernel's name in a device trace.
MARKER = "spin_kernel"


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    thread: int
    step: int
    marks: Optional[Tuple[int, int]] = None


class Count(NamedTuple):
    name: str
    t_ns: int
    value: float


_NULL = contextlib.nullcontext()
_records: List[Union[Span, Count]] = []
_ids = itertools.count(1)
_steps = itertools.count(1)
_marks = itertools.count()
_launch = threading.Lock()
_local = threading.local()


def _open_spans() -> List["_Open"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _mark(t: Optional[torch.Tensor]) -> Optional[int]:
    """Launch a marker on ``t``'s device and give its index; None off CUDA."""
    if t is None or t.device.type != "cuda":
        return None
    with _launch, torch.cuda.device(t.device):
        torch.cuda._sleep(0)
        return next(_marks)


class _Open:
    """A span being recorded: opened by ``start`` (or ``with``), recorded
    by ``stop``."""

    __slots__ = ("name", "on", "given", "id", "parent", "step", "start_ns", "first")

    def __init__(self, name: str, on: Optional[torch.Tensor], parent: Optional["_Open"]):
        self.name, self.on, self.given = name, on, parent

    def start(self) -> "_Open":
        stack = _open_spans()
        parent = self.given if self.given is not None else (stack[-1] if stack else None)
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.step = next(_steps) if parent is None else parent.step
        stack.append(self)
        self.first = _mark(self.on)
        self.start_ns = time.time_ns()
        return self

    def stop(self) -> None:
        last = _mark(self.on)
        end = time.time_ns()
        stack = _open_spans()
        if self in stack:
            stack.remove(self)
        marks = None if self.first is None else (self.first, last)
        _records.append(Span(self.name, self.start_ns, end, self.id, self.parent,
                             threading.get_ident(), self.step, marks))

    def __enter__(self) -> "_Open":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()


def span(name: str, *, mark: Optional[torch.Tensor] = None):
    """A context that records the span ``name`` while a profiler session
    records (``as`` gives the open span, for a child on another thread to
    name), and does nothing otherwise (``as`` gives None)."""
    return _Open(name, mark, None) if recording() else _NULL


def count(name: str, value: float) -> None:
    """Record ``value`` under the counter ``name`` while a profiler session
    records."""
    if recording():
        _records.append(Count(name, time.time_ns(), value))


def drain() -> List[Union[Span, Count]]:
    """The records so far, taken out of the buffer."""
    n = len(_records)
    out = _records[:n]
    del _records[:n]
    return out


class _CloseOnGrad(torch.autograd.Function):
    """Identity on the inputs: its backward, which runs once every input's
    gradient is in, stops the span."""

    @staticmethod
    def forward(ctx, box: _Open, *xs: torch.Tensor):
        ctx.box = box
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads: torch.Tensor):
        ctx.box.stop()
        return (None, *grads)


class _OpenOnGrad(torch.autograd.Function):
    """Identity on the output: its backward, the first of the work's to
    run, starts the span."""

    @staticmethod
    def forward(ctx, box: _Open, y: torch.Tensor):
        ctx.box = box
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        ctx.box.start()
        return None, grad


def backward(name: str, parent: Optional[_Open], fn: Callable, *args: Any, **kwargs: Any):
    """``fn(*args, **kwargs)``, with the backward of its first output, down
    to the arguments that require grad, recorded as the span ``name``: it
    starts when that output's gradient arrives and stops when every such
    argument has its own, marked on the first of them, under ``parent``
    (the forward's span).  Without a parent, as when nothing records,
    ``fn`` alone, with nothing inserted into the graph."""
    grad_args = [i for i, a in enumerate(args)
                 if isinstance(a, torch.Tensor) and a.requires_grad]
    if parent is None or not grad_args:
        return fn(*args, **kwargs)
    box = _Open(name, args[grad_args[0]], parent)
    args = list(args)
    for i, t in zip(grad_args, _CloseOnGrad.apply(box, *(args[i] for i in grad_args))):
        args[i] = t
    out = fn(*args, **kwargs)
    return (_OpenOnGrad.apply(box, out[0]), *out[1:])

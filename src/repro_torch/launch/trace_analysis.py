"""What one step dispatches, counted per device: FLOPs, dot bytes,
collective wire bytes split NVLink/network, the bytes every op moves, and
the peak of the live bytes.

The counterpart of ``repro/launch/hlo_analysis.py``, which parses XLA's
optimized HLO.  The port has no HLO: ``analyze_step`` runs the step under
a dispatch mode and reads the eager dispatch stream, which holds every op
the card would run, each loop iteration dispatched anew (layers, the
chunked cross-entropy), but for the recurrent loops over time, which it
counts as the JAX module counts a loop body by its trip count
(``_cond_trips``): one chunk, times the chunks (below).

Under DTensor the mode declines the DTensor-level call (it returns
``NotImplemented``, as ``CommDebugMode`` does), DTensor redispatches the
local ops and the collectives its layouts need, and the mode counts those:
the counts are one device's, the rank whose coordinate the mesh reports
(rank 0 under the ``fake`` process group, where the collectives move
nothing and still dispatch).

The JAX module's conventions are kept:
  - FLOPs: ``torch.utils.flop_counter``'s formulas, the ones
    ``FlopCounterMode`` applies (2 M N K a product), with the kernels'
    operators counted by their own formulas (``kernels/custom_ops.py``);
  - ``dot_bytes``: the operand and result bytes of every product and
    kernel, the HBM proxy;
  - collective wire bytes per device: all-reduce 2x the tensor, all-gather
    the output, reduce-scatter the input, all-to-all the tensor
    (``analysis.collective_wire_bytes``); a group whose ranks span at least
    ``pod_size`` (``max - min >= pod_size``) crosses a pod: on this card,
    an 8-GPU node, so those bytes go over the network (``dcn``), the rest
    over NVLink (``ici``).
Where the JAX package takes XLA's ``bytes accessed`` (a fused program's
traffic, loop bodies once), the port takes ``eager_bytes``: each op's
inputs and outputs once (views move nothing; a gather moves what it
gathers; an in-place scatter moves what it writes), the traffic of an
unfused eager step.

Memory: the arguments' storages and every op's new output storage are
held live until freed (a weak reference on each storage); ``peak_bytes``
is the most held at once, autograd's saved tensors included.

The stand-ins are meta tensors (or real ones): ops dispatched while a
``FakeTensorMode`` is active are DTensor's own shape propagation, run on
fake tensors of the global shapes, and are not counted.

Loops over time: the recurrent layers' ``models.scan_utils.chunked_scan``
runs its chunks one after another, each the same ops on the same shapes
(the time axis is padded to whole chunks).  ``analyze_step`` sets
``scan_utils.LOOP_COUNTER`` to its counter; a scan of meta stand-ins then
hands its first chunk to the counter's ``scan``, which runs it and counts
it ``n`` times (``repeated``), the counterpart of the JAX module's trip count: FLOPs,
bytes, ops and collectives times ``n``, and the peak as the full loop's,
whose last chunk runs with the outputs of the ``n - 1`` before it live;
those outputs are allocated, uncounted, so that what follows the loop sees
them.  Under autograd (a train step) the chunk runs under its checkpoint,
as every chunk does, between two identities whose backwards bracket the
chunk's backward (``_ChunkEnd``, ``_ChunkStart``): the checkpoint's
recompute and the gradients are counted ``n`` times the same way, the peak
that of the full loop's last backward chunk, which runs with the other
chunks' input gradients live.  A scan of real tensors runs every chunk.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import weakref
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map_only
from torch.utils.checkpoint import checkpoint

from ..kernels.custom_ops import BYTES
from ..models import scan_utils
from .analysis import KINDS, collective_kind, collective_wire_bytes

__all__ = ["StepCost", "analyze_step", "top_collectives"]

aten = torch.ops.aten

_DOTS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm}
# metadata queries: no work (as FlopCounterMode passes them by)
_META = {aten.is_contiguous, aten.is_strides_like_format, aten.is_non_overlapping_and_dense,
         aten.size, aten.sym_size, aten.stride, aten.sym_stride, aten.storage_offset,
         aten.sym_storage_offset, aten.numel, aten.sym_numel, aten.dim,
         torch.ops.prim.layout, torch.ops.prim.device}
# no data moved: allocation without initialisation, and waits
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, torch.ops._c10d_functional.wait_tensor}
# reads only what it gathers: 2x the output, plus the indices
_GATHERS = {aten.index, aten._unsafe_index, aten.index_select, aten.gather, aten.embedding,
            aten.take}
# in place, writes only the slices it is given: 2x the values, plus the indices
_SCATTERS = {aten.index_put_, aten._index_put_impl_, aten.index_copy_, aten.index_add_,
             aten.scatter_, aten.scatter_add_, aten.scatter_reduce_, aten.masked_scatter_,
             aten.index_fill_, aten.masked_fill_}


@dataclasses.dataclass
class StepCost:
    """One device's counts for a step (``HloCost``'s fields and more)."""

    flops: float = 0.0
    dot_bytes: float = 0.0           # product and kernel operands + results
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in KINDS})
    ici_bytes: float = 0.0
    dcn_bytes: float = 0.0
    coll_count: float = 0.0
    eager_bytes: float = 0.0         # every op's inputs and outputs once
    ops: int = 0                     # ops dispatched (kernels launched, roughly)
    arg_bytes: float = 0.0           # the arguments' storages
    peak_bytes: float = 0.0          # most live bytes at once, arguments included
    out_bytes: float = 0.0           # the result's storages that are new
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    # ``analyze_step(..., top_held=n)`` only: the storages held at the peak
    # (but the arguments'), as (op, shape, dtype, bytes), the largest first
    held_at_peak: List[Tuple[str, Tuple[int, ...], str, int]] = dataclasses.field(
        default_factory=list)
    # (kind, group, shape, dtype) -> [wire bytes over all calls, calls]
    collectives: Dict[Tuple[str, str, Tuple[int, ...], str], List[float]] = (
        dataclasses.field(default_factory=dict))

    @property
    def coll_bytes(self) -> float:
        return self.ici_bytes + self.dcn_bytes

    def add_times(self, since: "StepCost", n: int) -> None:
        """Add ``n`` times what was counted after the snapshot ``since``
        (every count but the memory's)."""
        for f in ("flops", "dot_bytes", "ici_bytes", "dcn_bytes", "coll_count",
                  "eager_bytes", "ops"):
            setattr(self, f, getattr(self, f) + n * (getattr(self, f) - getattr(since, f)))
        for d, d0 in ((self.coll, since.coll), (self.flops_by_op, since.flops_by_op)):
            for k, v in list(d.items()):
                d[k] = v + n * (v - d0.get(k, 0.0))
        for k, row in self.collectives.items():
            row0 = since.collectives.get(k, [0.0, 0])
            row[0] += n * (row[0] - row0[0])
            row[1] += n * (row[1] - row0[1])


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _read_bytes(t: torch.Tensor) -> int:
    """What reading ``t`` once moves: its elements, or its storage where
    that is smaller (a broadcast view)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):  # a tensor without storage
        return n


def _storages(ts: List[torch.Tensor]) -> set:
    return {t.untyped_storage()._cdata for t in ts}


def _nbytes(ts: List[torch.Tensor]) -> int:
    return sum(_read_bytes(t) for t in ts)


def _op_bytes(func, packet, args, kwargs, out) -> float:
    """Bytes an op moves, by the module's rule (see the docstring)."""
    if packet in BYTES:
        return BYTES[packet](*args, *kwargs.values(), out)
    if packet in _FREE or func.is_view:
        return 0.0
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    if not func._schema.is_mutable and _storages(outs) & _storages(ins):
        return 0.0  # an alias of an input (``_unsafe_view``, ``alias``): no data moved
    if packet in _GATHERS:
        idx = [t for t in ins if not t.is_floating_point()]
        return 2.0 * _nbytes(outs) + _nbytes(idx)
    if packet in _SCATTERS:
        rest = ins[1:]  # everything but the tensor written into
        vals = [t for t in rest if t.is_floating_point()]
        return _nbytes(rest) + (max(_read_bytes(t) for t in vals) if vals else 0)
    if packet in (aten.copy_, aten.zero_, aten.fill_):
        return _nbytes(ins[1:]) + _nbytes(ins[:1])
    return _nbytes(ins) + _nbytes(outs)


def _rebuild(tree: Any, leaves: Iterator[torch.Tensor]) -> Any:
    """``tree`` with its leaves replaced, in ``scan_utils._leaves``'s order."""
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(t, leaves) for t in tree)
    return next(leaves)


class _Bracket:
    """The backward of one chunk counted as ``n``: opened by ``_ChunkEnd``'s
    backward, the first of the chunk's nodes the engine runs, and closed by
    ``_ChunkStart``'s, the first after its last (the engine runs the ready
    node created last first, so nothing else runs in between)."""

    def __init__(self, counter: "_Counter", n: int):
        self.counter, self.n = counter, n

    def open(self) -> None:
        self.cm = self.counter.repeated(self.n)
        self.more = self.cm.__enter__()

    def close(self, grads: Tuple[Any, ...]) -> None:
        # the other chunks' input gradients, live until the inputs' split
        self.more([g for g in grads if g is not None], backward=True)
        self.cm.__exit__(None, None, None)


class _ChunkStart(torch.autograd.Function):
    """The identity on a counted chunk's inputs; its backward closes the
    chunk's count."""

    @staticmethod
    def forward(ctx, bracket, *inputs):
        ctx.bracket = bracket
        return tuple(t.view_as(t) for t in inputs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.bracket.close(grads)
        return (None,) + grads


class _ChunkEnd(torch.autograd.Function):
    """The identity on a counted chunk's outputs; its backward opens the
    chunk's count.  It saves ``extra``, stand-ins for the carries the other
    chunks' checkpoints save, as a checkpoint saves its inputs (an enclosing
    checkpoint's hooks drop them), until that backward."""

    @staticmethod
    def forward(ctx, bracket, n_out, *flat):
        ctx.bracket, ctx.n_extra = bracket, len(flat) - n_out
        ctx.save_for_backward(*flat[n_out:])
        return tuple(t.view_as(t) for t in flat[:n_out])

    @staticmethod
    def backward(ctx, *grads):
        ctx.saved_tensors  # unpacked (an enclosing checkpoint's copies freed), then freed
        ctx.bracket.open()
        return (None, None) + grads + (None,) * ctx.n_extra


class _Counter(TorchDispatchMode):
    supports_higher_order_operators = True

    def __init__(self, cost: StepCost, pod_size: int, groups: Dict[str, str],
                 top_held: int = 0):
        super().__init__()
        self.cost, self.pod_size, self.groups = cost, pod_size, groups
        self.top_held = top_held  # > 0: name what is held at the peak
        self.origin: Dict[int, Tuple[str, Tuple[int, ...], str]] = {}
        self.flop_registry = dict(flop_counter.flop_registry)
        self.live: Dict[int, int] = {}
        self.held = 0
        self.window = 0       # the most held since the innermost ``repeated`` began
        self.paused = False   # pass ops through uncounted
        self.open = True
        self._cross: Dict[str, Tuple[bool, str]] = {}

    # ---- memory ---------------------------------------------------------
    def hold(self, t: torch.Tensor, op: str = "argument") -> int:
        """Count ``t``'s storage live until it is freed; its bytes if new.
        ``op`` names what made it, for the ``top_held`` listing."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return 0
        n = st.nbytes()
        self.live[key] = n
        self.held += n
        if self.top_held:
            self.origin[key] = (op, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            if self.held > self.cost.peak_bytes:
                self.cost.held_at_peak = [(*self.origin[k], b) for k, b in self.live.items()]
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.held)
        self.window = max(self.window, self.held)
        weakref.finalize(st, self._free, key)
        return n

    # ---- loops ----------------------------------------------------------
    @contextlib.contextmanager
    def repeated(self, n: int) -> Iterator[Callable[[Any], List[Any]]]:
        """Count the body of the ``with`` as ``n`` runs of it: the first of
        ``n`` loop iterations, each the same ops on the same shapes, whose
        outputs stay live until the loop ends, and whose carry replaces the
        one before.  It yields ``more(outputs)``, to be called at the end of
        the body with the iteration's outputs: it returns ``n - 1`` more,
        allocated uncounted, for the iterations not run.

        The last iteration of the full loop starts with the first's leftover
        (``held`` after it, carry and outputs), the outputs of ``n - 2`` more,
        and peaks as far above its start as the first did.  With
        ``backward=True`` the body is a chunk's backward, whose outputs are
        the chunk's input gradients: the full loop runs its chunks last to
        first, and the last of them runs with the ``n - 1`` others'
        gradients live throughout, so it peaks that far above the body's
        own peak."""
        start, window0 = self.held, self.window
        self.window = start
        since = copy.deepcopy(self.cost)
        last = [0]

        def more(outputs: Any, backward: bool = False) -> List[Any]:
            out_bytes = sum(_local(t).untyped_storage().nbytes() for t in _tensors(outputs))
            last[0] = (self.window + (n - 1) * out_bytes if backward else
                       self.held + (n - 2) * out_bytes + (self.window - start))
            return self.stand_ins(outputs, n - 1)

        yield more
        self.cost.add_times(since, n - 1)
        self.cost.peak_bytes = max(self.cost.peak_bytes, last[0])
        self.window = max(window0, self.window, last[0])

    def stand_ins(self, tree: Any, k: int) -> List[Any]:
        """``k`` copies of ``tree``'s tensors, allocated and held, uncounted:
        what the loop iterations not run would leave live."""
        self.paused = True
        try:
            return [tree_map_only(torch.Tensor, torch.empty_like, tree) for _ in range(k)]
        finally:
            self.paused = False

    def scan(self, step: Callable[[Any, Any], Tuple[Any, Any]], init: Any, xs: Any,
             n: int, remat: bool) -> Tuple[Any, List[Any]]:
        """``scan_utils.LOOP_COUNTER``'s hook: the first chunk ``xs`` of an
        ``n``-chunk ``chunked_scan``, counted for all.  Its forward runs under
        ``repeated(n)``; under autograd (``remat``) it runs under its
        checkpoint, as every chunk does, between ``_ChunkStart`` and
        ``_ChunkEnd``, whose backwards bracket its backward (the checkpoint's
        recompute and the chunk's gradients) under another ``repeated(n)``.
        Returns its final carry and the ``n`` chunks' outputs, the other
        ``n - 1`` allocated uncounted."""
        leaves, run = scan_utils._leaves, scan_utils._scan
        if not remat:
            with self.repeated(n) as more:
                carry, ys = run(step, init, xs)
                return carry, [ys] + more(ys)
        bracket = _Bracket(self, n)
        k = len(leaves(init))
        with self.repeated(n) as more:
            extra = leaves(self.stand_ins(init, n - 1))
            flat = _ChunkStart.apply(bracket, *leaves(init), *leaves(xs))
            carry, ys = checkpoint(run, step, _rebuild(init, iter(flat[:k])),
                                   _rebuild(xs, iter(flat[k:])), use_reentrant=False)
            out = leaves(carry) + leaves(ys)
            out = _ChunkEnd.apply(bracket, len(out), *out, *extra)
            del extra
            carry = _rebuild(carry, iter(out[:k]))
            ys = _rebuild(ys, iter(out[k:]))
            return carry, [ys] + more(ys)

    def _free(self, key: int) -> None:
        if self.open:
            self.held -= self.live.pop(key, 0)

    # ---- collectives ----------------------------------------------------
    def _group(self, name: str) -> Tuple[bool, str]:
        """(crosses a pod, label) of a process group by its name."""
        if name not in self._cross:
            ranks = dist.get_process_group_ranks(
                dist.distributed_c10d._resolve_process_group(name))
            label = self.groups.get(name, f"ranks {min(ranks)}..{max(ranks)}")
            self._cross[name] = (max(ranks) - min(ranks) >= self.pod_size, label)
        return self._cross[name]

    def _collective(self, kind: str, args, out) -> None:
        inp, res = _local(args[0]), _tensors(out)[0]
        wire = collective_wire_bytes(kind, _read_bytes(inp), _read_bytes(res))
        cross, label = self._group(next(a for a in reversed(args) if isinstance(a, str)))
        c = self.cost
        c.coll[kind] += wire
        c.coll_count += 1
        if cross:
            c.dcn_bytes += wire
        else:
            c.ici_bytes += wire
        row = c.collectives.setdefault(
            (kind, label, tuple(inp.shape), str(inp.dtype).replace("torch.", "")), [0.0, 0])
        row[0] += wire
        row[1] += 1

    # ---- dispatch -------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor redispatches its local ops to us
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            # DTensor's shape propagation, on fake tensors of the global
            # shapes: bookkeeping, not the device's work
            return func(*args, **kwargs)
        if self.paused:  # ``repeated``'s stand-ins for the iterations not run
            out = func(*args, **kwargs)
            for t in _tensors(out):
                self.hold(t, "stand-in")
            return out
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in _META:
            return func(*args, **kwargs)
        if packet not in self.flop_registry:  # as FlopCounterMode: decompose first
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        c = self.cost
        c.ops += 1
        if packet in self.flop_registry:
            f = self.flop_registry[packet](*args, **kwargs, out_val=out)
            c.flops += f
            key = str(packet).replace("aten.", "")
            c.flops_by_op[key] = c.flops_by_op.get(key, 0.0) + f
        moved = _op_bytes(func, packet, args, kwargs, out)
        c.eager_bytes += moved
        if packet in _DOTS or packet in BYTES:
            c.dot_bytes += moved
        ns, name = packet._qualified_op_name.split("::")
        kind = collective_kind(name) if ns == "_c10d_functional" else ""
        if kind:
            self._collective(kind, args, out)
        for t in _tensors(out):
            self.hold(t, str(packet).replace("aten.", ""))
        return out


def _group_labels(mesh: Any) -> Dict[str, str]:
    """A mesh's process groups by name, each labelled by its dim's name."""
    if mesh is None:
        return {}
    names = mesh.mesh_dim_names or tuple(str(i) for i in range(mesh.ndim))
    return {mesh.get_group(i).group_name: names[i] for i in range(mesh.ndim)}


def analyze_step(fn: Callable[..., Any], *args: Any, pod_size: int = 10**9,
                 mesh: Any = None, top_held: int = 0) -> Tuple[Any, StepCost]:
    """Run ``fn(*args)`` under the counting mode; return its result and one
    device's ``StepCost``.  The arguments' storages (the local shards of
    DTensors) are live from the start; ``mesh`` names the collectives'
    groups by mesh dim.  ``top_held`` (a debug listing, off by default)
    fills ``held_at_peak`` with the ``top_held`` largest storages held at
    the peak, each with the op that made it (where a loop counted from one
    chunk sets the peak, at the most held before that)."""
    cost = StepCost()
    counter = _Counter(cost, pod_size, _group_labels(mesh), top_held)
    arg_keys = set()
    for t in _tensors(args):
        t = _local(t)
        arg_keys.add(t.untyped_storage()._cdata)
        cost.arg_bytes += counter.hold(t)
    token = scan_utils.LOOP_COUNTER.set(counter)
    try:
        with counter:
            out = fn(*args)
        cost.out_bytes = sum(
            _local(t).untyped_storage().nbytes() for t in
            {_local(t).untyped_storage()._cdata: t for t in _tensors(out)}.values()
            if _local(t).untyped_storage()._cdata not in arg_keys)
    finally:
        counter.open = False
        scan_utils.LOOP_COUNTER.reset(token)
    rows = [r for r in cost.held_at_peak if r[0] != "argument"]
    cost.held_at_peak = sorted(rows, key=lambda r: -r[3])[:top_held]
    return out, cost


def top_collectives(cost: StepCost, n: int = 20) -> List[Tuple[str, str, float, float]]:
    """The largest collective contributors as (group/shape, kind, wire
    bytes over all calls, calls), ranked by bytes x calls: the JAX
    module's rows, with the call count where it has the loop multiplier."""
    rows = [(f"{group}/{'x'.join(map(str, shape)) or 'scalar'} {dtype}", kind, wire, calls)
            for (kind, group, shape, dtype), (wire, calls) in cost.collectives.items()]
    rows.sort(key=lambda r: -r[2])
    return rows[:n]

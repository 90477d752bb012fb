"""Memory-bounded sequential scans for the recurrent layers (Mamba, xLSTM).

``chunked_scan`` runs a step function over time in chunks, as the JAX
package's does with ``lax.scan`` and ``jax.checkpoint``: when autograd is
recording, each chunk runs under ``torch.utils.checkpoint``, so the forward
keeps only the carries at chunk boundaries and the backward recomputes the
states inside a chunk.  With no gradient to record it is the plain loop.
The inputs are taken apart once, into chunks by one ``split`` a leaf and a
chunk into steps by one ``unbind``: their backwards write each step's
gradient into its own rows, so the backward's traffic is linear in the
sequence (a select a step would add a zero gradient as large as the whole
input for every step).

The loop is Python over time steps, one step's tensor ops at a time: on
the card every op of every step is its own launch (a fused scan kernel is
later work).  A dry-run's count (``launch.trace_analysis``) sets
``LOOP_COUNTER``: a scan of meta stand-ins then hands its first chunk to
the counter, which runs it and counts it for every chunk, forward and
backward, as the JAX package's count multiplies a scan's body by its
trips.  Stand-ins have no values to get wrong; real tensors always run
every chunk.
"""

from __future__ import annotations

import contextvars
from typing import Any, Callable, List, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

__all__ = ["LOOP_COUNTER", "chunked_scan"]

Tree = Any  # a tensor, or a tuple / list / dict of trees

# The counter that may count a loop from its first iteration: an object
# whose ``scan(step, init, xs, n, remat)`` runs the first chunk ``xs`` of an
# ``n``-chunk scan (under its checkpoint if ``remat``), counts it for all
# ``n`` and returns its final carry and the ``n`` chunks' outputs
# (``launch.trace_analysis._Counter``); None outside a dry-run's count.
LOOP_COUNTER: contextvars.ContextVar[Any] = contextvars.ContextVar(
    "loop_counter", default=None)


def _leaves(tree: Tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _is_meta(t: torch.Tensor) -> bool:
    return (t._local_tensor if isinstance(t, DTensor) else t).is_meta


def _map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def _scan(step: Callable[[Tree, Tree], Tuple[Tree, Tree]], carry: Tree,
          xs: Tree) -> Tuple[Tree, Tree]:
    """``lax.scan`` over every step of ``xs`` (dim 0 of each leaf, taken
    apart by one ``unbind``): the final carry and the step outputs stacked
    along a new time dim 0."""
    steps = _map(lambda x: x.unbind(0).__getitem__, xs)
    ys = []
    for t in range(_leaves(xs)[0].shape[0]):
        carry, y = step(carry, _map(lambda get: get(t), steps))
        ys.append(y)
    return carry, _map(lambda *a: torch.stack(a), *ys)


def chunked_scan(
    step: Callable[[Tree, Tree], Tuple[Tree, Tree]],
    init: Tree,
    xs: Tree,
    *,
    chunk_size: int = 128,
) -> Tuple[Tree, Tree]:
    """Equivalent to ``lax.scan(step, init, xs)`` with chunked remat.

    ``xs`` leaves share the leading (time) dimension L.  As in the JAX
    package, the time axis is padded with zeros to a multiple of the chunk
    ``min(chunk_size, L)``: the padded steps run and update the carry, and
    their outputs are trimmed.
    """
    leaves = _leaves(xs)
    if not leaves:
        raise ValueError("chunked_scan needs at least one xs leaf")
    L = leaves[0].shape[0]
    c = min(chunk_size, L)
    pad = (-L) % c
    if pad:
        xs = _map(lambda x: F.pad(x, (0, 0) * (x.dim() - 1) + (0, pad)), xs)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in _leaves(init) + _leaves(xs))
    n = (L + pad) // c
    parts = _map(lambda x: x.split(c).__getitem__, xs)

    def chunk(i: int) -> Tree:
        return _map(lambda get: get(i), parts)

    counter = LOOP_COUNTER.get()
    if (counter is not None and n > 1
            and all(_is_meta(t) for t in _leaves(init) + _leaves(xs))):
        # a dry-run's count of stand-ins: one chunk, counted n times
        carry, chunks = counter.scan(step, init, chunk(0), n, remat)
        return carry, _map(lambda *a: torch.cat(a)[:L], *chunks)
    carry, chunks = init, []
    for i in range(n):
        if remat:
            carry, ys = checkpoint(_scan, step, carry, chunk(i), use_reentrant=False)
        else:
            carry, ys = _scan(step, carry, chunk(i))
        chunks.append(ys)
    ys = _map(lambda *a: torch.cat(a)[:L], *chunks)
    return carry, ys

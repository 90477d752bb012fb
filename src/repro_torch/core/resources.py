"""Multi-dimensional resource vectors — the value type of the vector IRM.

The paper's stated future-work direction (Section VII) is *multi-dimensional
vector bin-packing*: a worker is not just "1.0 of CPU" but a vector of named
capacities (CPU, memory, accelerator, ...), and a container hosting request
consumes a little of each.  ``Resources`` is the value type that flows
through the whole control plane for that mode: profiler estimates, host
request sizes, pre-filled allocator bins, scheduled worker loads, and the
load predictor's backlog demand are all either plain floats (the paper's
scalar CPU fraction — unchanged) or ``Resources`` vectors.

Design constraints, in order:

  1. **Scalar compatibility.**  Every dimension is a fraction of one worker
     in [0, 1]; dimension 0 is always ``"cpu"`` so a plain float and a 1-D
     ``Resources`` mean the same thing, and arithmetic on a 1-D vector is
     bit-for-bit the same IEEE-754 double math as the float path.
  2. **Value semantics.**  Instances are treated as immutable: every
     operation returns a new ``Resources``; nothing in the control plane
     mutates ``values`` in place.
  3. **Small.**  Backed by a tiny float64 ndarray (2-4 dims in practice);
     this is host-side control-plane data, never accelerator data.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence, Tuple, Union

import numpy as np

__all__ = ["Resources", "as_resources", "ResourceLike"]

#: What the control plane accepts wherever a size flows: the paper's scalar
#: CPU fraction, or a named resource vector.
ResourceLike = Union[float, "Resources"]


class Resources:
    """A named, fixed-order vector of per-worker resource fractions."""

    __slots__ = ("dims", "values")

    def __init__(self, dims: Sequence[str], values: Iterable[float]):
        self.dims: Tuple[str, ...] = tuple(dims)
        v = np.asarray(list(values) if not isinstance(values, np.ndarray)
                       else values, dtype=np.float64)
        if v.shape != (len(self.dims),):
            raise ValueError(
                f"values shape {v.shape} does not match dims {self.dims}"
            )
        if not self.dims:
            raise ValueError("Resources needs at least one dimension")
        self.values = v

    # -- constructors --------------------------------------------------------
    @classmethod
    def cpu(cls, x: float) -> "Resources":
        """1-D CPU-only vector — interchangeable with a plain float."""
        return cls(("cpu",), (float(x),))

    @classmethod
    def of(cls, **fractions: float) -> "Resources":
        """``Resources.of(cpu=0.3, mem=0.5)`` — dims in keyword order."""
        return cls(tuple(fractions), tuple(fractions.values()))

    @classmethod
    def zeros(cls, dims: Sequence[str]) -> "Resources":
        return cls(dims, np.zeros(len(tuple(dims))))

    @classmethod
    def full(cls, dims: Sequence[str], value: float) -> "Resources":
        return cls(dims, np.full(len(tuple(dims)), float(value)))

    # -- views ---------------------------------------------------------------
    def get(self, dim: str, default: float = 0.0) -> float:
        try:
            return float(self.values[self.dims.index(dim)])
        except ValueError:
            return default

    def align(self, dims: Sequence[str]) -> "Resources":
        """Reorder/extend to ``dims``; missing dimensions are zero."""
        dims = tuple(dims)
        if dims == self.dims:
            return self
        return Resources(dims, [self.get(d) for d in dims])

    def as_tuple(self) -> Tuple[float, ...]:
        return tuple(float(x) for x in self.values)

    def as_dict(self) -> Mapping[str, float]:
        return {d: float(v) for d, v in zip(self.dims, self.values, strict=True)}

    def to_float(self) -> float:
        """The scalar CPU fraction; only valid for 1-D vectors."""
        if len(self.dims) != 1:
            raise ValueError(
                f"cannot collapse {self.dims} to a scalar; use .get('cpu')"
            )
        return float(self.values[0])

    @property
    def is_scalar(self) -> bool:
        return len(self.dims) == 1

    # -- resource math -------------------------------------------------------
    def dominant(self, capacity: "Resources" = None) -> Tuple[str, float]:
        """(dimension, fraction) of the most-loaded dimension.

        With a ``capacity`` the fractions are utilizations ``v_d / cap_d`` —
        the *dominant resource* of dominant-resource fairness / the
        dominant-dimension lower bound.
        """
        if capacity is not None:
            caps = capacity.align(self.dims).values
            fracs = self.values / np.maximum(caps, 1e-12)
        else:
            fracs = self.values
        i = int(fracs.argmax())
        return self.dims[i], float(fracs[i])

    def clamp(self, lo_cpu: float, hi: float) -> "Resources":
        """Per-dimension clip to [0, hi]; dim 0 (cpu) floored at ``lo_cpu``.

        This is the profiler's size-clamp generalized: a packed item must be
        non-zero in CPU (the paper's (0, 1] item domain) while auxiliary
        dimensions may legitimately be zero.
        """
        v = np.minimum(np.maximum(self.values, 0.0), hi)
        v[0] = min(max(float(self.values[0]), lo_cpu), hi)
        return Resources(self.dims, v)

    # -- arithmetic (value semantics; scalar rhs only for * and /) -----------
    def __add__(self, other: "Resources") -> "Resources":
        if not isinstance(other, Resources):
            return NotImplemented
        if other.dims != self.dims:
            other = other.align(self.dims)
        return Resources(self.dims, self.values + other.values)

    def __radd__(self, other) -> "Resources":
        # supports sum() over Resources (starts at int 0)
        if other == 0:
            return self
        return NotImplemented

    def __sub__(self, other: "Resources") -> "Resources":
        if not isinstance(other, Resources):
            return NotImplemented
        if other.dims != self.dims:
            other = other.align(self.dims)
        return Resources(self.dims, self.values - other.values)

    def __mul__(self, k: float) -> "Resources":
        return Resources(self.dims, self.values * float(k))

    __rmul__ = __mul__

    def __truediv__(self, k: float) -> "Resources":
        return Resources(self.dims, self.values / float(k))

    # -- comparison ----------------------------------------------------------
    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Resources)
            and self.dims == other.dims
            and bool(np.array_equal(self.values, other.values))
        )

    __hash__ = None  # mutable ndarray inside; value type, not a dict key

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        body = ", ".join(f"{d}={v:.3f}" for d, v in zip(self.dims, self.values, strict=True))
        return f"Resources({body})"


def as_resources(x: ResourceLike, dims: Sequence[str]) -> Resources:
    """Coerce a scalar CPU fraction or a ``Resources`` onto ``dims``.

    A plain float is the paper's CPU item size: it lands in dimension 0
    (``"cpu"``) with zero demand in every auxiliary dimension.
    """
    if isinstance(x, Resources):
        return x.align(dims)
    dims = tuple(dims)
    v = np.zeros(len(dims))
    v[0] = float(x)
    return Resources(dims, v)

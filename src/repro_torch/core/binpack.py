"""Online bin-packing algorithms (paper Section IV).

The paper bases its Intelligent Resource Manager on the *Any-Fit* family of
online bin-packing algorithms (Epstein et al. [18]), in particular First-Fit:

  - items ``a_i in (0, 1]`` arrive one by one (no knowledge of future items),
  - bins have capacity 1.0 (a worker VM),
  - a new bin is opened only when no active bin can fit the next item,
  - First-Fit places each item into the *lowest-index* bin that fits and has
    asymptotic performance ratio R = 1.7 with O(n log n) time / O(n) space.

This module implements the Any-Fit family (First-, Best-, Worst-, Next-Fit),
the offline First-Fit-Decreasing variant used as a quality reference, the
Harmonic(M) algorithm the paper cites (Lee & Lee [20]), and — the paper's
stated future-work direction — multi-dimensional *vector* bin-packing.

Two First-Fit implementations are provided: a straightforward O(n·m) scan
(``FirstFit``) and an O(n log m) segment-tree variant (``FirstFitTree``) that
realizes the complexity bound quoted in the paper; they are equivalence-tested
property-style in ``tests/test_binpack.py``.

The object packers are plain Python on purpose: packing is control-flow-heavy,
runs on the *host* (the master node in HarmonicIO terms), and its cost is
microseconds per item (see ``benchmarks/binpack_microbench.py``) — it never
belongs on the accelerator.  The model-side integration points (sequence packing,
KV-page allocation, expert capacity) consume the *results* of these packers.

For fleet-scale bin counts (10⁴ workers) the per-item Python scan over bin
objects dominates the IRM's decision cost, so this module also ships a
second engine, ``NumpyPacker``: the whole fleet is one ``(n_bins, n_dims)``
float64 used-capacity matrix and every placement decision is a masked
``argmax``/``argmin`` over it.  The numpy engine is *decision-equivalent* to
the object packers — same placements, bit for bit — which
``tests/test_packer_equivalence.py`` pins property-style for every policy.
``make_packer(..., engine=...)`` selects between them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np

__all__ = [
    "Item",
    "Bin",
    "PackResult",
    "AnyFit",
    "FirstFit",
    "FirstFitTree",
    "BestFit",
    "WorstFit",
    "NextFit",
    "FirstFitDecreasing",
    "Harmonic",
    "VectorItem",
    "VectorBin",
    "VectorAnyFit",
    "VectorFirstFit",
    "VectorBestFit",
    "VectorNextFit",
    "DominantFit",
    "VectorFirstFitDecreasing",
    "NumpyPacker",
    "NUMPY_BIN_THRESHOLD",
    "lower_bound",
    "vector_lower_bound",
    "make_packer",
    "is_vector_policy",
    "vector_equivalent",
    "ASYMPTOTIC_RATIO",
]

# Best performance ratio in the Any-Fit group (paper Sec. IV-A, [18]).
ASYMPTOTIC_RATIO = {
    "first-fit": 1.7,
    "best-fit": 1.7,
    "worst-fit": 2.0,
    "next-fit": 2.0,
}

_EPS = 1e-9


@dataclasses.dataclass
class Item:
    """A bin-packing item: ``size`` in (0, 1] plus an opaque payload tag.

    In the IRM the tag is a container host request; in the data pipeline it is
    a document id; in the serving engine it is a request id.
    """

    size: float
    tag: Any = None

    def __post_init__(self) -> None:
        if not (0.0 < self.size <= 1.0 + _EPS):
            raise ValueError(f"item size must be in (0, 1], got {self.size}")


class Bin:
    """A fixed-capacity bin (a worker VM in the paper's model)."""

    __slots__ = ("capacity", "used", "items")

    def __init__(self, capacity: float = 1.0, used: float = 0.0):
        self.capacity = float(capacity)
        self.used = float(used)
        self.items: list[Item] = []

    @property
    def free(self) -> float:
        return self.capacity - self.used

    def fits(self, size: float) -> bool:
        return size <= self.free + _EPS

    def add(self, item: Item) -> None:
        if not self.fits(item.size):
            raise ValueError(
                f"item of size {item.size} does not fit bin with free {self.free}"
            )
        self.items.append(item)
        self.used += item.size

    def remove(self, item: Item) -> None:
        self.items.remove(item)
        self.used -= item.size

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Bin(used={self.used:.3f}/{self.capacity:.3f}, n={len(self.items)})"


@dataclasses.dataclass
class PackResult:
    """Outcome of packing a sequence of items.

    ``assignments[i]`` is the bin index item ``i`` was placed in.  ``opened``
    is the number of bins newly opened by this run (the worker scale-up the
    IRM derives from a packing run).
    """

    assignments: list[int]
    bins: list["Bin"]
    opened: int

    @property
    def num_bins(self) -> int:
        return len(self.bins)


class AnyFit:
    """General Any-Fit approach (paper Algorithm 1).

    Items are packed in arrival order.  ``_choose`` returns the index of the
    active bin to place the item in, or ``None`` — in which case (and only in
    which case) a new bin is opened.  Subclasses implement the search
    criterion; the base class owns the shared packing loop.
    """

    name = "any-fit"

    def __init__(self, capacity: float = 1.0, bins: Optional[list[Bin]] = None):
        self.capacity = float(capacity)
        self.bins: list[Bin] = list(bins) if bins is not None else []

    # -- search criterion ---------------------------------------------------
    def _choose(self, size: float) -> Optional[int]:
        raise NotImplementedError

    # -- shared loop (Algorithm 1) ------------------------------------------
    def pack_one(self, item: Item) -> int:
        """Pack a single item online; returns the bin index used."""
        if item.size > self.capacity + _EPS:
            raise ValueError(
                f"item size {item.size} exceeds bin capacity {self.capacity}"
            )
        idx = self._choose(item.size)
        if idx is None:
            idx = self._open_bin()
        self.bins[idx].add(item)
        self._on_update(idx)
        return idx

    def pack(self, items: Iterable[Item]) -> PackResult:
        before = len(self.bins)
        assignments = [self.pack_one(it) for it in items]
        return PackResult(
            assignments=assignments,
            bins=self.bins,
            opened=len(self.bins) - before,
        )

    # -- hooks ---------------------------------------------------------------
    def _open_bin(self) -> int:
        self.bins.append(Bin(self.capacity))
        return len(self.bins) - 1

    def _on_update(self, idx: int) -> None:  # pragma: no cover - hook
        pass

    def reset(self) -> None:
        self.bins = []


class FirstFit(AnyFit):
    """First-Fit: lowest-index active bin that fits (R = 1.7)."""

    name = "first-fit"

    def _choose(self, size: float) -> Optional[int]:
        for i, b in enumerate(self.bins):
            if b.fits(size):
                return i
        return None


class FirstFitTree(AnyFit):
    """First-Fit with an O(log m) per-item search via a max segment tree.

    The tree stores the maximum free capacity over ranges of bin indices;
    descending left-first finds the lowest-index bin whose free capacity is
    >= the item size.  This realizes the O(n log n) total complexity the
    paper quotes for First-Fit.  Behaviour is exactly equivalent to
    ``FirstFit`` (property-tested).
    """

    name = "first-fit-tree"

    def __init__(self, capacity: float = 1.0, bins: Optional[list[Bin]] = None):
        super().__init__(capacity, bins)
        self._cap = 1
        while self._cap < max(1, len(self.bins)):
            self._cap *= 2
        self._tree = [0.0] * (2 * self._cap)
        for i, b in enumerate(self.bins):
            self._tree[self._cap + i] = b.free
        for i in range(self._cap - 1, 0, -1):
            self._tree[i] = max(self._tree[2 * i], self._tree[2 * i + 1])

    def _grow(self) -> None:
        old_cap, old_tree = self._cap, self._tree
        self._cap *= 2
        self._tree = [0.0] * (2 * self._cap)
        self._tree[self._cap : self._cap + old_cap] = old_tree[old_cap : 2 * old_cap]
        for i in range(self._cap - 1, 0, -1):
            self._tree[i] = max(self._tree[2 * i], self._tree[2 * i + 1])

    def _update(self, idx: int, free: float) -> None:
        i = self._cap + idx
        self._tree[i] = free
        i //= 2
        while i >= 1:
            self._tree[i] = max(self._tree[2 * i], self._tree[2 * i + 1])
            i //= 2

    def _choose(self, size: float) -> Optional[int]:
        if self._tree[1] + _EPS < size:
            return None
        i = 1
        while i < self._cap:
            if self._tree[2 * i] + _EPS >= size:
                i = 2 * i
            else:
                i = 2 * i + 1
        idx = i - self._cap
        return idx if idx < len(self.bins) else None

    def _open_bin(self) -> int:
        idx = super()._open_bin()
        if idx >= self._cap:
            self._grow()
        self._update(idx, self.bins[idx].free)
        return idx

    def _on_update(self, idx: int) -> None:
        self._update(idx, self.bins[idx].free)

    def reset(self) -> None:
        super().reset()
        self._cap = 1
        self._tree = [0.0, 0.0]


class BestFit(AnyFit):
    """Best-Fit: the fitting bin with *minimum* residual free capacity."""

    name = "best-fit"

    def _choose(self, size: float) -> Optional[int]:
        best, best_free = None, math.inf
        for i, b in enumerate(self.bins):
            if b.fits(size) and b.free < best_free:
                best, best_free = i, b.free
        return best


class WorstFit(AnyFit):
    """Worst-Fit: the fitting bin with *maximum* free capacity."""

    name = "worst-fit"

    def _choose(self, size: float) -> Optional[int]:
        best, best_free = None, -math.inf
        for i, b in enumerate(self.bins):
            if b.fits(size) and b.free > best_free:
                best, best_free = i, b.free
        return best


class NextFit(AnyFit):
    """Next-Fit: only the most recently opened bin is considered (R = 2)."""

    name = "next-fit"

    def _choose(self, size: float) -> Optional[int]:
        if self.bins and self.bins[-1].fits(size):
            return len(self.bins) - 1
        return None


class FirstFitDecreasing:
    """Offline First-Fit-Decreasing — the quality reference (R = 11/9).

    Not online (sorts the whole sequence), used in benchmarks to quantify the
    optimality gap of the online packers, and by the training-data packer in
    *batch* mode where a whole shard of documents is visible at once.
    """

    name = "first-fit-decreasing"

    def __init__(self, capacity: float = 1.0):
        self.capacity = capacity

    def pack(self, items: Sequence[Item]) -> PackResult:
        order = sorted(range(len(items)), key=lambda i: -items[i].size)
        ff = FirstFitTree(self.capacity)
        assignments = [0] * len(items)
        for i in order:
            assignments[i] = ff.pack_one(items[i])
        return PackResult(assignments=assignments, bins=ff.bins, opened=len(ff.bins))


class Harmonic(AnyFit):
    """Harmonic(M) (Lee & Lee [20], cited by the paper).

    Items are classified into harmonic intervals (1/(k+1), 1/k]; each class k
    packs into its own bins, k items per bin.  R_inf ≈ 1.691 as M → ∞.
    Included for the algorithm-comparison benchmark; the IRM default stays
    First-Fit as in the paper.
    """

    name = "harmonic"

    def __init__(self, capacity: float = 1.0, m: int = 12):
        super().__init__(capacity)
        self.m = m
        # class k in [1, m]; open bin index + count for each class
        self._open: dict[int, int] = {}

    def _class_of(self, size: float) -> int:
        frac = size / self.capacity
        k = min(self.m, int(math.floor(1.0 / max(frac, 1e-12))))
        return max(1, k)

    def _choose(self, size: float) -> Optional[int]:
        k = self._class_of(size)
        idx = self._open.get(k)
        if idx is not None and self.bins[idx].fits(size) and (
            len(self.bins[idx].items) < k
        ):
            return idx
        return None

    def pack_one(self, item: Item) -> int:
        k = self._class_of(item.size)
        idx = self._choose(item.size)
        if idx is None:
            idx = self._open_bin()
            self._open[k] = idx
        self.bins[idx].add(item)
        return idx

    def reset(self) -> None:
        # the class->open-bin map indexes into self.bins; dropping the bins
        # without clearing it leaves stale indices that the next pack()
        # dereferences (IndexError)
        super().reset()
        self._open = {}


# ---------------------------------------------------------------------------
# Multi-dimensional (vector) bin-packing — the paper's future-work Sec. VII.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VectorItem:
    """An item with one size per resource dimension (e.g. CPU, RAM, net)."""

    sizes: tuple[float, ...]
    tag: Any = None

    def __post_init__(self) -> None:
        if not self.sizes:
            raise ValueError("vector item needs at least one dimension")
        for s in self.sizes:
            if not (0.0 <= s <= 1.0 + _EPS):
                raise ValueError(f"vector item sizes must be in [0, 1], got {s}")
        if max(self.sizes) <= 0.0:
            raise ValueError("vector item must be non-zero in some dimension")


class VectorBin:
    __slots__ = ("capacity", "used", "items")

    def __init__(
        self,
        capacity: tuple[float, ...],
        used: Optional[Sequence[float]] = None,
    ):
        self.capacity = tuple(float(c) for c in capacity)
        if used is None:
            self.used = tuple(0.0 for _ in capacity)
        else:
            if len(tuple(used)) != len(self.capacity):
                raise ValueError("used vector must match capacity dimensions")
            self.used = tuple(float(u) for u in used)
        self.items: list[VectorItem] = []

    @property
    def free(self) -> tuple[float, ...]:
        return tuple(c - u for c, u in zip(self.capacity, self.used, strict=True))

    def fits(self, sizes: Sequence[float]) -> bool:
        return all(s <= f + _EPS for s, f in zip(sizes, self.free, strict=True))

    def add(self, item: VectorItem) -> None:
        if not self.fits(item.sizes):
            raise ValueError("vector item does not fit")
        self.items.append(item)
        self.used = tuple(u + s for u, s in zip(self.used, item.sizes, strict=True))


def _normalize_capacity(capacity) -> tuple[float, ...]:
    """Accept a float (all-dims capacity 1-vector), tuple, or Resources."""
    if isinstance(capacity, (int, float)):
        return (float(capacity),)
    as_tuple = getattr(capacity, "as_tuple", None)
    if as_tuple is not None:  # core.resources.Resources (duck-typed: no import
        return as_tuple()     # cycle — binpack stays below resources)
    return tuple(float(c) for c in capacity)


class VectorAnyFit:
    """Shared loop for online vector packers (mirrors ``AnyFit``).

    Like the scalar Any-Fit group, supports pre-filled open bins (active
    workers in the IRM) and opens a new bin only when ``_choose`` finds no
    feasible active bin.
    """

    name = "vector-any-fit"

    def __init__(
        self,
        capacity=(1.0,),
        bins: Optional[list[VectorBin]] = None,
    ):
        self.capacity = _normalize_capacity(capacity)
        self.bins: list[VectorBin] = list(bins) if bins is not None else []

    # -- search criterion ---------------------------------------------------
    def _choose(self, item: VectorItem) -> Optional[int]:
        raise NotImplementedError

    # -- shared loop --------------------------------------------------------
    def pack_one(self, item: VectorItem) -> int:
        if any(s > c + _EPS for s, c in zip(item.sizes, self.capacity, strict=True)):
            raise ValueError(
                f"item sizes {item.sizes} exceed bin capacity {self.capacity}"
            )
        idx = self._choose(item)
        if idx is None:
            self.bins.append(VectorBin(self.capacity))
            idx = len(self.bins) - 1
        self.bins[idx].add(item)
        return idx

    def pack(self, items: Iterable[VectorItem]) -> PackResult:
        before = len(self.bins)
        assignments = [self.pack_one(it) for it in items]
        return PackResult(
            assignments=assignments,
            bins=self.bins,  # type: ignore[arg-type]
            opened=len(self.bins) - before,
        )

    def reset(self) -> None:
        self.bins = []


class VectorFirstFit(VectorAnyFit):
    """First-Fit for vector bin-packing with pluggable tie-break heuristics.

    ``heuristic``:
      - ``"first"``: lowest index feasible bin (pure First-Fit semantics);
      - ``"dot"``:   feasible bin maximizing <used, item> alignment (packs
                     complementary workloads together — Panigrahy et al.);
      - ``"l2"``:    feasible bin minimizing the L2 norm of the residual free
                     vector after placement.
    """

    name = "vector-first-fit"

    def __init__(
        self,
        capacity=(1.0,),
        heuristic: str = "first",
        bins: Optional[list[VectorBin]] = None,
    ):
        if heuristic not in ("first", "dot", "l2"):
            raise ValueError(f"unknown heuristic {heuristic!r}")
        super().__init__(capacity, bins)
        self.heuristic = heuristic

    def _score(self, b: VectorBin, item: VectorItem) -> float:
        if self.heuristic == "dot":
            return sum(u * s for u, s in zip(b.used, item.sizes, strict=True))
        # l2: negative residual norm (maximize => minimize residual)
        resid = [f - s for f, s in zip(b.free, item.sizes, strict=True)]
        return -math.sqrt(sum(r * r for r in resid))

    def _choose(self, item: VectorItem) -> Optional[int]:
        feasible = [i for i, b in enumerate(self.bins) if b.fits(item.sizes)]
        if not feasible:
            return None
        if self.heuristic == "first":
            return feasible[0]
        return max(feasible, key=lambda i: self._score(self.bins[i], item))


class VectorBestFit(VectorAnyFit):
    """Best-Fit generalized: minimize total residual free fraction.

    Among feasible bins, picks the one whose summed post-placement residual
    ``sum_d (free_d - s_d) / cap_d`` is smallest (ties: lowest index) — the
    tightest bin across all dimensions at once.
    """

    name = "vector-best-fit"

    def _choose(self, item: VectorItem) -> Optional[int]:
        best, best_resid = None, math.inf
        for i, b in enumerate(self.bins):
            if not b.fits(item.sizes):
                continue
            resid = sum(
                (f - s) / c
                for f, s, c in zip(b.free, item.sizes, b.capacity, strict=True)
            )
            if resid < best_resid:
                best, best_resid = i, resid
        return best


class VectorNextFit(VectorAnyFit):
    """Next-Fit generalized: only the most recently opened bin is considered."""

    name = "vector-next-fit"

    def _choose(self, item: VectorItem) -> Optional[int]:
        if self.bins and self.bins[-1].fits(item.sizes):
            return len(self.bins) - 1
        return None


class DominantFit(VectorAnyFit):
    """Dominant-resource heuristic.

    Classifies the item by its *dominant* dimension (largest ``s_d / cap_d``
    utilization — dominant-resource fairness's notion of an item's share)
    and places it in the feasible bin with the most free capacity in that
    dimension (ties: lowest index).  Spreads bottleneck demand the way
    Worst-Fit spreads scalar load, but per resource, so CPU-heavy and
    memory-heavy items naturally interleave onto complementary bins.
    """

    name = "dominant-fit"

    def _choose(self, item: VectorItem) -> Optional[int]:
        d = max(
            range(len(item.sizes)),
            key=lambda j: item.sizes[j] / max(self.capacity[j], 1e-12),
        )
        best, best_free = None, -math.inf
        for i, b in enumerate(self.bins):
            if b.fits(item.sizes) and b.free[d] > best_free:
                best, best_free = i, b.free[d]
        return best


class VectorFirstFitDecreasing:
    """Offline FFD for vectors: sort by dominant utilization, then First-Fit.

    The quality reference for the vector packers (as scalar FFD is for the
    Any-Fit group).  In the IRM it acts per packing run: the drained request
    batch is reordered largest-dominant-share-first before placement, which
    is legal because a packing run sees its whole batch at once.
    """

    name = "vector-first-fit-decreasing"

    def __init__(
        self,
        capacity=(1.0,),
        bins: Optional[list[VectorBin]] = None,
    ):
        self.capacity = _normalize_capacity(capacity)
        self.bins: list[VectorBin] = list(bins) if bins is not None else []

    def pack(self, items: Sequence[VectorItem]) -> PackResult:
        items = list(items)
        caps = [max(c, 1e-12) for c in self.capacity]

        def dominant(it: VectorItem) -> float:
            return max(s / c for s, c in zip(it.sizes, caps, strict=True))

        order = sorted(range(len(items)), key=lambda i: -dominant(items[i]))
        before = len(self.bins)
        vff = VectorFirstFit(self.capacity, bins=self.bins)
        assignments = [0] * len(items)
        for i in order:
            assignments[i] = vff.pack_one(items[i])
        self.bins = vff.bins
        return PackResult(
            assignments=assignments,
            bins=self.bins,  # type: ignore[arg-type]
            opened=len(self.bins) - before,
        )

    def reset(self) -> None:
        self.bins = []


# ---------------------------------------------------------------------------
# Numpy engine: the whole fleet as one (n_bins, n_dims) float64 matrix
# ---------------------------------------------------------------------------

# Policies the numpy engine implements.  ``harmonic`` and the scalar FFD are
# microbenchmark-only and stay object-based.
_NUMPY_SCALAR = ("first-fit", "first-fit-tree", "best-fit", "worst-fit",
                 "next-fit")
_NUMPY_VECTOR = ("vector-first-fit", "vector-best-fit", "vector-next-fit",
                 "dominant-fit", "vector-ffd")

# ``make_packer(engine="auto")`` switches to the numpy engine once a packing
# run's pre-filled bin count reaches this threshold.  Below it the object
# packers win (no array setup cost); above it the O(bins) Python scan per
# item dominates and the vectorized argmax/argmin decision takes over.
NUMPY_BIN_THRESHOLD = 64


class NumpyPacker:
    """Array-backed packing engine, decision-equivalent to the object packers.

    State is a single ``(n_bins, n_dims)`` float64 *used*-capacity matrix
    (scalar policies are the ``n_dims == 1`` case) plus the capacity vector;
    every placement decision is a feasibility mask and one masked
    ``argmax``/``argmin`` over the fleet, so a decision costs one vectorized
    pass instead of a Python loop over bin objects.

    Equivalence to the object packers is bit-for-bit on placements, pinned
    by ``tests/test_packer_equivalence.py``.  The invariants that make it
    hold:

    - free capacity is recomputed fresh per decision as ``cap - used`` (never
      decremented incrementally — ``(a - b) - c != a - (b + c)`` in floats),
      exactly like ``Bin.free``/``VectorBin.free``;
    - the used matrix grows by sequential ``used[idx] += sizes`` adds, the
      same additions in the same order as ``Bin.add``/``VectorBin.add``;
    - ``np.argmax``/``np.argmin`` return the *first* occurrence of the
      extremum, matching the object packers' strict ``<``/``>`` scans and
      ``max(feasible, key=...)`` tie-breaks (lowest index wins);
    - per-bin scores sum along ``axis=1`` sequentially for ``n_dims < 8``
      (numpy's pairwise-summation base case), matching Python's ``sum()``.
      Beyond 7 resource dimensions score ties could in principle break
      differently; the IRM's clusters use 2–4 dimensions.

    Supports pre-filled open bins via ``bins=`` (a list of ``Bin`` /
    ``VectorBin``, the object-packer protocol) or ``used=`` (an ``(n,)`` or
    ``(n, D)`` array — the fast path the allocator uses).  ``pack_one`` /
    ``pack`` mirror the object API including oversize validation;
    ``place``/``place_batch`` are the raw-array fast paths with no Item
    wrappers.  The ``bins`` property *materializes* object bins on demand
    (compat/introspection only — it is O(n) per access and the returned
    bins' ``items`` lists are empty).
    """

    def __init__(
        self,
        policy: str,
        capacity: Any = 1.0,
        bins: Optional[list] = None,
        used: Optional[Any] = None,
        heuristic: str = "first",
    ):
        if policy not in _NUMPY_SCALAR and policy not in _NUMPY_VECTOR:
            raise ValueError(
                f"policy {policy!r} has no numpy engine; "
                f"scalar options: {sorted(_NUMPY_SCALAR)}; "
                f"vector options: {sorted(_NUMPY_VECTOR)}"
            )
        if heuristic not in ("first", "dot", "l2"):
            raise ValueError(f"unknown heuristic {heuristic!r}")
        self.policy = policy
        self.name = policy
        self.is_vector = policy in _NUMPY_VECTOR
        # vector-ffd's object twin always places with the default First-Fit
        # criterion after sorting; a non-default heuristic would silently
        # diverge from it.
        self.heuristic = heuristic if policy == "vector-first-fit" else "first"
        caps = _normalize_capacity(capacity)
        if not self.is_vector and len(caps) != 1:
            raise ValueError(
                f"scalar policy {policy!r} takes a scalar capacity, got {caps}"
            )
        self.capacity = caps if self.is_vector else caps[0]
        self._cap_vec = np.asarray(caps, dtype=np.float64)
        self.ndims = len(caps)

        if bins is not None and used is not None:
            raise ValueError("pass pre-filled state as bins= or used=, not both")
        prefill = None
        if bins is not None:
            prefill = np.array(
                [np.atleast_1d(np.asarray(b.used, dtype=np.float64))
                 for b in bins],
                dtype=np.float64,
            ).reshape(len(bins), self.ndims)
        elif used is not None:
            prefill = np.array(used, dtype=np.float64)
            if prefill.ndim == 1:
                prefill = prefill[:, None]
            if prefill.ndim != 2 or prefill.shape[1] != self.ndims:
                raise ValueError(
                    f"used matrix shape {prefill.shape} does not match "
                    f"{self.ndims} capacity dimensions"
                )
        n = 0 if prefill is None else len(prefill)
        alloc = 16
        while alloc < n:
            alloc *= 2
        self._used = np.zeros((alloc, self.ndims), dtype=np.float64)
        if n:
            self._used[:n] = prefill
        self._n = n

    # -- state ---------------------------------------------------------------
    @property
    def n_bins(self) -> int:
        return self._n

    def used_matrix(self) -> "np.ndarray":
        """The live ``(n_bins, n_dims)`` used matrix (a view — copy to keep)."""
        return self._used[: self._n]

    @property
    def bins(self) -> list:
        """Materialize object bins (compat only; O(n), empty ``items``)."""
        if self.is_vector:
            return [VectorBin(self.capacity, used=tuple(row))
                    for row in self._used[: self._n]]
        return [Bin(self.capacity, used=float(row[0]))
                for row in self._used[: self._n]]

    def reset(self) -> None:
        self._n = 0

    def _grow(self) -> None:
        grown = np.zeros((self._used.shape[0] * 2, self.ndims), dtype=np.float64)
        grown[: self._n] = self._used[: self._n]
        self._used = grown

    def _open_bin(self) -> int:
        if self._n == self._used.shape[0]:
            self._grow()
        idx = self._n
        self._used[idx] = 0.0
        self._n += 1
        return idx

    # -- decision ------------------------------------------------------------
    def _choose(self, s: "np.ndarray") -> Optional[int]:
        """Active-bin index for item ``s`` (a (D,) array), or None to open."""
        n = self._n
        if n == 0:
            return None
        p = self.policy
        if p in ("next-fit", "vector-next-fit"):
            free_last = self._cap_vec - self._used[n - 1]
            return n - 1 if bool((s <= free_last + _EPS).all()) else None
        used = self._used[:n]
        free = self._cap_vec - used
        feas = (s <= free + _EPS).all(axis=1)
        if not feas.any():
            return None
        if p in ("first-fit", "first-fit-tree"):
            return int(np.argmax(feas))
        if p == "best-fit":
            return int(np.argmin(np.where(feas, free[:, 0], np.inf)))
        if p == "worst-fit":
            return int(np.argmax(np.where(feas, free[:, 0], -np.inf)))
        if p in ("vector-first-fit", "vector-ffd"):
            if self.heuristic == "first":
                return int(np.argmax(feas))
            if self.heuristic == "dot":
                score = (used * s).sum(axis=1)
            else:  # l2: negative residual norm (maximize => minimize residual)
                resid = free - s
                score = -np.sqrt((resid * resid).sum(axis=1))
            return int(np.argmax(np.where(feas, score, -np.inf)))
        if p == "vector-best-fit":
            resid = ((free - s) / self._cap_vec).sum(axis=1)
            return int(np.argmin(np.where(feas, resid, np.inf)))
        # dominant-fit: most free capacity in the item's dominant dimension
        d = int(np.argmax(s / np.maximum(self._cap_vec, 1e-12)))
        return int(np.argmax(np.where(feas, free[:, d], -np.inf)))

    # -- raw-array fast path (what the allocator drives) ---------------------
    def place(self, sizes: Any) -> int:
        """Place one item given as a length-D array; returns the bin index."""
        s = np.asarray(sizes, dtype=np.float64).reshape(self.ndims)
        idx = self._choose(s)
        if idx is None:
            idx = self._open_bin()
        self._used[idx] += s
        return idx

    def place_batch(self, sizes: Any) -> "np.ndarray":
        """Place ``(m, D)`` (or ``(m,)`` scalar) sizes; returns assignments.

        ``vector-ffd`` reorders the batch largest-dominant-share-first with
        a stable sort (same keys, same order as the object FFD's
        ``sorted(..., key=-dominant)``) and reports assignments in the
        original item order; every other policy packs in arrival order.
        """
        sizes = np.asarray(sizes, dtype=np.float64)
        if sizes.ndim == 1:
            sizes = sizes[:, None]
        m = len(sizes)
        out = np.empty(m, dtype=np.int64)
        if self.policy == "vector-ffd" and m > 1:
            shares = (sizes / np.maximum(self._cap_vec, 1e-12)).max(axis=1)
            order = np.argsort(-shares, kind="stable")
        else:
            order = range(m)
        for i in order:
            out[i] = self.place(sizes[i])
        return out

    # -- object-API compat ----------------------------------------------------
    def pack_one(self, item: Any) -> int:
        """Pack one ``Item``/``VectorItem`` with object-packer validation."""
        if self.policy == "vector-ffd":
            raise TypeError(
                "vector-ffd is an offline packer; use pack() or place_batch()"
            )
        if self.is_vector:
            s = np.asarray(item.sizes, dtype=np.float64)
            if (s > self._cap_vec + _EPS).any():
                raise ValueError(
                    f"item sizes {item.sizes} exceed bin capacity "
                    f"{self.capacity}"
                )
        else:
            if item.size > self.capacity + _EPS:
                raise ValueError(
                    f"item size {item.size} exceeds bin capacity "
                    f"{self.capacity}"
                )
            s = np.asarray([item.size], dtype=np.float64)
        return self.place(s)

    def pack(self, items: Iterable[Any]) -> PackResult:
        items = list(items)
        before = self._n
        if self.policy == "vector-ffd":
            for it in items:
                if any(x > c + _EPS for x, c in zip(it.sizes, self.capacity, strict=True)):
                    raise ValueError(
                        f"item sizes {it.sizes} exceed bin capacity "
                        f"{self.capacity}"
                    )
            sizes = np.array([it.sizes for it in items], dtype=np.float64)
            sizes = sizes.reshape(len(items), self.ndims)
            assignments = [int(i) for i in self.place_batch(sizes)]
        else:
            assignments = [self.pack_one(it) for it in items]
        return PackResult(
            assignments=assignments,
            bins=self.bins,
            opened=self._n - before,
        )


# ---------------------------------------------------------------------------
# Utilities
# ---------------------------------------------------------------------------


def lower_bound(sizes: Iterable[float], capacity: float = 1.0) -> int:
    """L1 lower bound on the optimal bin count: ceil(sum(sizes)/capacity).

    This is the "ideal number of bins" line in the paper's Fig. 10.  Empty
    input needs 0 bins; any strictly positive total needs at least 1 (the
    ``- _EPS`` slack must not round a tiny-but-real load down to "no bins");
    a single item larger than the capacity raises the bound past 1 exactly
    as the L1 sum dictates.
    """
    if capacity <= 0:
        raise ValueError(f"bin capacity must be positive, got {capacity}")
    total = sum(sizes)
    if total <= 0:
        return 0
    return max(1, int(math.ceil(total / capacity - _EPS)))


def vector_lower_bound(
    size_vectors: Iterable[Sequence[float]],
    capacity: Sequence[float] = (1.0,),
) -> int:
    """Dominant-dimension L1 lower bound on the optimal vector bin count.

    Each dimension gives an independent L1 bound ``ceil(sum_d / cap_d)``;
    the optimum can do no better than the worst (dominant) dimension.
    Items must not carry more dimensions than the capacity vector (extra
    demand would silently vanish from the bound otherwise).
    """
    caps = _normalize_capacity(capacity)
    for cap in caps:
        if cap <= 0:
            raise ValueError(f"bin capacity must be positive, got {caps}")
    totals = [0.0] * len(caps)
    for sizes in size_vectors:
        if len(sizes) > len(caps):
            raise ValueError(
                f"size vector {tuple(sizes)} has more dimensions than "
                f"capacity {caps}"
            )
        for d, s in enumerate(sizes):
            totals[d] += s
    best = 0
    for total, cap in zip(totals, caps, strict=True):
        if total > 0:
            best = max(best, max(1, int(math.ceil(total / cap - _EPS))))
    return best


_PACKERS: dict[str, Callable[..., AnyFit]] = {
    "first-fit": FirstFit,
    "first-fit-tree": FirstFitTree,
    "best-fit": BestFit,
    "worst-fit": WorstFit,
    "next-fit": NextFit,
    "harmonic": Harmonic,
}

_VECTOR_PACKERS: dict[str, Callable[..., Any]] = {
    "vector-first-fit": VectorFirstFit,
    "vector-best-fit": VectorBestFit,
    "vector-next-fit": VectorNextFit,
    "dominant-fit": DominantFit,
    "vector-ffd": VectorFirstFitDecreasing,
}

# Scalar policy -> its vector generalization.  Used by the allocator to
# auto-vectorize when a scalar-configured IRM is pointed at a
# multi-resource cluster (worker loads arrive as Resources vectors).
_VECTOR_EQUIVALENT = {
    "first-fit": "vector-first-fit",
    "first-fit-tree": "vector-first-fit",
    "best-fit": "vector-best-fit",
    "next-fit": "vector-next-fit",
    "worst-fit": "dominant-fit",
}


def is_vector_policy(name: str) -> bool:
    """True if ``name`` is a registered multi-dimensional packer."""
    return name in _VECTOR_PACKERS


def vector_equivalent(name: str) -> str:
    """The vector packer to use for a (possibly scalar) policy name."""
    if name in _VECTOR_PACKERS:
        return name
    try:
        return _VECTOR_EQUIVALENT[name]
    except KeyError:
        raise ValueError(
            f"packing algorithm {name!r} has no vector equivalent; "
            f"vector options: {sorted(_VECTOR_PACKERS)}"
        ) from None


def _prefill_count(kw: dict) -> int:
    """Pre-filled bin count implied by a make_packer bins=/used= kwarg."""
    state = kw.get("bins")
    if state is None:
        state = kw.get("used")
    return len(state) if state is not None else 0


def make_packer(
    name: str,
    capacity: Any = 1.0,
    engine: Optional[str] = None,
    **kw: Any,
) -> Any:
    """Factory used by the IRM config (``irm.packing_algorithm``).

    Resolves both the scalar Any-Fit family and the vector packers; vector
    names accept a float capacity (normalized to a 1-vector), a tuple, or a
    ``Resources``.

    ``engine`` selects the implementation:

    - ``None`` / ``"object"``: the per-bin object packers (default);
    - ``"numpy"``: the array-backed ``NumpyPacker`` (raises for policies
      without a numpy implementation, e.g. ``harmonic``);
    - ``"auto"``: the numpy engine when the policy has one *and* the
      pre-filled bin count (``bins=``/``used=``) reaches
      ``NUMPY_BIN_THRESHOLD``, else the object packer.  Both engines make
      identical placement decisions, so "auto" changes latency only.
    """
    if engine not in (None, "object", "numpy", "auto"):
        raise ValueError(
            f"unknown packing engine {engine!r}; "
            "expected 'object', 'numpy', or 'auto'"
        )
    has_numpy = name in _NUMPY_SCALAR or name in _NUMPY_VECTOR
    if engine == "numpy":
        return NumpyPacker(name, capacity=capacity, **kw)
    if engine == "auto" and has_numpy and _prefill_count(kw) >= NUMPY_BIN_THRESHOLD:
        return NumpyPacker(name, capacity=capacity, **kw)
    cls = _PACKERS.get(name) or _VECTOR_PACKERS.get(name)
    if cls is None:
        raise ValueError(
            f"unknown packing algorithm {name!r}; "
            f"scalar options: {sorted(_PACKERS)}; "
            f"vector options: {sorted(_VECTOR_PACKERS)}"
        )
    used = kw.pop("used", None)
    if used is not None:
        # object packers take pre-filled state as bins; materialize them so
        # an engine="auto" caller below the threshold loses nothing
        if "bins" in kw:
            raise ValueError("pass pre-filled state as bins= or used=, not both")
        if name in _VECTOR_PACKERS:
            caps = _normalize_capacity(capacity)
            kw["bins"] = [
                VectorBin(caps, used=tuple(np.atleast_1d(row)))
                for row in np.asarray(used, dtype=np.float64)
            ]
        else:
            kw["bins"] = [Bin(float(capacity), used=float(u)) for u in used]
    return cls(capacity=capacity, **kw)

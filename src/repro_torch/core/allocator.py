"""Container allocator / bin-packing manager (paper Section V-B.2).

Models the scheduling problem exactly as the paper does:

  - a worker VM is a *bin* with capacity 1.0 (an active VM is an open bin,
    pre-filled with the profiled usage of the PEs it already hosts),
  - a container hosting request is an *item* with size in (0, 1] — the
    profiled CPU usage of that PE's image,
  - a packing run (at a configurable rate) maps queued requests to workers
    and determines how many workers are needed.

On top of the raw bin count, a small buffer of idle workers is kept ready to
accept stream requests; the buffer is logarithmically proportional to the
number of currently active workers (paper Section V-A), providing more
headroom for fluctuations when the workload is not as high.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Union

import numpy as np

from .binpack import (
    _EPS,
    NUMPY_BIN_THRESHOLD,
    Bin,
    Item,
    NumpyPacker,
    VectorBin,
    VectorItem,
    is_vector_policy,
    lower_bound,
    make_packer,
    vector_equivalent,
    vector_lower_bound,
)
from .queues import HostRequest
from .resources import ResourceLike, Resources, as_resources

__all__ = ["AllocatorConfig", "PackingRun", "BinPackingManager", "idle_buffer"]


def idle_buffer(active_workers: int) -> int:
    """Idle-worker headroom: ceil(log2(active + 1)) (log-proportional)."""
    return int(math.ceil(math.log2(active_workers + 1))) if active_workers > 0 else 1


@dataclasses.dataclass
class AllocatorConfig:
    # Packing algorithm for the packing run; First-Fit in the paper.  Any
    # ``make_packer`` name — scalar Any-Fit or a vector packer.  A scalar
    # name on a multi-resource cluster is auto-promoted to its vector
    # generalization (``binpack.vector_equivalent``).
    algorithm: str = "first-fit-tree"
    # Bin capacity: 1.0 == 100% of a worker's CPU.  On a multi-resource
    # cluster this may be a ``Resources`` vector (a float means every
    # dimension has that capacity).
    capacity: Union[float, Resources] = 1.0
    # Rate of packing runs, seconds (paper: "at a configurable rate").
    pack_interval: float = 2.0
    # Keep a log-proportional idle-worker buffer (paper Section V-A).
    keep_idle_buffer: bool = True
    # Optional per-run cap on consumed requests (back-pressure guard).
    max_requests_per_run: Optional[int] = None
    # Optional per-worker headroom so measurement noise does not congest a
    # worker scheduled at exactly 100% (0.0 == faithful paper behaviour).
    headroom: float = 0.0
    # Packing engine: "object" (per-bin Python packers), "numpy" (the
    # array-backed ``NumpyPacker`` — required for ndarray worker loads), or
    # "auto" (numpy once the fleet reaches ``numpy_bin_threshold`` bins or
    # the loads arrive as an ndarray).  Both engines make identical
    # placement decisions (``tests/test_packer_equivalence.py``).
    engine: str = "auto"
    numpy_bin_threshold: int = NUMPY_BIN_THRESHOLD
    # Incremental repacking (numpy engine only): keep the pre-fill matrix
    # from the previous run and refresh only *dirty* rows — workers whose
    # reported load changed since the last decision, rows beyond the old
    # fleet size, and the previous run's placement frontier.  Decisions are
    # provably equal to a full repack (the pre-fill of a bin depends only on
    # its own load); when the dirty fraction exceeds ``dirty_fallback`` the
    # whole matrix is rebuilt instead.
    incremental: bool = True
    dirty_fallback: float = 0.25


@dataclasses.dataclass
class PackingRun:
    """Result of one periodic bin-packing run.

    ``scheduled_load`` entries are floats on the scalar path and
    ``Resources`` vectors on the multi-resource path — except when the run
    was fed an ndarray of worker loads (the fleet-scale fast path), in
    which case it is the raw ``(n_bins, n_dims)`` used matrix.
    ``ideal_bins`` is the L1 lower bound (dominant-dimension L1 for
    vectors).
    """

    t: float
    placements: List[HostRequest]  # requests with ``target_worker`` attached
    num_bins: int                  # bins used by this packing solution
    target_workers: int            # num_bins + idle buffer
    ideal_bins: int                # L1 lower bound for the packed load
    scheduled_load: List[ResourceLike]  # per-bin scheduled usage after the run
    # decision-audit capture (observability plane; ``None`` unless the
    # manager's ``audit`` flag is set): policy, dims, capacity, per-bin
    # free vector *before* the run, per-item sizes/assignments/ids —
    # everything ``obs.audit`` needs to replay rejection reasons
    audit: Optional[dict] = None


class BinPackingManager:
    """Periodic First-Fit packing of queued PEs onto workers."""

    def __init__(self, config: Optional[AllocatorConfig] = None):
        self.config = config or AllocatorConfig()
        self._last_run_t: Optional[float] = None
        self.runs: List[PackingRun] = []
        # observability: capture the decision-audit snapshot per run
        # (pure reads — decisions are identical with the flag on or off)
        self.audit = False
        # incremental-repack cache (numpy engine): loads snapshot, the
        # derived pre-fill matrix min(load, cap), the capacity vector it was
        # built against, and the previous run's placement frontier
        self._inc_loads: Optional[np.ndarray] = None
        self._inc_prefill: Optional[np.ndarray] = None
        self._inc_cap: Optional[np.ndarray] = None
        self._inc_frontier: np.ndarray = np.empty(0, dtype=np.int64)
        self.full_repacks = 0        # numpy runs that rebuilt the matrix
        self.incremental_runs = 0    # numpy runs that refreshed dirty rows

    def should_run(self, t: float) -> bool:
        return (
            self._last_run_t is None
            or (t - self._last_run_t) >= self.config.pack_interval
        )

    def run(
        self,
        t: float,
        requests: Sequence[HostRequest],
        worker_loads: Sequence[ResourceLike],
    ) -> PackingRun:
        """One packing run.

        ``worker_loads[i]`` is the *scheduled* (profiled) usage of active
        worker ``i`` — the sum of size estimates of the PEs it currently
        hosts.  Active workers are open bins pre-filled to that level; queued
        requests are packed in FIFO order; bins opened beyond the active
        workers represent the scale-up the IRM will request.

        The run is *vector* when anything multi-dimensional reaches it: a
        ``Resources`` capacity, a vector packing policy, or ``Resources``
        loads/size estimates.  A scalar run is bit-for-bit the paper's
        behaviour.

        ``worker_loads`` may also be an ndarray — ``(n,)`` scalar or
        ``(n, D)`` vector — which skips every per-worker Python scan and is
        packed by the numpy engine regardless of ``config.engine`` (the
        object packers have no array path).  With ``engine="auto"`` (the
        default) list inputs switch to the numpy engine once the fleet
        reaches ``config.numpy_bin_threshold`` bins; placements are
        identical either way.
        """
        cfg = self.config
        is_arr = isinstance(worker_loads, np.ndarray)
        use_numpy = cfg.engine == "numpy" or is_arr or (
            cfg.engine == "auto"
            and len(worker_loads) >= cfg.numpy_bin_threshold
        )
        if use_numpy:
            return self._run_numpy(t, requests, worker_loads)
        if (
            isinstance(cfg.capacity, Resources)
            or is_vector_policy(cfg.algorithm)
            or any(isinstance(load, Resources) for load in worker_loads)
            or any(isinstance(r.size_estimate, Resources) for r in requests)
        ):
            return self._run_vector(t, requests, worker_loads)
        self._last_run_t = t
        cap = cfg.capacity - cfg.headroom
        bins = [Bin(cfg.capacity, used=min(load, cfg.capacity)) for load in worker_loads]
        try:
            # algorithms that support pre-filled open bins (the Any-Fit group)
            packer = make_packer(cfg.algorithm, capacity=cfg.capacity, bins=bins)
        except TypeError:
            raise ValueError(
                f"algorithm {cfg.algorithm!r} does not support pre-filled bins; "
                "use an Any-Fit algorithm for the IRM allocator"
            ) from None

        # audit snapshot before pack_one mutates the bins
        free_before = (
            [[float(cfg.capacity - b.used)] for b in bins]
            if self.audit else None
        )
        placements: List[HostRequest] = []
        audit_sizes: List[List[float]] = []
        audit_assignments: List[int] = []
        for req in requests:
            size = min(max(req.size_estimate, 1e-3), cap)
            idx = packer.pack_one(Item(size=size, tag=req.req_id))
            req.target_worker = idx
            placements.append(req)
            if self.audit:
                audit_sizes.append([float(size)])
                audit_assignments.append(int(idx))

        used_bins = sum(1 for b in packer.bins if b.used > 1e-9)
        total_load = sum(b.used for b in packer.bins)
        ideal = lower_bound([total_load], cfg.capacity) if total_load > 0 else 0
        target = used_bins + (idle_buffer(used_bins) if cfg.keep_idle_buffer else 0)

        run = PackingRun(
            t=t,
            placements=placements,
            num_bins=used_bins,
            target_workers=target,
            ideal_bins=ideal,
            scheduled_load=[b.used for b in packer.bins],
            audit=self._audit_record(
                cfg.algorithm, ("cpu",), [float(cfg.capacity)],
                free_before, audit_sizes, audit_assignments, requests,
            ) if self.audit else None,
        )
        self.runs.append(run)
        return run

    def _audit_record(
        self,
        policy: str,
        dims,
        capacity: List[float],
        free_before,
        sizes,
        assignments,
        requests: Sequence[HostRequest],
    ) -> dict:
        """The decision-audit snapshot ``obs.audit`` replays."""
        return {
            "policy": policy,
            "dims": list(dims),
            "capacity": capacity,
            "free_before": free_before,
            "sizes": sizes,
            "assignments": assignments,
            "req_ids": [r.req_id for r in requests],
            "images": [r.image for r in requests],
        }

    # -- multi-resource packing run (paper Sec. VII future work) -------------
    def _resolve_dims(
        self,
        requests: Sequence[HostRequest],
        worker_loads: Sequence[ResourceLike],
    ) -> tuple:
        """Dimension names for this run: config capacity wins, else the
        first ``Resources`` seen among loads / request estimates."""
        if isinstance(self.config.capacity, Resources):
            return self.config.capacity.dims
        for load in worker_loads:
            if isinstance(load, Resources):
                return load.dims
        for r in requests:
            if isinstance(r.size_estimate, Resources):
                return r.size_estimate.dims
        return ("cpu",)

    def _run_vector(
        self,
        t: float,
        requests: Sequence[HostRequest],
        worker_loads: Sequence[ResourceLike],
    ) -> PackingRun:
        """Vector bin-packing run: pre-filled *vector* bins, per-dimension
        headroom, dominant-dimension lower bound."""
        cfg = self.config
        self._last_run_t = t
        dims = self._resolve_dims(requests, worker_loads)
        D = len(dims)
        cap = as_resources(cfg.capacity, dims).values if isinstance(
            cfg.capacity, Resources
        ) else np.full(D, float(cfg.capacity))
        # per-dimension item ceiling: capacity minus headroom (the scalar
        # semantics — bins keep full capacity, items are clamped)
        item_hi = cap - cfg.headroom

        bins = [
            VectorBin(
                tuple(cap),
                used=np.minimum(as_resources(load, dims).values, cap),
            )
            for load in worker_loads
        ]
        algorithm = vector_equivalent(cfg.algorithm)
        packer = make_packer(algorithm, capacity=tuple(cap), bins=bins)
        # audit snapshot before pack() mutates the bins
        free_before = (
            [(cap - np.asarray(b.used)).tolist() for b in bins]
            if self.audit else None
        )

        items: List[VectorItem] = []
        for req in requests:
            size = as_resources(req.size_estimate, dims).values
            size = np.minimum(size, item_hi)
            size = np.maximum(size, 0.0)
            size[0] = max(size[0], min(1e-3, item_hi[0]))
            items.append(VectorItem(tuple(float(s) for s in size), tag=req.req_id))
        result = packer.pack(items)
        placements: List[HostRequest] = []
        for req, idx in zip(requests, result.assignments, strict=True):
            req.target_worker = idx
            placements.append(req)

        used_bins = sum(
            1 for b in packer.bins if any(u > 1e-9 for u in b.used)
        )
        ideal = vector_lower_bound([b.used for b in packer.bins], tuple(cap))
        target = used_bins + (idle_buffer(used_bins) if cfg.keep_idle_buffer else 0)

        run = PackingRun(
            t=t,
            placements=placements,
            num_bins=used_bins,
            target_workers=target,
            ideal_bins=ideal,
            scheduled_load=[Resources(dims, b.used) for b in packer.bins],
            audit=self._audit_record(
                algorithm, dims, [float(c) for c in cap], free_before,
                [list(it.sizes) for it in items],
                [int(a) for a in result.assignments], requests,
            ) if self.audit else None,
        )
        self.runs.append(run)
        return run

    # -- numpy engine: matrix pre-fill, incremental refresh, batch place -----
    def _numpy_prefill(
        self, loads_mat: np.ndarray, cap_vec: np.ndarray
    ) -> np.ndarray:
        """The ``(n, D)`` pre-fill matrix ``min(load, cap)`` for this run.

        With ``config.incremental`` the previous run's matrix is reused and
        only dirty rows are recomputed: rows whose load changed since the
        last run (exact float compare — a bitwise-equal load yields a
        bitwise-equal pre-fill, so clean rows need no work), rows beyond the
        previous fleet size, and the previous placement frontier (bins the
        last run placed requests into — redundant given the load compare,
        but kept as belt-and-suspenders for views whose loads lag their
        placements).  Because every row depends only on its own load, the
        result is always element-for-element identical to a full rebuild;
        when the dirty fraction exceeds ``config.dirty_fallback`` the full
        rebuild is cheaper and is used instead.
        """
        cfg = self.config
        n, D = loads_mat.shape
        cached = (
            cfg.incremental
            and self._inc_prefill is not None
            and self._inc_prefill.shape[1] == D
            and self._inc_cap is not None
            and np.array_equal(self._inc_cap, cap_vec)
        )
        if cached:
            prev_n = len(self._inc_loads)
            common = min(n, prev_n)
            dirty = np.zeros(n, dtype=bool)
            if common:
                dirty[:common] = (
                    loads_mat[:common] != self._inc_loads[:common]
                ).any(axis=1)
            dirty[common:] = True
            fr = self._inc_frontier
            if fr.size:
                dirty[fr[fr < n]] = True
            if n == 0 or (int(dirty.sum()) / n) <= cfg.dirty_fallback:
                if prev_n == n:
                    prefill = self._inc_prefill
                else:
                    prefill = np.empty((n, D), dtype=np.float64)
                    prefill[:common] = self._inc_prefill[:common]
                prefill[dirty] = np.minimum(loads_mat[dirty], cap_vec)
                self.incremental_runs += 1
            else:
                prefill = np.minimum(loads_mat, cap_vec)
                self.full_repacks += 1
        else:
            prefill = np.minimum(loads_mat, cap_vec)
            self.full_repacks += 1
        self._inc_loads = loads_mat.copy()
        self._inc_prefill = prefill
        self._inc_cap = cap_vec.copy()
        return prefill

    def _run_numpy(
        self,
        t: float,
        requests: Sequence[HostRequest],
        worker_loads,
    ) -> PackingRun:
        """One packing run on the numpy engine.

        Mirrors the scalar/vector object runs decision-for-decision (same
        clamps, same pre-fill, same packer semantics — pinned by
        ``tests/test_packer_equivalence.py``); the differences are
        representational: the fleet is one ``(n, D)`` matrix, and when the
        loads arrive as an ndarray the returned ``scheduled_load`` is the
        raw used matrix instead of a list of floats/``Resources`` (building
        10⁴ objects per decision would defeat the point).
        """
        cfg = self.config
        self._last_run_t = t
        is_arr = isinstance(worker_loads, np.ndarray)
        loads_D = (
            worker_loads.shape[1]
            if is_arr and worker_loads.ndim == 2
            else None
        )
        vector_mode = (
            isinstance(cfg.capacity, Resources)
            or is_vector_policy(cfg.algorithm)
            or (loads_D is not None and loads_D > 1)
            or any(isinstance(r.size_estimate, Resources) for r in requests)
        )
        if not vector_mode and not is_arr:
            vector_mode = any(
                isinstance(load, Resources) for load in worker_loads
            )

        # -- capacity vector + dimension names
        if vector_mode:
            dims = self._resolve_dims(
                requests, () if is_arr else worker_loads
            )
            if loads_D is not None and len(dims) < loads_D:
                dims = tuple(dims) + tuple(
                    f"res{i}" for i in range(len(dims), loads_D)
                )
            D = len(dims)
            cap_vec = (
                as_resources(cfg.capacity, dims).values.astype(np.float64)
                if isinstance(cfg.capacity, Resources)
                else np.full(D, float(cfg.capacity))
            )
        else:
            dims = ("cpu",)
            D = 1
            cap_vec = np.full(1, float(cfg.capacity))

        # -- worker loads as an (n, D) matrix
        if is_arr:
            loads_mat = np.asarray(worker_loads, dtype=np.float64)
            if loads_mat.ndim == 1:
                loads_mat = loads_mat[:, None]
            if loads_mat.shape[1] < D:  # scalar loads on a vector run
                padded = np.zeros((len(loads_mat), D), dtype=np.float64)
                padded[:, : loads_mat.shape[1]] = loads_mat
                loads_mat = padded
            elif loads_mat.shape[1] > D:
                raise ValueError(
                    f"worker load matrix has {loads_mat.shape[1]} dimensions "
                    f"but the run resolves to {D} ({dims})"
                )
        elif vector_mode:
            loads_mat = np.array(
                [as_resources(load, dims).values for load in worker_loads],
                dtype=np.float64,
            ).reshape(len(worker_loads), D)
        else:
            loads_mat = np.array(
                [float(load) for load in worker_loads], dtype=np.float64
            )[:, None]

        # -- item sizes, clamped exactly like the object paths
        item_hi = cap_vec - cfg.headroom
        m = len(requests)
        sizes = np.empty((m, D), dtype=np.float64)
        if vector_mode:
            for i, req in enumerate(requests):
                size = as_resources(req.size_estimate, dims).values
                size = np.minimum(size, item_hi)
                size = np.maximum(size, 0.0)
                size[0] = max(size[0], min(1e-3, item_hi[0]))
                sizes[i] = size
        else:
            hi = float(item_hi[0])
            for i, req in enumerate(requests):
                sizes[i, 0] = min(max(req.size_estimate, 1e-3), hi)

        algorithm = (
            vector_equivalent(cfg.algorithm) if vector_mode else cfg.algorithm
        )
        prefill = self._numpy_prefill(loads_mat, cap_vec)
        # audit snapshot: the packer adopts ``prefill`` as its live used
        # matrix and mutates it, so the free view must be copied now
        free_before = (
            (cap_vec - prefill).tolist() if self.audit else None
        )
        packer = NumpyPacker(
            algorithm,
            capacity=tuple(cap_vec) if vector_mode else float(cap_vec[0]),
            used=prefill,
        )
        assignments = packer.place_batch(sizes)
        self._inc_frontier = np.unique(assignments)

        placements: List[HostRequest] = []
        for req, idx in zip(requests, assignments, strict=True):
            req.target_worker = int(idx)
            placements.append(req)

        used = packer.used_matrix()
        used_bins = int((used > 1e-9).any(axis=1).sum())
        ideal = 0
        for total, c in zip(used.sum(axis=0).tolist(), cap_vec.tolist(), strict=True):
            if total > 0:
                ideal = max(ideal, max(1, int(math.ceil(total / c - _EPS))))
        target = used_bins + (
            idle_buffer(used_bins) if cfg.keep_idle_buffer else 0
        )

        if is_arr:
            scheduled: List = used.copy()  # the raw (n, D) matrix
        elif vector_mode:
            scheduled = [Resources(dims, row) for row in used]
        else:
            scheduled = [float(u) for u in used[:, 0]]

        run = PackingRun(
            t=t,
            placements=placements,
            num_bins=used_bins,
            target_workers=target,
            ideal_bins=ideal,
            scheduled_load=scheduled,
            audit=self._audit_record(
                algorithm, dims, cap_vec.tolist(), free_before,
                sizes.tolist(), [int(a) for a in assignments], requests,
            ) if self.audit else None,
        )
        self.runs.append(run)
        return run

"""Discrete-event cluster simulation — the paper's SNIC testbed in software.

The paper evaluates the IRM on a real OpenStack cloud (SNIC).  This module
reproduces that environment as a deterministic, seeded, fixed-timestep
simulation so the *same IRM code* can be evaluated quantitatively:

  - workers are VMs with ``cores`` CPU cores and a boot delay,
  - PEs are containers with a start delay, an idle self-termination timeout,
    and a measured CPU draw (target + noise) while processing a message,
  - messages queue at the master and are pulled P2P by idle PEs of the
    matching image (backlog processed with priority, i.e. FIFO),
  - worker probes report per-image mean usage to the master profiler at
    ``report_interval`` (1 s in the paper's experiments).

Everything the paper plots is recorded per tick: measured CPU per worker
(Fig. 3/4/8), scheduled-vs-measured error (Fig. 5/9), queue length, and
active/target/ideal worker counts (Fig. 10).

The simulation deliberately reproduces the paper's noise sources: the delay
between scheduling a PE and it actually drawing CPU (start transient), rapid
start/stop churn, and measurement noise.

Implementation note — the indexed hot path.  This is the throughput-tuned
rewrite of the original per-tick full-scan simulation; results are
tick-for-tick, bit-for-bit identical to it; only the data structures
changed:

  - the master queue is a set of **per-image FIFO deques** keyed by a global
    arrival sequence number, so a P2P pull is ``deque.popleft()`` instead of
    an O(queue) scan + ``list.pop(i)`` — the global-FIFO match order is
    preserved exactly because each deque stays sorted by sequence number
    (front re-inserts use decreasing negative sequence numbers);
  - PE state transitions are driven by **event indices**: a min-heap of
    STARTING PEs keyed by ready time, a min-heap of BUSY PEs keyed by
    message completion time, and a dict of IDLE PEs keyed by
    ``(worker idx, PE creation id)`` — so a tick touches only the PEs that
    change state plus the currently-idle set, not every PE on every worker;
  - ``simulate`` records into **preallocated numpy buffers** sliced once at
    the end instead of growing Python lists and stacking;
  - per-tick allocations (including a per-tick ``import math``) are hoisted
    out of the loop, and the master profiler memoizes its moving-average
    estimates between probe reports (``MasterProfiler.estimate``).
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
import math
from bisect import insort
from collections import deque
from itertools import islice
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ..obs.audit import emit_packing_audit
from .irm import IRM, IRMConfig
from .profiler import WorkerProbe
from .queues import HostRequest
from .resources import Resources
from .workloads import Message, Stream

__all__ = ["SimConfig", "SimResult", "SimCluster", "simulate",
           "worker_fits_message"]


class PEState(enum.Enum):
    STARTING = "starting"
    IDLE = "idle"
    BUSY = "busy"
    STOPPED = "stopped"


class WorkerState(enum.Enum):
    BOOTING = "booting"
    ACTIVE = "active"
    OFF = "off"


@dataclasses.dataclass
class SimConfig:
    dt: float = 0.5                 # simulation tick, seconds
    cores_per_worker: int = 8       # SSC.xlarge has 8 vCPUs
    max_workers: int = 5            # the paper restricts both frameworks to 5
    worker_boot_delay: float = 15.0
    pe_start_delay: float = 2.5     # container start latency
    container_idle_timeout: float = 1.0  # paper: 1 s in the use-case runs
    report_interval: float = 1.0    # paper: 1 s in the use-case runs
    cpu_noise_std: float = 0.02     # measurement noise (fraction of a worker)
    idle_pe_cpu_cores: float = 0.02
    t_max: float = 3600.0
    seed: int = 0
    # if True, a worker failure is injected (fault-tolerance tests)
    fail_worker_at: Optional[Tuple[int, float]] = None  # (worker idx, time)
    # Resource dimensions of a worker.  ("cpu",) is the paper's scalar model
    # (bit-for-bit unchanged).  More dimensions (dim 0 must stay "cpu")
    # switch the cluster to vector mode: messages carry per-dimension draws
    # (``Message.resources``), the profiler learns per-dimension estimates,
    # the allocator packs vector bins, and non-CPU dimensions are *rigid*
    # (a worker never overcommits them — the congestion gate below).
    resource_dims: Tuple[str, ...] = ("cpu",)


def worker_fits_message(pes, msg: "Message", dims: Tuple[str, ...],
                        t: float) -> bool:
    """Non-CPU congestion gate: can this worker take ``msg`` right now?

    CPU stays fungible (the paper lets measured CPU overcommit and clip);
    auxiliary dimensions (memory, accelerator) are rigid, so an idle PE may
    only pull a message while every non-CPU dimension stays within worker
    capacity.  A dimension's committed usage counts messages that are still
    *running* at ``t`` (``done_t > t``): both simulation implementations
    agree on that set regardless of the order they process completions in,
    which keeps the indexed and reference paths bit-for-bit identical.

    """
    mres = msg.resources
    for d in dims[1:]:
        need = mres.get(d, 0.0) if mres else 0.0
        committed = 0.0
        for pe in pes:
            pmsg = pe.msg
            if pmsg is not None and pmsg.done_t > t and pmsg.resources:
                committed += pmsg.resources.get(d, 0.0)
        if committed + need > 1.0 + 1e-9:
            return False
    return True


class SimPE:
    __slots__ = ("image", "state", "ready_t", "msg", "idle_since", "estimate",
                 "uid")

    def __init__(self, image: str, t: float, start_delay: float,
                 estimate: float, uid: int = 0):
        self.image = image
        self.state = PEState.STARTING
        self.ready_t = t + start_delay
        self.msg: Optional[Message] = None
        self.idle_since = -1.0
        self.estimate = estimate  # size estimate at placement time (scheduled)
        self.uid = uid  # creation order; (worker idx, uid) is the pass order


class SimWorker:
    __slots__ = ("idx", "state", "ready_t", "pes", "probe")

    def __init__(self, idx: int, t: float, boot_delay: float):
        self.idx = idx
        self.state = WorkerState.BOOTING if boot_delay > 0 else WorkerState.ACTIVE
        self.ready_t = t + boot_delay
        self.pes: List[SimPE] = []
        self.probe = WorkerProbe()


@dataclasses.dataclass
class SimResult:
    times: np.ndarray               # (T,)
    measured_cpu: np.ndarray        # (T, max_workers) fraction of worker
    scheduled_cpu: np.ndarray       # (T, max_workers) bin-packing view
    queue_len: np.ndarray           # (T,)
    active_workers: np.ndarray      # (T,)
    target_workers: np.ndarray      # (T,)
    ideal_bins: np.ndarray          # (T,)
    pe_count: np.ndarray            # (T,)
    completed: int
    total: int
    makespan: float                 # time when the last message finished
    messages: List[Message]
    # -- multi-resource extension (None / ("cpu",) on the scalar path) -------
    resource_dims: Tuple[str, ...] = ("cpu",)
    measured_res: Optional[np.ndarray] = None   # (T, max_workers, D)
    scheduled_res: Optional[np.ndarray] = None  # (T, max_workers, D)
    # in-flight messages returned to the queue head by worker failures
    # (``fail_worker_at``) — the at-least-once accounting both backends
    # expose so the fault-parity suite can compare them directly
    requeued: int = 0

    @property
    def error(self) -> np.ndarray:
        """Scheduled minus measured CPU, percentage points (Figs. 5/9)."""
        return (self.scheduled_cpu - self.measured_cpu) * 100.0

    def mean_busy_utilization(self) -> float:
        """Mean measured utilization over (worker, tick) cells that are on."""
        on = self.scheduled_cpu > 1e-6
        if not on.any():
            return 0.0
        return float(self.measured_cpu[on].mean())


class SimCluster:
    """ClusterView implementation backed by the simulation state.

    The master queue and the PE population are indexed (see the module
    docstring) so a tick costs O(changed PEs + idle PEs), not
    O(workers x PEs x queue).
    """

    def __init__(self, config: SimConfig, irm: IRM, bus=None):
        self.cfg = config
        self.irm = irm
        # optional observability event bus (``bus.now`` stays None on the
        # sim backend: events are stamped with the nominal tick).  Every
        # emission is a guarded list append — no RNG, no float math — so
        # the tick-for-tick trace is bit-identical with or without it.
        self.bus = bus
        self.t = 0.0
        self.rng = np.random.default_rng(config.seed)
        self.workers: List[SimWorker] = []
        self.completed: List[Message] = []
        self.requested_target = 0
        self.max_done_t = 0.0  # running max over completed messages
        self._failed: set = set()
        self.requeued = 0  # messages bounced back to the head by failures
        # ---- multi-resource mode ------------------------------------------
        self._dims = tuple(config.resource_dims)
        self._multi = len(self._dims) > 1
        if self._multi:
            if self._dims[0] != "cpu":
                raise ValueError(
                    f"resource_dims[0] must be 'cpu', got {self._dims}"
                )
            # unseen-image defaults become Resources vectors
            irm.profiler.set_resource_dims(self._dims)
        # per-dimension measured usage (n_workers, D), filled by measure()
        self.last_dim_measure: Optional[np.ndarray] = None
        # ---- master queue: per-image FIFO deques of (seq, message) --------
        # Each deque is sorted ascending by the global arrival sequence
        # number, so its head is the first message of that image in global
        # FIFO order.  Normal arrivals take increasing positive sequence
        # numbers; front re-inserts (failure requeues) take decreasing
        # negative ones — exactly ``list.insert(0, m)`` semantics.
        self._img_queues: Dict[str, Deque[Tuple[int, Message]]] = {}
        self._qlen = 0
        self._seq_back = 0
        self._seq_front = 0
        # ---- PE indices ---------------------------------------------------
        self._pe_uid = 0
        self._starting: List[Tuple[float, int, int, SimPE]] = []  # ready_t heap
        self._busy: List[Tuple[float, int, int, SimPE, Message]] = []  # done_t
        self._idle: Dict[Tuple[int, int], SimPE] = {}
        self._dirty_workers: set = set()  # workers with STOPPED PEs to compact
        # ---- worker indices (fleet-scale lifecycle) -----------------------
        # The probe/measure/recording paths and the lifecycle transitions
        # iterate these instead of scanning the whole pool, so a tick costs
        # O(active workers + transitions) rather than O(pool slots):
        #   _active_idx — ACTIVE worker indices, kept sorted ascending so
        #       every iteration order (and hence RNG draw order and float
        #       summation order) matches the reference's full scan;
        #   _boot_heap  — (ready_t, idx) min-heap of BOOTING workers with
        #       lazy invalidation (an entry is live iff the worker is still
        #       BOOTING with that exact ready_t);
        #   _off_heap   — min-heap of OFF slot indices; its top is the
        #       lowest OFF slot, mirroring the reference's first-OFF scan
        #       (a *failed* top blocks reuse and forces appends, exactly
        #       like the reference finding the failed slot first);
        #   _n_alive    — count of non-OFF workers.
        self._active_idx: List[int] = []
        self._boot_heap: List[Tuple[float, int]] = []
        self._off_heap: List[int] = []
        self._n_alive = 0

    # ---- master queue ---------------------------------------------------------
    def _push_back(self, m: Message) -> None:
        self._seq_back += 1
        dq = self._img_queues.get(m.image)
        if dq is None:
            dq = self._img_queues[m.image] = deque()
        dq.append((self._seq_back, m))
        self._qlen += 1
        if self.bus is not None:
            self.bus.emit("msg.enqueued", msg_id=m.msg_id, image=m.image,
                          arrival=m.arrival)

    def _push_front(self, m: Message) -> None:
        self._seq_front -= 1
        dq = self._img_queues.get(m.image)
        if dq is None:
            dq = self._img_queues[m.image] = deque()
        dq.appendleft((self._seq_front, m))
        self._qlen += 1

    def backlog_head(self, k: int) -> List[Message]:
        """The first ``k`` queued messages in global FIFO order."""
        if self._qlen == 0 or k <= 0:
            return []
        live = [iter(dq) for dq in self._img_queues.values() if dq]
        if len(live) == 1:
            return [m for _, m in islice(live[0], k)]
        return [m for _, m in islice(heapq.merge(*live), k)]

    @property
    def queue(self) -> List[Message]:
        """The backlog in global FIFO order (debugging / inspection only)."""
        return self.backlog_head(self._qlen)

    # ---- ClusterView protocol -------------------------------------------------
    def queue_length(self) -> float:
        return float(self._qlen)

    def queue_image_mix(self) -> Dict[str, float]:
        # Insertion order of the result must follow each image's first
        # occurrence in global FIFO order (= its deque head's sequence
        # number): the IRM's largest-remainder apportionment breaks ties by
        # this order.
        if self._qlen == 0:
            return {}
        heads = sorted(
            (dq[0][0], img, len(dq))
            for img, dq in self._img_queues.items()
            if dq
        )
        n = float(self._qlen)
        return {img: cnt / n for _, img, cnt in heads}

    def worker_scheduled_loads(self) -> List:
        # Bins are pre-filled with the *current* profiled usage of the PEs
        # they host — the paper propagates updated moving averages to all
        # scheduling state, not placement-time snapshots (Section V-B.3).
        # Estimates are looked up once per image per call; the accumulation
        # stays in PE-list order so the float sum matches the reference.
        # Only ACTIVE workers can host PEs (BOOTING pools are empty, OFF
        # slots report zero), so the PE accumulation visits the active index
        # instead of scanning the whole pool — values are identical to the
        # reference's full scan.
        est = self.irm.profiler.estimate
        cache: Dict[str, float] = {}
        stopped = PEState.STOPPED
        workers = self.workers
        if self._multi:
            # vector mode: per-dimension float64 accumulation, same order
            D = len(self._dims)
            dims = self._dims
            vout: List[Resources] = [
                Resources(dims, np.zeros(D)) for _ in range(len(workers))
            ]
            for idx in self._active_idx:
                load = np.zeros(D)
                for pe in workers[idx].pes:
                    if pe.state is stopped:
                        continue
                    img = pe.image
                    v = cache.get(img)
                    if v is None:
                        v = cache[img] = est(img).values
                    load = load + v
                vout[idx] = Resources(dims, load)
            return vout
        out = [0.0] * len(workers)
        for idx in self._active_idx:
            load = 0.0
            for pe in workers[idx].pes:
                if pe.state is stopped:
                    continue
                img = pe.image
                v = cache.get(img)
                if v is None:
                    v = cache[img] = est(img)
                load += v
            out[idx] = load
        return out

    def backlog_resource_demand(self) -> Optional[Resources]:
        """Aggregate estimated demand of the backlog head (vector mode)."""
        if not self._multi:
            return None
        est = self.irm.profiler.estimate
        total: Optional[Resources] = None
        for msg in self.backlog_head(64):
            v = est(msg.image)
            total = v if total is None else total + v
        return total

    def try_start_pe(self, req: HostRequest) -> bool:
        idx = req.target_worker
        if idx is None or idx >= len(self.workers):
            return False
        w = self.workers[idx]
        if w.state != WorkerState.ACTIVE:
            return False  # e.g. "a new VM still initializing" (paper V-B.2)
        self._pe_uid += 1
        pe = SimPE(req.image, self.t, self.cfg.pe_start_delay,
                   req.size_estimate, uid=self._pe_uid)
        w.pes.append(pe)
        heapq.heappush(self._starting, (pe.ready_t, idx, pe.uid, pe))
        if self.bus is not None:
            self.bus.emit("pe.spawn", worker=idx, pe=pe.uid,
                          image=req.image)
        return True

    def _lowest_off_slot(self) -> Optional[SimWorker]:
        """The lowest-index OFF worker (the reference's first-OFF scan).

        May return a *failed* worker: the reference's scan stops at the
        first OFF slot and, seeing it failed, appends a fresh worker — a
        failed lowest slot must block reuse here too, so it is peeked but
        never popped.
        """
        h = self._off_heap
        while h:
            w = self.workers[h[0]]
            if w.state is not WorkerState.OFF:
                heapq.heappop(h)  # stale entry (slot was reused)
                continue
            return w
        return None

    def scale_workers(self, target: int) -> None:
        self.requested_target = target
        capped = min(target, self.cfg.max_workers)
        n_alive = self._n_alive
        # boot additional workers
        while n_alive < capped:
            # reuse the lowest OFF slot if any, else append
            slot = self._lowest_off_slot()
            if slot is not None and slot.idx not in self._failed:
                heapq.heappop(self._off_heap)
                slot.state = WorkerState.BOOTING
                slot.ready_t = self.t + self.cfg.worker_boot_delay
                heapq.heappush(self._boot_heap, (slot.ready_t, slot.idx))
                if self.bus is not None:
                    self.bus.emit("worker.boot", worker=slot.idx,
                                  ready_t=slot.ready_t)
            else:
                w = SimWorker(
                    len(self.workers), self.t, self.cfg.worker_boot_delay
                )
                self.workers.append(w)
                if w.state is WorkerState.BOOTING:
                    heapq.heappush(self._boot_heap, (w.ready_t, w.idx))
                else:  # zero boot delay: born ACTIVE
                    insort(self._active_idx, w.idx)
                if self.bus is not None:
                    self.bus.emit("worker.boot", worker=w.idx,
                                  ready_t=w.ready_t)
            n_alive += 1
        # deactivate empty workers above the target (highest index first)
        if n_alive > capped:
            for idx in reversed(list(self._active_idx)):
                if n_alive <= capped:
                    break
                w = self.workers[idx]
                if not w.pes:
                    w.state = WorkerState.OFF
                    self._active_idx.remove(idx)
                    heapq.heappush(self._off_heap, idx)
                    n_alive -= 1
                    if self.bus is not None:
                        self.bus.emit("worker.deactivate", worker=idx)
        self._n_alive = n_alive

    # ---- simulation dynamics ---------------------------------------------------
    def _inject_failure(self) -> None:
        if self.cfg.fail_worker_at is None:
            return
        idx, when = self.cfg.fail_worker_at
        if self.t >= when and idx < len(self.workers) and idx not in self._failed:
            w = self.workers[idx]
            n_pes = len(w.pes)
            n_req = 0
            # in-flight messages are lost back to the master queue
            # (at-least-once); front-inserted one by one, so the last PE's
            # message ends up globally first — list.insert(0, m) semantics.
            for pe in w.pes:
                if pe.msg is not None:
                    pe.msg.start_t = -1.0
                    self._push_front(pe.msg)
                    self.requeued += 1
                    n_req += 1
                    if self.bus is not None:
                        self.bus.emit("msg.requeued", msg_id=pe.msg.msg_id,
                                      image=pe.msg.image)
                # purge from the indices: heap entries are skipped lazily
                # once the state no longer matches.
                self._idle.pop((w.idx, pe.uid), None)
                pe.state = PEState.STOPPED
                pe.msg = None
            w.pes = []
            if self.bus is not None:
                self.bus.emit("worker.kill", worker=idx, pes=n_pes,
                              requeued=n_req)
            if w.state is not WorkerState.OFF:
                if w.state is WorkerState.ACTIVE:
                    self._active_idx.remove(idx)
                # a BOOTING victim leaves a stale _boot_heap entry behind;
                # the promotion pass skips it (state no longer matches)
                self._n_alive -= 1
                heapq.heappush(self._off_heap, idx)
            w.state = WorkerState.OFF
            self._failed.add(idx)

    def tick(self, arrivals: List[Message]) -> None:
        cfg = self.cfg
        for m in arrivals:
            self._push_back(m)
        self._inject_failure()
        t = self.t

        # worker lifecycle: promote ready BOOTING workers off the min-heap
        # (the transition depends only on t, so heap order == scan order
        # up to the irrelevant promotion sequence; the sorted active index
        # preserves every downstream iteration order)
        bh_boot = self._boot_heap
        while bh_boot and bh_boot[0][0] <= t:
            rt, widx = heapq.heappop(bh_boot)
            w = self.workers[widx]
            if w.state is WorkerState.BOOTING and w.ready_t == rt:
                w.state = WorkerState.ACTIVE
                insort(self._active_idx, widx)
                if self.bus is not None:
                    self.bus.emit("worker.active", worker=widx)

        # STARTING -> IDLE.  Transition conditions depend only on t, so
        # draining the ready heap is order-equivalent to the reference
        # simulation's in-pass checks.
        sh = self._starting
        while sh and sh[0][0] <= t:
            _, widx, uid, pe = heapq.heappop(sh)
            if pe.state is PEState.STARTING:
                pe.state = PEState.IDLE
                pe.idle_since = t
                self._idle[(widx, uid)] = pe

        # BUSY -> IDLE (message completions)
        bh = self._busy
        done_now: List[Tuple[int, int, SimPE]] = []
        while bh and bh[0][0] <= t:
            _, widx, uid, pe, msg = heapq.heappop(bh)
            if pe.state is PEState.BUSY and pe.msg is msg:
                done_now.append((widx, uid, pe))
        # completed in the reference pass order: (worker idx, PE order)
        done_now.sort()
        for widx, uid, pe in done_now:
            self.completed.append(pe.msg)
            if pe.msg.done_t > self.max_done_t:
                self.max_done_t = pe.msg.done_t
            if self.bus is not None:
                dm = pe.msg
                self.bus.emit("msg.completed", msg_id=dm.msg_id,
                              image=dm.image, worker=widx, pe=uid,
                              start_t=dm.start_t, done_t=dm.done_t,
                              arrival=dm.arrival)
            pe.msg = None
            pe.state = PEState.IDLE
            pe.idle_since = t
            self._idle[(widx, uid)] = pe

        # IDLE: P2P pulls then the idle timeout, in the reference pass order.
        # A pull is deque.popleft() on this image's FIFO — the head is the
        # first matching message in *global* FIFO order by construction.
        if self._idle:
            timeout = cfg.container_idle_timeout
            img_queues = self._img_queues
            multi = self._multi
            for key in sorted(self._idle):
                pe = self._idle[key]
                dq = img_queues.get(pe.image)
                # vector mode: rigid non-CPU dimensions gate the P2P pull
                # (head-blocking FIFO: a blocked head is not skipped)
                if dq and multi and not worker_fits_message(
                    self.workers[key[0]].pes, dq[0][1], self._dims, t
                ):
                    dq = None
                if dq:
                    _, m = dq.popleft()
                    self._qlen -= 1
                    m.start_t = t
                    m.done_t = t + m.duration
                    pe.msg = m
                    pe.state = PEState.BUSY
                    del self._idle[key]
                    heapq.heappush(bh, (m.done_t, key[0], key[1], pe, m))
                    if self.bus is not None:
                        self.bus.emit("msg.pulled", msg_id=m.msg_id,
                                      image=m.image, worker=key[0],
                                      pe=key[1])
                        self.bus.emit("msg.started", msg_id=m.msg_id,
                                      image=m.image, worker=key[0],
                                      pe=key[1])
                elif t - pe.idle_since >= timeout:
                    pe.state = PEState.STOPPED  # graceful self-termination
                    del self._idle[key]
                    self._dirty_workers.add(key[0])
                    if self.bus is not None:
                        self.bus.emit("pe.exit", worker=key[0], pe=key[1],
                                      image=pe.image)

        # compact only the workers that lost a PE this tick
        if self._dirty_workers:
            for widx in self._dirty_workers:
                w = self.workers[widx]
                w.pes = [pe for pe in w.pes if pe.state is not PEState.STOPPED]
            self._dirty_workers.clear()

    def _measure_multi(self) -> np.ndarray:
        """Vector-mode measurement: per-dimension usage per worker.

        CPU (dimension 0) keeps the scalar path's noisy draw — same RNG
        sequence — while auxiliary dimensions are measured exactly (memory
        and accelerator reservations are deterministic).  Fills
        ``last_dim_measure`` (n_workers, D) and returns the CPU column.
        """
        cfg = self.cfg
        dims = self._dims
        D = len(dims)
        cores_per_worker = float(cfg.cores_per_worker)
        noise_std = cfg.cpu_noise_std * cfg.cores_per_worker
        idle_draw = min(max(cfg.idle_pe_cpu_cores, 0.0), cores_per_worker)
        rng_normal = self.rng.normal
        busy, idle = PEState.BUSY, PEState.IDLE
        n = max(len(self.workers), 1)
        out = np.zeros(n)
        dim_out = np.zeros((n, D))
        # ascending active indices == the reference's full scan filtered to
        # ACTIVE workers: same RNG draw order, same probe accumulation order
        for idx in self._active_idx:
            w = self.workers[idx]
            totals = np.zeros(D)
            acc, counts = w.probe.accumulators()
            for pe in w.pes:
                vec = np.zeros(D)
                if pe.state is busy and pe.msg is not None:
                    draw = pe.msg.cpu_cores * float(rng_normal(1.0, noise_std))
                    if draw < 0.0:
                        draw = 0.0
                    elif draw > cores_per_worker:
                        draw = cores_per_worker
                    vec[0] = draw / cores_per_worker
                    mres = pe.msg.resources
                    if mres:
                        for j in range(1, D):
                            vec[j] = mres.get(dims[j], 0.0)
                elif pe.state is idle:
                    vec[0] = idle_draw / cores_per_worker
                totals = totals + vec
                img = pe.image
                if img in acc:
                    acc[img] = acc[img] + vec
                    counts[img] += 1
                else:
                    acc[img] = vec
                    counts[img] = 1
            clipped = np.minimum(totals, 1.0)
            dim_out[w.idx] = clipped
            out[w.idx] = clipped[0]
        self.last_dim_measure = dim_out
        return out

    def measure(self) -> np.ndarray:
        """Instantaneous measured CPU per worker (fraction of the worker)."""
        if self._multi:
            return self._measure_multi()
        cfg = self.cfg
        cores_per_worker = float(cfg.cores_per_worker)
        noise_std = cfg.cpu_noise_std * cfg.cores_per_worker
        # idle draw pre-clipped to [0, cores_per_worker] once per call
        idle_draw = min(max(cfg.idle_pe_cpu_cores, 0.0), cores_per_worker)
        rng_normal = self.rng.normal
        busy, idle = PEState.BUSY, PEState.IDLE
        out = np.zeros(max(len(self.workers), 1))
        # ascending active indices == the reference's full scan filtered to
        # ACTIVE workers: same RNG draw order, same probe accumulation order
        for idx in self._active_idx:
            w = self.workers[idx]
            cores = 0.0
            # accumulate straight into the probe's per-image running means
            # (same order and float addition as WorkerProbe.sample)
            acc, counts = w.probe.accumulators()
            for pe in w.pes:
                if pe.state is busy and pe.msg is not None:
                    draw = pe.msg.cpu_cores * float(rng_normal(1.0, noise_std))
                    # clip to [0, cores_per_worker] (bit-equal to np.clip)
                    if draw < 0.0:
                        draw = 0.0
                    elif draw > cores_per_worker:
                        draw = cores_per_worker
                elif pe.state is idle:
                    draw = idle_draw
                else:  # STARTING draws ~nothing: the paper's transient error
                    draw = 0.0
                cores += draw
                img = pe.image
                if img in acc:
                    acc[img] += draw / cores_per_worker
                    counts[img] += 1
                else:
                    acc[img] = draw / cores_per_worker
                    counts[img] = 1
            u = cores / cores_per_worker
            out[w.idx] = u if u < 1.0 else 1.0
        return out

    def flush_probes(self) -> None:
        dims = self._dims if self._multi else None
        for idx in self._active_idx:
            w = self.workers[idx]
            if w.pes:
                report = w.probe.report()
                if report:
                    if dims is not None:
                        # vector mode accumulates ndarrays; name them
                        report = {
                            img: Resources(dims, vec)
                            for img, vec in report.items()
                        }
                    self.irm.ingest_report(report)


def simulate(
    stream: Stream,
    config: Optional[SimConfig] = None,
    irm: Optional[IRM] = None,
    irm_config: Optional[IRMConfig] = None,
    bus=None,
) -> SimResult:
    """Run the IRM against a workload stream; returns recorded time series.

    Passing an existing ``irm`` keeps its profiler state across runs — the
    paper's 10-run experiment where "HIO was started fresh for the first run
    and remained running for all subsequent runs".

    ``bus``, when given, receives the observability event stream (message
    spans, worker/PE lifecycle, IRM decision audit) with the same schema
    as the live backends; events are stamped in nominal tick time.  The
    frozen reference simulation has no such hook, and the equivalence
    suite runs with ``bus=None``, so the bit-for-bit contract is intact.
    """
    cfg = config or SimConfig()
    if irm is None:
        irm = IRM(irm_config or IRMConfig())
    else:
        irm.begin_run()
    cluster = SimCluster(cfg, irm, bus=bus)
    if bus is not None:
        irm.packing_manager.audit = bus.audit

    batches = sorted(stream.batches, key=lambda b: b[0])
    n_batches = len(batches)
    next_batch = 0
    total = stream.num_messages

    # preallocated recording buffers, sliced to the tick count at the end
    cap = int(cfg.t_max / cfg.dt) + 2
    times = np.empty(cap, np.float64)
    measured = np.zeros((cap, cfg.max_workers), np.float64)
    scheduled = np.zeros((cap, cfg.max_workers), np.float64)
    qlen = np.empty(cap, np.int64)
    active = np.empty(cap, np.int64)
    target = np.empty(cap, np.int64)
    ideal = np.empty(cap, np.int64)
    pe_count = np.empty(cap, np.int64)
    dims = cluster._dims
    multi = cluster._multi
    D = len(dims)
    measured_res = np.zeros((cap, cfg.max_workers, D)) if multi else None
    scheduled_res = np.zeros((cap, cfg.max_workers, D)) if multi else None

    W = cfg.max_workers
    workers = cluster.workers
    estimate = irm.profiler.estimate
    last_report_t = -1e9
    n = 0

    t = 0.0
    while t <= cfg.t_max:
        cluster.t = t
        if bus is not None:
            bus.tick = t
        arrivals: List[Message] = []
        while next_batch < n_batches and batches[next_batch][0] <= t:
            arrivals.extend(batches[next_batch][1])
            next_batch += 1

        cluster.tick(arrivals)
        m = cluster.measure()
        if t - last_report_t >= cfg.report_interval:
            cluster.flush_probes()
            last_report_t = t
        step_metrics = irm.step(t, cluster)
        if bus is not None:
            emit_packing_audit(bus, irm.config.allocator.algorithm,
                               step_metrics.packing)

        if n >= cap:  # t_max/dt bounds the tick count; guard regardless
            times = np.concatenate([times, np.empty(cap, np.float64)])
            measured = np.vstack([measured, np.zeros((cap, W), np.float64)])
            scheduled = np.vstack([scheduled, np.zeros((cap, W), np.float64)])
            qlen = np.concatenate([qlen, np.empty(cap, np.int64)])
            active = np.concatenate([active, np.empty(cap, np.int64)])
            target = np.concatenate([target, np.empty(cap, np.int64)])
            ideal = np.concatenate([ideal, np.empty(cap, np.int64)])
            pe_count = np.concatenate([pe_count, np.empty(cap, np.int64)])
            if multi:
                measured_res = np.concatenate(
                    [measured_res, np.zeros((cap, W, D))])
                scheduled_res = np.concatenate(
                    [scheduled_res, np.zeros((cap, W, D))])
            cap *= 2

        times[n] = t
        k = min(len(m), W)
        measured[n, :k] = m[:k]
        sl = cluster.worker_scheduled_loads()
        srow = scheduled[n]
        if multi:
            dm = cluster.last_dim_measure
            measured_res[n, :k] = dm[:k]
            for j in range(min(len(sl), W)):
                v = sl[j].values
                c = v[0]
                srow[j] = c if c < 1.0 else 1.0
                scheduled_res[n, j] = np.minimum(v, 1.0)
        else:
            for j in range(min(len(sl), W)):
                v = sl[j]
                srow[j] = v if v < 1.0 else 1.0

        qlen[n] = cluster._qlen
        # PEs only live on ACTIVE workers (BOOTING pools are empty; OFF
        # transitions clear or forbid PEs), so counting over the sorted
        # active index reproduces the reference's full-pool scan, including
        # the float order of the busy-load accumulation.
        if multi:
            n_active = len(cluster._active_idx)
            n_pes = 0
            busy_vec = np.zeros(D)
            for widx in cluster._active_idx:
                pes = workers[widx].pes
                n_pes += len(pes)
                for pe in pes:
                    busy_vec = busy_vec + pe.estimate.values
            active[n] = n_active
            target[n] = cluster.requested_target
            pe_count[n] = n_pes
            # ideal bins: dominant-dimension bound on the in-system load
            backlog_vec = np.zeros(D)
            for msg in cluster.backlog_head(64):
                backlog_vec = backlog_vec + estimate(msg.image).values
            ideal[n] = int(max(
                math.ceil(busy_vec[j] + (backlog_vec[j]
                                         if backlog_vec[j] < 64.0 else 64.0))
                for j in range(D)
            ))
            n += 1
        else:
            n_active = len(cluster._active_idx)
            n_pes = 0
            busy_load = 0.0
            for widx in cluster._active_idx:
                pes = workers[widx].pes
                n_pes += len(pes)
                for pe in pes:
                    busy_load += pe.estimate
            active[n] = n_active
            target[n] = cluster.requested_target
            pe_count[n] = n_pes
            # ideal bins for the *current* in-system load (backlog + busy PEs)
            backlog_load = 0.0
            for msg in cluster.backlog_head(64):
                backlog_load += estimate(msg.image)
            ideal[n] = int(math.ceil(
                busy_load + (backlog_load if backlog_load < 64.0 else 64.0)
            ))
            n += 1

        done = len(cluster.completed)
        if done >= total and next_batch >= n_batches and cluster._qlen == 0:
            break
        t = round(t + cfg.dt, 9)

    return SimResult(
        times=times[:n].copy(),
        measured_cpu=measured[:n].copy(),
        scheduled_cpu=scheduled[:n].copy(),
        queue_len=qlen[:n].copy(),
        active_workers=active[:n].copy(),
        target_workers=target[:n].copy(),
        ideal_bins=ideal[:n].copy(),
        pe_count=pe_count[:n].copy(),
        completed=len(cluster.completed),
        total=total,
        makespan=cluster.max_done_t,
        messages=[m for _, b in stream.batches for m in b],
        resource_dims=dims,
        measured_res=measured_res[:n].copy() if multi else None,
        scheduled_res=scheduled_res[:n].copy() if multi else None,
        requeued=cluster.requeued,
    )

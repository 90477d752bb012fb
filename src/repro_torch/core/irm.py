"""Intelligent Resource Manager (paper Section V).

Wires the four IRM components — container queue, container allocator
(bin-packing manager + allocation queue), worker profiler, and load
predictor — into the control loop the paper describes:

  1. the load predictor reads queue pressure and queues PE scale-up requests;
  2. waiting requests are refreshed with updated profile averages;
  3. the bin-packing manager periodically packs queued requests onto workers
     (pre-filled bins), emitting placements and a target worker count;
  4. the allocation queue executes placements; failures are TTL-requeued;
  5. idle PEs self-terminate (owned by the cluster), and workers above the
     target with no PEs are deactivated.

The IRM is cluster-agnostic: it talks to a ``ClusterView`` protocol with
two implementations here — the discrete-event simulation (``core/sim.py`` —
the faithful reproduction of the paper's testbed) and the live asyncio
master/worker runtime (``runtime/live.py`` — real concurrent execution in
scaled wall-clock time).  ``backlog_resource_demand`` is optional: the IRM
probes for it with ``getattr`` and falls back to the paper's
message-count-only pressure when a view omits it or returns ``None``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol

from .allocator import AllocatorConfig, BinPackingManager, PackingRun
from .load_predictor import LoadPredictor, LoadPredictorConfig, ScaleDecision
from .profiler import MasterProfiler, ProfilerConfig
from .queues import AllocationQueue, ContainerQueue, HostRequest
from .resources import ResourceLike, Resources

__all__ = ["IRMConfig", "IRM", "ClusterView", "IRMMetrics"]


class ClusterView(Protocol):
    """What the IRM needs to observe/actuate on the managed cluster."""

    def queue_length(self) -> float:
        """Length of the stream message queue (backlog at the master)."""
        ...

    def queue_image_mix(self) -> Dict[str, float]:
        """Fraction of backlog per workload class (container image)."""
        ...

    def worker_scheduled_loads(self) -> List[ResourceLike]:
        """Per active worker: sum of size estimates of its scheduled PEs.

        Floats on a scalar (CPU-only) cluster, ``Resources`` vectors on a
        multi-resource cluster — the allocator handles both.
        """
        ...

    def backlog_resource_demand(self) -> Optional[Resources]:
        """Aggregate resource demand of the backlog head, or ``None``.

        ``None`` means "scalar cluster / no demand signal" and keeps the
        load predictor on the paper's message-count-only math.  Optional:
        the IRM tolerates views that don't implement it.
        """
        ...

    def try_start_pe(self, req: HostRequest) -> bool:
        """Attempt to start a PE per the placement; False on failure."""
        ...

    def scale_workers(self, target: int) -> None:
        """Request the active worker pool be scaled to ``target``."""
        ...


@dataclasses.dataclass
class IRMConfig:
    profiler: ProfilerConfig = dataclasses.field(default_factory=ProfilerConfig)
    predictor: LoadPredictorConfig = dataclasses.field(
        default_factory=LoadPredictorConfig
    )
    allocator: AllocatorConfig = dataclasses.field(default_factory=AllocatorConfig)
    # TTL given to fresh auto-scaling host requests.  A placement retry
    # happens once per packing run, so the TTL should cover the worker boot
    # delay divided by the packing interval (paper default is small; failed
    # requests are regenerated by the load predictor while pressure remains).
    request_ttl: int = 5
    # Upper bound on PEs requested per predictor decision per image class.
    max_pes_per_decision: int = 8


@dataclasses.dataclass
class IRMMetrics:
    """Per-step record used by the benchmarks (paper Figs. 4/5/8/9/10)."""

    t: float
    queue_len: float
    decision: ScaleDecision
    packing: Optional[PackingRun]
    started: int
    container_queue_len: int
    allocation_queue_len: int


class IRM:
    """The paper's IRM control loop, one ``step`` per tick."""

    def __init__(self, config: Optional[IRMConfig] = None):
        self.config = config or IRMConfig()
        self.profiler = MasterProfiler(self.config.profiler)
        self.predictor = LoadPredictor(self.config.predictor)
        self.packing_manager = BinPackingManager(self.config.allocator)
        self.container_queue = ContainerQueue()
        self.allocation_queue = AllocationQueue()
        self.metrics: List[IRMMetrics] = []
        self.last_target_workers: int = 0

    # -- user API ------------------------------------------------------------
    def begin_run(self) -> None:
        """Reset wall-clock-relative state for a new experiment run.

        The profiler (the learned workload profile) is intentionally kept —
        the paper's 10-run experiment relies on profile persistence across
        runs ("HIO was started fresh for the first run and remained running
        for all subsequent runs").
        """
        self.predictor.reset()
        self.packing_manager._last_run_t = None
        self.container_queue = ContainerQueue()
        self.allocation_queue = AllocationQueue()

    def submit(self, req: HostRequest) -> bool:
        """Manual hosting request from a user (paper V-B.1)."""
        req.source = "user"
        return self.container_queue.push(req)

    def ingest_report(self, report: Dict[str, float]) -> None:
        """Worker probe report (per-image mean usage) -> master profiler."""
        self.profiler.observe_report(report)

    # -- control loop ---------------------------------------------------------
    def step(self, t: float, view: ClusterView) -> IRMMetrics:
        cfg = self.config

        # (1) load prediction: queue pressure -> PE scale-up requests.  On a
        # multi-resource cluster the backlog's aggregate demand scales the
        # pressure on its bottleneck dimension (optional view method, passed
        # as a callable so the backlog scan only runs on non-gated ticks).
        qlen = view.queue_length()
        demand_fn = getattr(view, "backlog_resource_demand", None)
        decision = self.predictor.update(t, qlen, demand=demand_fn)
        if decision.num_pes > 0:
            self._queue_scaleup(t, decision.num_pes, view.queue_image_mix())

        # (2) propagate refreshed profile estimates to waiting requests.
        self.container_queue.refresh_estimates(self.profiler)
        self.allocation_queue.refresh_estimates(self.profiler)

        # (3) periodic bin-packing run.
        packing: Optional[PackingRun] = None
        if self.packing_manager.should_run(t):
            requests = self.container_queue.drain(
                cfg.allocator.max_requests_per_run
            )
            packing = self.packing_manager.run(
                t, requests, view.worker_scheduled_loads()
            )
            for req in packing.placements:
                self.allocation_queue.push(req)
            self.last_target_workers = packing.target_workers
            view.scale_workers(packing.target_workers)

        # (4) execute placements; failures are TTL-requeued.
        started = self.allocation_queue.consume(
            try_start=view.try_start_pe,
            on_fail=self.container_queue.requeue,
        )

        m = IRMMetrics(
            t=t,
            queue_len=qlen,
            decision=decision,
            packing=packing,
            started=started,
            container_queue_len=len(self.container_queue),
            allocation_queue_len=len(self.allocation_queue),
        )
        self.metrics.append(m)
        return m

    # -- internals -------------------------------------------------------------
    def _queue_scaleup(
        self, t: float, num_pes: int, image_mix: Dict[str, float]
    ) -> None:
        """Split a scale-up decision across the backlog's workload classes."""
        if not image_mix:
            return
        total = sum(image_mix.values())
        if total <= 0:
            return
        # Largest-remainder apportionment of num_pes across images.
        shares = {
            img: num_pes * frac / total for img, frac in image_mix.items()
        }
        alloc = {img: int(s) for img, s in shares.items()}
        remainder = num_pes - sum(alloc.values())
        for img, _ in sorted(
            shares.items(), key=lambda kv: kv[1] - int(kv[1]), reverse=True
        )[:remainder]:
            alloc[img] += 1
        for img, n in alloc.items():
            n = min(n, self.config.max_pes_per_decision)
            for _ in range(n):
                self.container_queue.push(
                    HostRequest(
                        image=img,
                        size_estimate=self.profiler.estimate(img),
                        ttl=self.config.request_ttl,
                        enqueue_time=t,
                        source="autoscale",
                    )
                )

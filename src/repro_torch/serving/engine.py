"""Continuous-batching serving engine managed by the paper's IRM.

The HarmonicIO mapping, one-to-one:

  stream message   -> inference request (prompt + max_new_tokens)
  PE container     -> an admitted request occupying a decode slot + KV pages
  worker VM (bin)  -> a serving replica with capacity 1.0
                      (vector capacity: decode slots x KV pages)
  worker profiler  -> per-request-class cost profile (moving average of
                      measured slot-seconds and page usage)
  load predictor   -> request-queue length + ROC -> replica scale-up
  container queue  -> admission queue with TTL requeue on failed placement
  bin-packing run  -> First-Fit admission of queued requests onto replicas

The control plane runs against ``SimulatedBackend``, a discrete-time
replica pool (deterministic, thousands of requests).  A real model's
prefill and paged decode on the card is ``launch/serve.py --backend
local``.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.load_predictor import LoadPredictor, LoadPredictorConfig
from ..core.profiler import MasterProfiler, ProfilerConfig
from ..core.queues import ContainerQueue
from .kv_cache import PageAllocator, PagedCacheLayout

__all__ = [
    "Request",
    "ReplicaConfig",
    "EngineConfig",
    "ServingEngine",
    "SimulatedBackend",
    "ServingClusterView",
]

_req_counter = itertools.count()


@dataclasses.dataclass
class Request:
    prompt_len: int
    max_new_tokens: int
    arrival: float = 0.0
    req_class: str = "default"
    req_id: int = dataclasses.field(default_factory=lambda: next(_req_counter))
    # filled during execution
    generated: int = 0
    replica: Optional[int] = None
    start_t: float = -1.0
    done_t: float = -1.0

    @property
    def total_tokens(self) -> int:
        return self.prompt_len + self.max_new_tokens


@dataclasses.dataclass(frozen=True)
class ReplicaConfig:
    max_slots: int = 16            # concurrent decode slots
    kv_pages: int = 2048           # page pool size
    page_size: int = 16            # tokens/page
    prefill_tokens_per_s: float = 50_000.0
    decode_tokens_per_s: float = 2_000.0   # per slot-step round
    spinup_delay: float = 10.0     # compile + weight load


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    replica: ReplicaConfig = dataclasses.field(default_factory=ReplicaConfig)
    max_replicas: int = 8
    dt: float = 0.1
    request_ttl: int = 5
    predictor: LoadPredictorConfig = dataclasses.field(
        default_factory=lambda: LoadPredictorConfig(
            queue_low=4, queue_high=32, roc_low=2.0, roc_high=16.0,
            small_increase=1, large_increase=2, cooldown=5.0,
        )
    )
    profiler: ProfilerConfig = dataclasses.field(
        default_factory=lambda: ProfilerConfig(window=64, default_size=0.25)
    )
    # admission packing heuristic over (slots, pages) vector bins
    packing_heuristic: str = "first"


class _SimReplica:
    """Discrete-time model of one serving replica."""

    def __init__(self, idx: int, cfg: ReplicaConfig, t: float, booted: bool = False):
        self.idx = idx
        self.cfg = cfg
        self.ready_t = t if booted else t + cfg.spinup_delay
        self.active: List[Request] = []
        self.prefilling: List[Tuple[Request, float]] = []
        self.allocator = PageAllocator(
            PagedCacheLayout(
                num_pages=cfg.kv_pages,
                page_size=cfg.page_size,
                n_kv_heads=1,
                head_dim=1,
                max_pages_per_seq=cfg.kv_pages,
            )
        )
        self.retired = False

    def ready(self, t: float) -> bool:
        return t >= self.ready_t and not self.retired

    def load_fraction(self) -> Tuple[float, float]:
        """(slot fraction, page fraction) — the vector bin occupancy."""
        slots = (len(self.active) + len(self.prefilling)) / self.cfg.max_slots
        pages = self.allocator.used_pages / self.cfg.kv_pages
        return slots, pages

    def try_admit(self, req: Request, t: float) -> bool:
        if not self.ready(t):
            return False
        if len(self.active) + len(self.prefilling) >= self.cfg.max_slots:
            return False
        pages = self.allocator.allocate(req.req_id, req.prompt_len)
        if pages is None:
            return False
        req.replica = self.idx
        req.start_t = t
        prefill_time = req.prompt_len / self.cfg.prefill_tokens_per_s
        self.prefilling.append((req, t + prefill_time))
        return True

    def step(self, t: float, dt: float) -> List[Request]:
        """Advance one tick; returns completed requests."""
        done: List[Request] = []
        still = []
        for req, ready_at in self.prefilling:
            if t >= ready_at:
                self.active.append(req)
            else:
                still.append((req, ready_at))
        self.prefilling = still
        if not self.active:
            return done
        # decode round: each active slot generates tokens at the shared rate
        per_slot = self.cfg.decode_tokens_per_s * dt / max(1, len(self.active))
        per_slot = max(per_slot, 0.0)
        finished: List[Request] = []
        for req in self.active:
            req.generated += per_slot
            if self.allocator.extend(req.req_id, int(np.ceil(per_slot))) is None:
                finished.append(req)  # pool exhausted -> finish (simplified)
                continue
            if req.generated >= req.max_new_tokens:
                finished.append(req)
        for req in finished:
            req.done_t = t
            self.active.remove(req)
            self.allocator.free(req.req_id)
            done.append(req)
        return done


class SimulatedBackend:
    """Replica pool with discrete-time execution (benchmark backend)."""

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        self.replicas: List[_SimReplica] = [
            _SimReplica(0, cfg.replica, 0.0, booted=True)
        ]

    def scale_to(self, target: int, t: float) -> None:
        target = min(target, self.cfg.max_replicas)
        alive = [r for r in self.replicas if not r.retired]
        while len(alive) < target:
            r = _SimReplica(len(self.replicas), self.cfg.replica, t)
            self.replicas.append(r)
            alive.append(r)
        # retire idle replicas above target (highest index first)
        for r in reversed(alive):
            if len(alive) <= target:
                break
            if not r.active and not r.prefilling and r.idx != 0:
                r.retired = True
                alive.remove(r)

    def step(self, t: float, dt: float) -> List[Request]:
        out: List[Request] = []
        for r in self.replicas:
            if not r.retired:
                out.extend(r.step(t, dt))
        return out


class ServingEngine:
    """IRM-scheduled continuous batching over a replica backend."""

    def __init__(self, cfg: EngineConfig, backend: Optional[SimulatedBackend] = None):
        self.cfg = cfg
        self.backend = backend or SimulatedBackend(cfg)
        self.queue: deque = deque()
        self.admission = ContainerQueue()
        self.profiler = MasterProfiler(cfg.profiler)
        self.predictor = LoadPredictor(cfg.predictor)
        self.completed: List[Request] = []
        self.t = 0.0
        self.metrics: List[Dict[str, float]] = []
        self._target = 1

    # ---- request intake --------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.arrival = self.t
        self.queue.append(req)

    # ---- cost model (profiled item size) ------------------------------------------
    def _size_estimate(self, req: Request) -> Tuple[float, float]:
        """(slot share, page share) — vector item for admission packing."""
        rc = self.cfg.replica
        slot = 1.0 / rc.max_slots
        pages = min(1.0, req.total_tokens / (rc.kv_pages * rc.page_size))
        # profile-corrected: learned mean page usage per class
        learned = self.profiler.estimate(req.req_class)
        if self.profiler.num_observations(req.req_class) > 0:
            pages = learned
        return slot, pages

    # ---- main loop --------------------------------------------------------------
    def step(self) -> None:
        cfg = self.cfg
        t = self.t

        # (1) load prediction on the request queue
        decision = self.predictor.update(t, float(len(self.queue)))
        if decision.num_pes > 0:
            self._target = min(cfg.max_replicas, self._target + decision.num_pes)
        elif not self.queue and all(
            not r.active and not r.prefilling
            for r in self.backend.replicas
            if not r.retired
        ):
            self._target = 1
        self.backend.scale_to(self._target, t)

        # (2) First-Fit admission over (slots, pages) vector bins
        admitted = True
        while self.queue and admitted:
            admitted = False
            req = self.queue[0]
            for r in self.backend.replicas:
                if r.retired:
                    continue
                if r.try_admit(req, t):
                    self.queue.popleft()
                    admitted = True
                    break

        # (3) advance execution
        done = self.backend.step(t, cfg.dt)
        for req in done:
            self.completed.append(req)
            rc = cfg.replica
            self.profiler.observe(
                req.req_class,
                min(1.0, req.total_tokens / (rc.kv_pages * rc.page_size)),
            )

        # (4) metrics
        alive = [r for r in self.backend.replicas if not r.retired]
        slot_loads = [r.load_fraction()[0] for r in alive]
        page_loads = [r.load_fraction()[1] for r in alive]
        self.metrics.append(
            {
                "t": t,
                "queue": len(self.queue),
                "replicas": len(alive),
                "target": self._target,
                "mean_slot_load": float(np.mean(slot_loads)) if slot_loads else 0.0,
                "mean_page_load": float(np.mean(page_loads)) if page_loads else 0.0,
                "completed": len(self.completed),
            }
        )
        self.t = round(t + cfg.dt, 9)

    def run_until_drained(self, t_max: float = 3600.0) -> None:
        while self.t < t_max:
            self.step()
            if (
                not self.queue
                and all(
                    not r.active and not r.prefilling
                    for r in self.backend.replicas
                    if not r.retired
                )
            ):
                break

    # ---- ClusterView adapter ---------------------------------------------------
    def cluster_view(self) -> "ServingClusterView":
        """A ``core.irm.ClusterView`` over this engine (see the class)."""
        return ServingClusterView(self)

    # ---- summary -----------------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        if not self.completed:
            return {"completed": 0}
        lat = [r.done_t - r.arrival for r in self.completed]
        return {
            "completed": len(self.completed),
            "makespan": max(r.done_t for r in self.completed),
            "p50_latency": float(np.percentile(lat, 50)),
            "p99_latency": float(np.percentile(lat, 99)),
            "peak_replicas": max(m["replicas"] for m in self.metrics),
        }


class ServingClusterView:
    """``core.irm.ClusterView`` adapter over a ``ServingEngine``.

    The engine drives the IRM components directly in its own ``step`` (the
    admission loop predates the protocol), but exposing the standard view
    closes the protocol gap so backend-generic tooling — the conformance
    suite, ad-hoc ``IRM.step`` experiments — can observe and actuate a
    serving cluster exactly like the sim and live backends:

      worker/bin  -> a live (non-retired) replica; its scheduled load is
                     the (slots, pages) occupancy as a ``Resources`` vector
                     with dims ``("cpu", "pages")`` (decode slots are the
                     compute dimension, so they map onto dim 0)
      PE/item     -> an admitted request
      try_start_pe-> admit the oldest queued request of the placed class
                     onto the target replica
      scale       -> clamp and apply the engine's replica target
    """

    DIMS = ("cpu", "pages")

    def __init__(self, engine: ServingEngine):
        self.engine = engine

    def queue_length(self) -> float:
        return float(len(self.engine.queue))

    def queue_image_mix(self) -> Dict[str, float]:
        if not self.engine.queue:
            return {}
        counts: Dict[str, int] = {}
        for req in self.engine.queue:
            counts[req.req_class] = counts.get(req.req_class, 0) + 1
        n = float(len(self.engine.queue))
        return {cls: c / n for cls, c in counts.items()}

    def worker_scheduled_loads(self) -> List["Resources"]:
        from ..core.resources import Resources

        out = []
        for r in self.engine.backend.replicas:
            if r.retired:
                out.append(Resources(self.DIMS, (0.0, 0.0)))
            else:
                out.append(Resources(self.DIMS, r.load_fraction()))
        return out

    def backlog_resource_demand(self):
        from ..core.resources import Resources

        total = None
        for req in list(self.engine.queue)[:64]:
            slot, pages = self.engine._size_estimate(req)
            v = Resources(self.DIMS, (slot, pages))
            total = v if total is None else total + v
        return total

    def try_start_pe(self, req) -> bool:
        idx = req.target_worker
        replicas = self.engine.backend.replicas
        if idx is None or idx >= len(replicas) or replicas[idx].retired:
            return False
        for queued in self.engine.queue:
            if queued.req_class == req.image:
                if replicas[idx].try_admit(queued, self.engine.t):
                    self.engine.queue.remove(queued)
                    return True
                return False
        return False

    def scale_workers(self, target: int) -> None:
        self.engine._target = max(1, min(target, self.engine.cfg.max_replicas))
        self.engine.backend.scale_to(self.engine._target, self.engine.t)

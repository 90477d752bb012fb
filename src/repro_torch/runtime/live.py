"""The live streaming backend: asyncio master/worker cluster for the IRM.

``run_live(stream, config)`` is the live counterpart of ``core.sim.simulate``
— same signature shape, same ``SimResult`` output — but instead of a
discrete-event model it runs a *real* concurrent system on the asyncio
event loop:

  - a ``Master`` broker holds the backlog in per-image FIFO queues and
    hands messages P2P to idle PEs;
  - a ``WorkerPool`` hosts PEs as asyncio tasks executing a pluggable
    payload (calibrated sleep, or a Hopper kernel per message);
  - a ``Lifecycle`` actuator boots/retires workers on the IRM's packing
    decisions, with the configured boot/start delays;
  - a control-loop task steps the *unmodified* ``IRM`` once per ``dt``
    against a ``LiveCluster`` view and records a ``SimResult``-compatible
    trace (``TraceRecorder``), and injects ``SimConfig.fail_worker_at``
    worker failures at their nominal tick exactly like the simulator
    (``Lifecycle.kill_worker``: PE tasks cancelled, in-flight messages
    requeued at the queue head, at-least-once).

Time: everything is expressed in scenario seconds; ``RuntimeConfig.
time_scale`` sets how many wall seconds one scenario second costs (see
``clock.ScaledClock``).  Ticks are stamped at their *nominal* times
``n * dt`` so IRM read-interval/cooldown gating matches the simulator;
message start/done times read the real (scaled) clock, which is where the
live backend's genuine concurrency jitter enters the record.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from ..core.irm import IRM, IRMConfig
from ..core.queues import HostRequest
from ..core.resources import Resources
from ..core.sim import SimConfig, SimResult, WorkerState
from ..core.workloads import Stream
from ..obs.audit import emit_packing_audit
from .clock import ScaledClock
from .lifecycle import Lifecycle
from .master import Master
from .payloads import make_payload
from .trace import TraceRecorder, measure_workers
from .transport import make_transport
from .worker import WorkerPool

__all__ = ["RuntimeConfig", "LiveCluster", "run_live"]


@dataclasses.dataclass
class RuntimeConfig:
    """Knobs specific to the live backend (cluster shape stays in SimConfig)."""

    # wall seconds per scenario second (0.02 → a 60 s scenario runs in 1.2 s)
    time_scale: float = 0.02
    # payload executed per message: "sleep" (calibrated) or "torch" (kernel)
    payload: str = "sleep"
    payload_kwargs: Dict[str, object] = dataclasses.field(default_factory=dict)
    # where workers physically run: "inproc" (asyncio tasks on the master's
    # loop — zero-copy, the original backend) or "multiproc" (each worker a
    # real OS process with command/data queues; messages cross a pickle
    # boundary and per-worker CPU is *measured*, not emulated)
    transport: str = "inproc"
    transport_kwargs: Dict[str, object] = dataclasses.field(
        default_factory=dict
    )
    # what the profiler learns from on a multiproc transport: "emulated"
    # keeps the simulator's CPU-draw model (so packing decisions stay on
    # the sim's scale — the parity suites' contract) while real OS numbers
    # are still collected for the drift ledger; "os" feeds the real
    # measurements (time.thread_time per message) to the unmodified
    # MasterProfiler instead, making the drift *act* on decisions
    measurement: str = "emulated"
    # how often a vector-gated idle PE re-checks the blocked head (scenario
    # seconds); None → the control dt
    poll_interval: Optional[float] = None
    # The paper's threshold predictor can starve a sub-``queue_low`` tail
    # forever (see the synthetic scenario's ``nearly_completes`` note).  The
    # simulator burns simulated time to ``t_max`` in that state; burning
    # *wall* time would be pure waste, so the live driver exits early once
    # the cluster has provably stalled — arrivals closed, backlog static
    # below every trigger, zero PEs, and both IRM queues empty — for this
    # many scenario seconds.  ``None`` disables the early exit.
    starvation_grace: Optional[float] = 30.0


class LiveCluster:
    """``ClusterView`` implementation over the live master/worker state.

    The observation methods mirror ``core.sim.SimCluster`` line for line —
    same estimate caching, same accumulation order — so the IRM sees the
    same *kind* of cluster through both backends; only the dynamics behind
    the view differ (real tasks instead of event heaps).
    """

    def __init__(
        self,
        cfg: SimConfig,
        irm: IRM,
        master: Master,
        pool: WorkerPool,
        lifecycle: Lifecycle,
    ):
        self.cfg = cfg
        self.irm = irm
        self.master = master
        self.pool = pool
        self.lifecycle = lifecycle
        self._dims = tuple(cfg.resource_dims)
        self._multi = len(self._dims) > 1
        if self._multi:
            if self._dims[0] != "cpu":
                raise ValueError(
                    f"resource_dims[0] must be 'cpu', got {self._dims}"
                )
            irm.profiler.set_resource_dims(self._dims)

    # ---- ClusterView protocol ---------------------------------------------
    def queue_length(self) -> float:
        return self.master.queue_length()

    def queue_image_mix(self) -> Dict[str, float]:
        return self.master.queue_image_mix()

    def worker_scheduled_loads(self) -> List:
        # A failed slot reports a full bin: it can never host a PE, and a
        # placement First-Fit put there would fail until its TTL ran out
        # (the simulator reports it empty, as an OFF slot).
        est = self.irm.profiler.estimate
        cache: Dict[str, object] = {}
        failed = self.lifecycle.failed
        cap = self.irm.config.allocator.capacity
        if self._multi:
            D = len(self._dims)
            full = (cap.values if isinstance(cap, Resources)
                    else np.full(D, float(cap)))
            vout: List[Resources] = []
            for w in self.pool.workers:
                if w.state is WorkerState.OFF:
                    vout.append(Resources(self._dims, full if w.idx in failed
                                          else np.zeros(D)))
                    continue
                load = np.zeros(D)
                for pe in w.pes:
                    img = pe.image
                    v = cache.get(img)
                    if v is None:
                        v = cache[img] = est(img).values
                    load = load + v
                vout.append(Resources(self._dims, load))
            return vout
        out: List[float] = []
        for w in self.pool.workers:
            if w.state is WorkerState.OFF:
                out.append(float(cap) if w.idx in failed else 0.0)
                continue
            load = 0.0
            for pe in w.pes:
                img = pe.image
                v = cache.get(img)
                if v is None:
                    v = cache[img] = est(img)
                load += v
            out.append(load)
        return out

    def backlog_resource_demand(self) -> Optional[Resources]:
        # The ROADMAP's decision-latency budget item: read the master's
        # incremental per-image counters (O(images)) instead of walking
        # the backlog head message by message — one estimate lookup and
        # one vector op per image class, not per queued message.  The
        # 64-message cap matches the sim's scan so the predictor sees the
        # same demand signal on both backends.
        if not self._multi:
            return None
        est = self.irm.profiler.estimate
        total: Optional[Resources] = None
        for img, cnt in self.master.backlog_image_counts(64):
            v = est(img) * cnt
            total = v if total is None else total + v
        return total

    def try_start_pe(self, req: HostRequest) -> bool:
        return self.pool.try_start_pe(req)

    def scale_workers(self, target: int) -> None:
        self.lifecycle.scale_workers(target)


async def _arrival_feed(
    stream: Stream, master: Master, clock: ScaledClock
) -> None:
    """Inject the stream's batches at their scheduled (virtual) times.

    Batches that are already due are pushed *without* awaiting, so the
    t=0 batch reaches the master before the control loop's first tick
    (the simulator likewise enqueues arrivals before measuring a tick) —
    otherwise the predictor's first read would see an empty queue and the
    next one a spurious rate-of-change spike.
    """
    try:
        for t_batch, msgs in sorted(stream.batches, key=lambda b: b[0]):
            if t_batch > clock.now():
                await clock.sleep_until(t_batch)
            for m in msgs:
                master.push_back(m)
    finally:
        master.close_arrivals()


def _fail_over(irm: IRM, pool: WorkerPool, master: Master, t: float) -> bool:
    """While messages a worker failure requeued wait: one PE request for
    each image of theirs that no PE hosts and no request in the IRM's
    queues asks for.  Returns whether any such message still waits.

    A kill can take the only PE of an image whose message it requeues.  A
    backlog that small (one message, its rate of change read across the
    predictor's cooldown) is below every trigger of the load predictor, so
    no PE would be asked for again: the message would wait until the run
    gave up on it, lost to at-least-once delivery.  Checked every tick, as
    a request can run out of TTL while a worker boots and a PE can idle
    out first; where a PE of the image survives, nothing is asked."""
    waiting = master.requeued_waiting()
    if waiting:
        hosted = {pe.image for w in pool.workers for pe in w.pes}
        asked = {r.image for q in (irm.container_queue, irm.allocation_queue) for r in q}
        for image in sorted(waiting - hosted - asked):
            irm.container_queue.push(HostRequest(
                image=image, size_estimate=irm.profiler.estimate(image),
                ttl=irm.config.request_ttl, enqueue_time=t, source="failover"))
    return bool(waiting)


async def _drive(
    stream: Stream,
    cfg: SimConfig,
    irm: IRM,
    rt: RuntimeConfig,
    stats: Optional[Dict[str, object]],
    bus=None,
) -> SimResult:
    clock = ScaledClock(rt.time_scale)
    total = stream.num_messages
    master = Master(total_expected=total, bus=bus)
    poll = rt.poll_interval if rt.poll_interval is not None else cfg.dt
    if rt.measurement not in ("emulated", "os"):
        raise ValueError(
            f"measurement must be 'emulated' or 'os', got {rt.measurement!r}"
        )
    tkwargs = dict(rt.transport_kwargs)
    if rt.transport == "multiproc":
        tkwargs.setdefault("measurement", rt.measurement)
    elif rt.measurement != "emulated":
        raise ValueError(
            "measurement='os' requires transport='multiproc' (the in-process"
            " backend has no OS boundary to measure)"
        )
    transport = make_transport(rt.transport, **tkwargs)
    if hasattr(transport, "set_payload_spec"):
        # process-backed workers build their own payload instance, and the
        # parent builds none: the workers are forked, and a parent that has
        # touched CUDA (or run torch CPU ops) leaves its children unable to
        # use it (or with hung thread pools)
        transport.set_payload_spec(rt.payload, rt.payload_kwargs)
        payload = None
    else:
        # construct the payload before starting the clock: TorchPayload
        # builds and warms its kernel at init, and that wall time must not
        # burn virtual time
        payload = make_payload(rt.payload, **rt.payload_kwargs)
    pool = WorkerPool(cfg, master, clock, payload, poll_interval=poll,
                      transport=transport)
    lifecycle = Lifecycle(pool, cfg, clock)
    cluster = LiveCluster(cfg, irm, master, pool, lifecycle)
    recorder = TraceRecorder(cfg)
    rng = np.random.default_rng(cfg.seed)
    dims = tuple(cfg.resource_dims)

    clock.start()
    if bus is not None:
        # live event stamps read the real scaled clock; the nominal tick
        # rides along in the envelope's ``tick`` field
        bus.now = clock.now
        irm.packing_manager.audit = bus.audit
    transport.connect()  # data-channel consumer needs the running loop
    feeder = asyncio.get_running_loop().create_task(
        _arrival_feed(stream, master, clock), name="arrival-feed"
    )
    # let the feeder push the t=0 batches before the first control tick
    await asyncio.sleep(0)
    step_wall_ms: List[float] = []
    wall0 = time.perf_counter()
    try:
        t = 0.0
        last_report_t = -1e9
        stall_since: Optional[float] = None
        fail_at = cfg.fail_worker_at
        failing_over = False
        while t <= cfg.t_max:
            await clock.sleep_until(t)
            # fault injection precedes boot promotion, as in the sim's
            # tick; the hook re-arms each tick until the victim slot
            # exists (the sim retries the same way for a late worker)
            lifecycle.nominal_t = t
            if bus is not None:
                bus.tick = t
            if fail_at is not None and t >= fail_at[1] \
                    and fail_at[0] < len(pool.workers):
                failing_over = lifecycle.kill_worker(fail_at[0]) > 0
                fail_at = None
            if failing_over:
                failing_over = _fail_over(irm, pool, master, t)
            pool.promote_booted(t)
            # under measurement="os" the transport feeds real per-message
            # CPU to the probes; the emulated draws are still recorded in
            # the trace (drift stays observable) but must not double-feed
            measured_cpu, dim_measure = measure_workers(
                pool.workers, cfg, rng, dims,
                accumulate=rt.measurement == "emulated",
            )
            if t - last_report_t >= cfg.report_interval:
                for w in pool.workers:
                    if w.state is WorkerState.ACTIVE and w.pes:
                        report = w.probe.report()
                        if report:
                            if len(dims) > 1:
                                report = {
                                    img: Resources(dims, vec)
                                    for img, vec in report.items()
                                }
                            irm.ingest_report(report)
                last_report_t = t
            w0 = time.perf_counter()
            step_metrics = irm.step(t, cluster)
            step_wall_ms.append((time.perf_counter() - w0) * 1e3)
            if bus is not None:
                emit_packing_audit(bus, irm.config.allocator.algorithm,
                                   step_metrics.packing)
            recorder.record(
                t,
                measured_cpu,
                dim_measure,
                cluster.worker_scheduled_loads(),
                pool.workers,
                int(master.queue_length()),
                lifecycle.requested_target,
                master.backlog_head(64),
                irm.profiler.estimate,
            )
            if master.drained.is_set():
                break
            if (
                rt.starvation_grace is not None
                and master.arrivals_closed
                and master.queue_length() > 0
                and pool.pe_count() == 0
                and len(irm.container_queue) == 0
                and len(irm.allocation_queue) == 0
            ):
                if stall_since is None:
                    stall_since = t
                elif t - stall_since >= rt.starvation_grace:
                    break  # predictor-starved tail: nothing can ever change
            else:
                stall_since = None
            t = round(t + cfg.dt, 9)
    finally:
        feeder.cancel()
        await asyncio.gather(feeder, return_exceptions=True)
        await pool.shutdown()

    if stats is not None:
        wall_s = time.perf_counter() - wall0
        arr = np.asarray(step_wall_ms) if step_wall_ms else np.zeros(1)
        stats.update(
            wall_s=wall_s,
            ticks=len(step_wall_ms),
            irm_step_ms_mean=float(arr.mean()),
            irm_step_ms_p50=float(np.percentile(arr, 50)),
            irm_step_ms_p99=float(np.percentile(arr, 99)),
            messages_per_s=len(master.completed) / max(wall_s, 1e-9),
            transport=transport.stats(),
            # per-message device ms of the torch payload on the card (CUDA
            # events around each launch), from the in-process payload or
            # from the worker processes; empty otherwise
            payload_device_ms=list(
                getattr(payload, "device_ms", ()) if payload is not None
                else getattr(transport, "payload_device_ms", ())),
        )
    return recorder.finalize(
        completed=len(master.completed),
        total=total,
        makespan=master.max_done_t,
        messages=[m for _, b in stream.batches for m in b],
        requeued=master.requeued,
    )


def run_live(
    stream: Stream,
    config: Optional[SimConfig] = None,
    irm: Optional[IRM] = None,
    irm_config: Optional[IRMConfig] = None,
    runtime: Optional[RuntimeConfig] = None,
    stats: Optional[Dict[str, object]] = None,
    bus=None,
) -> SimResult:
    """Run the IRM against a workload stream on the live asyncio runtime.

    Same contract as ``core.sim.simulate``: passing an existing ``irm``
    keeps its profiler state across runs (the paper's persistent-profile
    experiment); the returned ``SimResult`` feeds the same summaries,
    expectations, and figure dumps.  ``stats``, when given, is filled with
    wall-clock throughput and IRM decision-latency numbers, and with the
    ``torch`` payload on the card its per-message device ms
    (``chip_smoke.py`` reads them).
    """
    cfg = config or SimConfig()
    if irm is None:
        irm = IRM(irm_config or IRMConfig())
    else:
        irm.begin_run()
    rt = runtime or RuntimeConfig()
    return asyncio.run(_drive(stream, cfg, irm, rt, stats, bus=bus))

"""Trace recording: the live runtime's ``SimResult``-compatible record.

``TraceRecorder`` samples the cluster once per control tick and emits the
same per-tick time series the simulator records — measured/scheduled CPU
per worker, queue length, active/target/ideal worker counts, PE count,
and the per-dimension arrays in vector mode — packed into a
``core.sim.SimResult``.  Everything downstream (``scenarios.engine``
summary metrics, expectation checks, policy sweeps, the figure CSV dump)
therefore works unchanged on either backend.

Measurement model: the live runtime executes *real* concurrent work, but
its per-PE CPU draw is emulated with the simulator's model (busy PE →
``cpu_cores`` + Gaussian noise, idle PE → ``idle_pe_cpu_cores``, starting
PE → 0, clipped per worker) rather than read from the OS.  That keeps the
profiler's learned sizes, and therefore the packing decisions under test,
on the same scale as the simulator — which is exactly what the
cross-backend parity suite asserts.  Auxiliary dimensions are measured
exactly (reservations are deterministic), as in the sim.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from ..core.sim import PEState, SimConfig, SimResult, WorkerState
from ..core.workloads import Message

__all__ = ["TraceRecorder", "measure_workers"]


def measure_workers(
    workers,
    cfg: SimConfig,
    rng: np.random.Generator,
    dims: Tuple[str, ...],
    accumulate: bool = True,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Instantaneous measured usage per worker, accumulated into probes.

    Returns ``(cpu_row, dim_rows)`` where ``cpu_row`` is the measured CPU
    fraction per worker slot and ``dim_rows`` is the (n_workers, D)
    per-dimension matrix in vector mode (``None`` on the scalar path).
    Same draw model and probe accumulation as the simulator's ``measure``.

    ``accumulate=False`` records the emulated trace rows without feeding
    the probes — used when a transport supplies *real* OS measurements to
    the profiler instead (``RuntimeConfig.measurement="os"``), so the
    emulated draws stay visible in the trace for drift comparison but
    never reach the learning path.
    """
    multi = len(dims) > 1
    D = len(dims)
    cores_per_worker = float(cfg.cores_per_worker)
    noise_std = cfg.cpu_noise_std * cfg.cores_per_worker
    idle_draw = min(max(cfg.idle_pe_cpu_cores, 0.0), cores_per_worker)
    rng_normal = rng.normal
    busy, idle = PEState.BUSY, PEState.IDLE
    n = max(len(workers), 1)
    out = np.zeros(n)
    dim_out = np.zeros((n, D)) if multi else None
    for w in workers:
        if w.state is not WorkerState.ACTIVE:
            continue
        acc, counts = w.probe.accumulators()
        if multi:
            totals = np.zeros(D)
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
                if accumulate:
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
        else:
            cores = 0.0
            for pe in w.pes:
                if pe.state is busy and pe.msg is not None:
                    draw = pe.msg.cpu_cores * float(rng_normal(1.0, noise_std))
                    if draw < 0.0:
                        draw = 0.0
                    elif draw > cores_per_worker:
                        draw = cores_per_worker
                elif pe.state is idle:
                    draw = idle_draw
                else:
                    draw = 0.0
                cores += draw
                if accumulate:
                    img = pe.image
                    if img in acc:
                        acc[img] += draw / cores_per_worker
                        counts[img] += 1
                    else:
                        acc[img] = draw / cores_per_worker
                        counts[img] = 1
            u = cores / cores_per_worker
            out[w.idx] = u if u < 1.0 else 1.0
    return out, dim_out


class TraceRecorder:
    """Collects per-tick rows and finalizes them into a ``SimResult``."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.dims = tuple(cfg.resource_dims)
        self.multi = len(self.dims) > 1
        self.times: List[float] = []
        self.measured: List[np.ndarray] = []
        self.scheduled: List[np.ndarray] = []
        self.qlen: List[int] = []
        self.active: List[int] = []
        self.target: List[int] = []
        self.ideal: List[int] = []
        self.pe_count: List[int] = []
        self.measured_res: List[np.ndarray] = []
        self.scheduled_res: List[np.ndarray] = []

    def record(
        self,
        t: float,
        measured_cpu: np.ndarray,
        dim_measure: Optional[np.ndarray],
        scheduled_loads,
        workers,
        qlen: int,
        requested_target: int,
        backlog: List[Message],
        estimate,
    ) -> None:
        """Append one control-tick row (mirrors the simulator's recording)."""
        cfg = self.cfg
        W = cfg.max_workers
        D = len(self.dims)
        mrow = np.zeros(W)
        k = min(len(measured_cpu), W)
        mrow[:k] = measured_cpu[:k]
        srow = np.zeros(W)
        if self.multi:
            mres_row = np.zeros((W, D))
            if dim_measure is not None:
                mres_row[:k] = dim_measure[:k]
            sres_row = np.zeros((W, D))
            for j in range(min(len(scheduled_loads), W)):
                v = scheduled_loads[j].values
                c = v[0]
                srow[j] = c if c < 1.0 else 1.0
                sres_row[j] = np.minimum(v, 1.0)
            self.measured_res.append(mres_row)
            self.scheduled_res.append(sres_row)
        else:
            for j in range(min(len(scheduled_loads), W)):
                v = scheduled_loads[j]
                srow[j] = v if v < 1.0 else 1.0

        n_active = 0
        n_pes = 0
        if self.multi:
            busy_vec = np.zeros(D)
            for w in workers:
                n_pes += len(w.pes)
                if w.state is WorkerState.ACTIVE:
                    n_active += 1
                    for pe in w.pes:
                        busy_vec = busy_vec + pe.estimate.values
            backlog_vec = np.zeros(D)
            for msg in backlog:
                backlog_vec = backlog_vec + estimate(msg.image).values
            ideal = int(max(
                math.ceil(busy_vec[j] + (backlog_vec[j]
                                         if backlog_vec[j] < 64.0 else 64.0))
                for j in range(D)
            ))
        else:
            busy_load = 0.0
            for w in workers:
                n_pes += len(w.pes)
                if w.state is WorkerState.ACTIVE:
                    n_active += 1
                    for pe in w.pes:
                        busy_load += pe.estimate
            backlog_load = 0.0
            for msg in backlog:
                backlog_load += estimate(msg.image)
            ideal = int(math.ceil(
                busy_load + (backlog_load if backlog_load < 64.0 else 64.0)
            ))

        self.times.append(t)
        self.measured.append(mrow)
        self.scheduled.append(srow)
        self.qlen.append(qlen)
        self.active.append(n_active)
        self.target.append(requested_target)
        self.ideal.append(ideal)
        self.pe_count.append(n_pes)

    def finalize(
        self,
        completed: int,
        total: int,
        makespan: float,
        messages: List[Message],
        requeued: int = 0,
    ) -> SimResult:
        n = len(self.times)
        W = self.cfg.max_workers
        return SimResult(
            times=np.asarray(self.times, np.float64),
            measured_cpu=(
                np.stack(self.measured) if n else np.zeros((0, W))
            ),
            scheduled_cpu=(
                np.stack(self.scheduled) if n else np.zeros((0, W))
            ),
            queue_len=np.asarray(self.qlen, np.int64),
            active_workers=np.asarray(self.active, np.int64),
            target_workers=np.asarray(self.target, np.int64),
            ideal_bins=np.asarray(self.ideal, np.int64),
            pe_count=np.asarray(self.pe_count, np.int64),
            completed=completed,
            total=total,
            makespan=makespan,
            messages=messages,
            resource_dims=self.dims,
            measured_res=(
                np.stack(self.measured_res) if self.multi and n else None
            ),
            scheduled_res=(
                np.stack(self.scheduled_res) if self.multi and n else None
            ),
            requeued=requeued,
        )

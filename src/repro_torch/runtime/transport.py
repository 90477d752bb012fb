"""The master↔worker boundary as an explicit, swappable Transport layer.

The live runtime used to hard-wire its workers into the master's event
loop: PEs were asyncio tasks calling ``Master.pull``/``complete`` as plain
method calls, so serialization and transfer cost — which the HarmonicIO
benchmark comparison shows *dominate* streams of individual objects — were
structurally invisible, and per-worker CPU could only be emulated.  This
module re-cuts that boundary the way Pilot-Streaming separates the
resource broker from its compute units: everything that crosses between
the master's control plane and a worker travels through a ``Transport``,
and the rest of the runtime (``Master``, ``WorkerPool``, ``Lifecycle``,
the driver) no longer knows — or cares — where a worker physically runs.

Two channels per worker, mirroring the HarmonicIO wire protocol:

  - the **control channel** carries commands (``start_pe``, pull replies,
    ``stop``) from the master side to the worker;
  - the **data channel** carries worker→master traffic: pull requests,
    completed ``Message`` payloads, PE exits, and CPU measurements.

Two implementations:

``InProcTransport``
    The previous asyncio backend, repackaged: PEs are asyncio tasks on the
    master's own loop and both channels are direct method calls — zero
    copies, zero serialization.  Semantics are bit-identical to the
    pre-transport runtime (the parity and fault suites pin this), which is
    what makes it the refactor's control group.

``MultiprocTransport``
    Each worker is a real ``multiprocessing.Process``.  The control
    channel is an ``mp.Queue`` into the worker; the data channel is an
    ``mp.Queue`` back out, drained by a single poller task on the event
    loop (single-consumer by construction, so a worker kill can drain the
    tail of the data channel synchronously without racing a reader).
    Inside the process, PEs run on an in-process thread pool: each PE
    thread loops pull → execute payload → report completion, exactly the
    paper's processing-element loop, but with every message crossing a
    genuine OS boundary through ``pickle`` (`serialize`/`deserialize`
    hooks, byte- and time-accounted).  Workers measure *real* CPU —
    ``time.thread_time`` per message and ``os.times`` per process — so the
    gap between the paper's emulated profiler and actual OS measurement
    becomes a first-class number (``stats()["profiler_drift_pp"]``,
    benchmarked by ``benchmarks/transport_bench.py``).

The master-side mirror: the parent keeps a ``LivePE`` object per remote
PE (state, current message, placement estimate), updated from data-channel
events.  Everything that observes the cluster — scheduled-load views, the
emulated measurement model, trace recording, the vector congestion gate —
reads that mirror with the exact same code as the in-process backend, so
the IRM sees the same *kind* of cluster through every transport.
"""

from __future__ import annotations

import asyncio
import os
import pickle
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..core.sim import PEState, WorkerState
from ..core.workloads import Message
from .annotations import loop_only, transition, worker_side

__all__ = [
    "Transport",
    "InProcTransport",
    "MultiprocTransport",
    "make_transport",
    "TRANSPORTS",
]


class Transport:
    """Interface between the master's control plane and its workers.

    A transport is *bound* to one ``WorkerPool`` (``bind``), told when the
    run's clock starts (``connect`` — the moment the loop exists), asked
    to host PEs (``spawn_pe``) on workers it was told to provision
    (``start_worker``/``stop_worker``), and finally torn down (``close``).
    ``kill_worker`` implements the abrupt-failure path and must preserve
    the at-least-once contract: it returns exactly the messages that were
    in flight at the victim and can provably no longer complete.
    """

    name = "abstract"

    def bind(self, pool) -> None:
        """Attach to a ``WorkerPool`` (gives access to master/clock/cfg)."""
        self.pool = pool

    def connect(self) -> None:
        """Called once inside the running loop, after ``clock.start()``."""

    def start_worker(self, worker) -> None:
        """Provision the backing resource for a (re)booted worker slot."""

    def stop_worker(self, worker) -> None:
        """Release a deactivated (scaled-down, PE-less) worker's backing."""

    def spawn_pe(self, worker, pe) -> None:
        """Start the pull-execute loop for a freshly placed PE."""
        raise NotImplementedError

    def kill_worker(self, worker) -> List[Message]:
        """Abruptly terminate a worker; return its harvested in-flight
        messages (completions that already reached the data channel are
        applied, not harvested — a message can never do both)."""
        raise NotImplementedError

    async def close(self) -> None:
        """Tear down every PE/worker this transport still hosts."""
        raise NotImplementedError

    # ---- serialization hooks (the data channel's wire format) -------------
    def serialize(self, msg: Message) -> bytes:
        return pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)

    def deserialize(self, blob: bytes) -> Message:
        return pickle.loads(blob)

    def stats(self) -> Dict[str, object]:
        """Wire-level counters (bytes, serialization time, CPU reports)."""
        return {"transport": self.name}


class InProcTransport(Transport):
    """Direct object handoff on the master's own event loop (zero-copy).

    This *is* the original asyncio backend: ``spawn_pe`` creates an
    asyncio task running the pull-execute loop against the master's plain
    method calls, and ``kill_worker`` harvests synchronously on the loop
    thread.  No bytes ever cross a boundary, so the serialize hooks go
    unused and ``stats()`` reports zeros.
    """

    name = "inproc"

    def __init__(self) -> None:
        self._tasks: set = set()

    def spawn_pe(self, worker, pe) -> None:
        pe.task = asyncio.get_running_loop().create_task(
            self._pe_main(worker, pe),
            name=f"pe-{worker.idx}-{pe.uid}-{pe.image}",
        )
        self._tasks.add(pe.task)
        pe.task.add_done_callback(self._tasks.discard)

    # ---- the PE loop (verbatim the pre-transport asyncio PE) --------------
    @transition("pe", "ready", src="starting", dst="idle")
    @transition("msg", "msg.pulled", src="enqueued|requeued", dst="pulled")
    @transition("pe", "msg.pulled", src="idle", dst="busy")
    @transition("msg", "msg.started", src="pulled", dst="started")
    @transition("msg", "msg.completed", src="started", dst="completed")
    @transition("pe", "msg.completed", src="busy", dst="idle")
    @transition("pe", "pe.exit", src="idle", dst="stopped")
    async def _pe_main(self, worker, pe) -> None:
        pool = self.pool
        cfg = pool.cfg
        clock = pool.clock
        master = pool.master
        bus = master.bus
        try:
            await clock.sleep(cfg.pe_start_delay)
            pe.state = PEState.IDLE
            pe.idle_since = clock.now()
            while True:
                head = master.head(pe.image)
                if head is not None and pool._gate_ok(worker, head):
                    msg = master.pull(pe.image)
                    # single-threaded loop: the head cannot change between
                    # peek and pull without an await in between
                    assert msg is head
                    pe.state = PEState.BUSY
                    pe.msg = msg
                    if bus is not None:
                        bus.emit("msg.pulled", msg_id=msg.msg_id,
                                 image=msg.image, worker=worker.idx,
                                 pe=pe.uid)
                    msg.start_t = clock.now()
                    if bus is not None:
                        bus.emit("msg.started", msg_id=msg.msg_id,
                                 image=msg.image, worker=worker.idx,
                                 pe=pe.uid)
                    await pool.payload(msg, clock)
                    msg.done_t = clock.now()
                    pe.msg = None
                    pe.state = PEState.IDLE
                    pe.idle_since = clock.now()
                    if bus is not None:
                        bus.emit("msg.completed", msg_id=msg.msg_id,
                                 image=msg.image, worker=worker.idx,
                                 pe=pe.uid, start_t=msg.start_t,
                                 done_t=msg.done_t, arrival=msg.arrival)
                    master.complete(msg)
                    continue
                remaining = cfg.container_idle_timeout - (
                    clock.now() - pe.idle_since
                )
                if remaining <= 0:
                    if bus is not None:
                        bus.emit("pe.exit", worker=worker.idx, pe=pe.uid,
                                 image=pe.image)
                    break  # graceful self-termination
                if head is not None:
                    # vector-gated head: poll (head-blocking FIFO — the
                    # blocked head is never skipped)
                    await clock.sleep(min(remaining, pool.poll_interval))
                else:
                    await master.wait_for_work(
                        pe.image, clock.to_wall(remaining)
                    )
        except asyncio.CancelledError:
            pass  # driver shutdown: drop the PE silently
        finally:
            pe.state = PEState.STOPPED
            try:
                worker.pes.remove(pe)
            except ValueError:
                pass  # kill_worker already cleared the list (and the count)
            else:
                pool._pe_total -= 1

    @loop_only
    @transition("pe", "worker.kill", src="starting|idle|busy", dst="stopped",
                scope="worker")
    def kill_worker(self, worker) -> List[Message]:
        """Cancel the victim's PE tasks synchronously on the loop thread.

        A BUSY PE is either still awaiting its payload (the cancellation
        lands there; its ``finally`` runs later against an already-emptied
        worker) or has already run its completion bookkeeping — a
        harvested message can never also complete.  Harvest order is PE
        order, matching the sim's one-by-one ``insert(0, m)`` sequence.
        """
        harvested: List[Message] = []
        for pe in list(worker.pes):
            if pe.msg is not None:
                harvested.append(pe.msg)
                pe.msg = None
            pe.state = PEState.STOPPED
            if pe.task is not None and not pe.task.done():
                pe.task.cancel()
        return harvested

    async def close(self) -> None:
        tasks = [t for t in self._tasks if not t.done()]
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)

    def stats(self) -> Dict[str, object]:
        return {
            "transport": self.name,
            "data_msgs_out": 0,
            "data_msgs_in": 0,
            "data_bytes_out": 0,
            "data_bytes_in": 0,
            "serialize_ms": 0.0,
        }


# ---------------------------------------------------------------------------
# Multiprocess transport
# ---------------------------------------------------------------------------

# data-channel event tags (worker → master)
_EV_READY = 0      # (tag, pe_uid) — PE finished its start delay
_EV_PULL = 1       # (tag, pe_uid, image, decode_ms)
_EV_COMPLETE = 2   # (tag, pe_uid, blob, start_t, done_t, cpu_s, encode_ms,
#                     proc_cpu_s, device_ms, kernel_launches)
_EV_PE_EXIT = 3    # (tag, pe_uid) — idle-timeout self-termination
_EV_METRICS = 4    # (tag, pe_uid, registry_delta) — mergeable metrics flush
_EV_PAYLOAD = 5    # (tag, kernel_launches) — the payload's set-up launches

# control-channel command tags (master → worker)
_CMD_START_PE = 0  # (tag, pe_uid, image)
_CMD_REPLY = 1     # (tag, pe_uid, blob_or_None)
_CMD_STOP = 2      # (tag,)


def _proc_cpu_seconds() -> float:
    t = os.times()
    return t.user + t.system


@worker_side
def _mp_worker_main(
    widx: int,
    cmd_q,
    data_q,
    time_scale: float,
    mono0: float,
    pe_start_delay: float,
    idle_timeout: float,
    poll_interval: float,
    payload_spec: Tuple[str, dict],
    obs_enabled: bool = False,
) -> None:
    """Entry point of one worker process.

    The main thread is a dispatcher: it reads control-channel commands and
    routes pull replies to the PE threads.  Each PE is a thread running
    the paper's pull-execute loop against the data channel; message
    payloads execute synchronously on the PE thread (that *is* the
    worker's CPU), measured with ``time.thread_time`` per message and
    ``os.times`` per process.
    """
    from .payloads import make_payload

    payload = make_payload(payload_spec[0], **payload_spec[1])
    data_q.put((_EV_PAYLOAD, payload.kernel_launches()))
    cpu0 = _proc_cpu_seconds()
    stop = threading.Event()
    replies: Dict[int, "queue.Queue"] = {}

    def now() -> float:
        return (time.monotonic() - mono0) / time_scale

    def _pe_thread(uid: int, image: str) -> None:
        # Per-thread metrics registry: deltas are flushed over the data
        # channel *before* the completion they describe, so FIFO ordering
        # guarantees the master's merged counters equal the applied
        # completions exactly at a clean drain, and overshoot by at most
        # the killed worker's unflushed in-flight messages under SIGKILL.
        reg = None
        if obs_enabled:
            from ..obs.metrics import MetricsRegistry

            reg = MetricsRegistry()
        time.sleep(pe_start_delay * time_scale)
        data_q.put((_EV_READY, uid))
        idle_since = now()
        while not stop.is_set():
            data_q.put((_EV_PULL, uid, image))
            try:
                blob = replies[uid].get(timeout=1.0)
            except queue.Empty:
                continue  # master is slow or shutting down; re-check stop
            if blob is None:
                remaining = idle_timeout - (now() - idle_since)
                if remaining <= 0:
                    data_q.put((_EV_PE_EXIT, uid))
                    return  # graceful self-termination
                time.sleep(min(remaining, poll_interval) * time_scale)
                continue
            w0 = time.perf_counter()
            msg = pickle.loads(blob)
            decode_ms = (time.perf_counter() - w0) * 1e3
            start_t = now()
            tcpu0 = time.thread_time()
            device_ms = payload.run_sync(msg, time_scale)
            cpu_s = time.thread_time() - tcpu0
            done_t = now()
            msg.start_t = start_t
            msg.done_t = done_t
            w0 = time.perf_counter()
            out = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
            encode_ms = (time.perf_counter() - w0) * 1e3 + decode_ms
            if reg is not None:
                reg.counter("worker.msgs_completed").inc()
                reg.counter("worker.payload_cpu_s").inc(cpu_s)
                reg.histogram("worker.service_s").observe(done_t - start_t)
                # flush BEFORE the completion (see the registry note above)
                data_q.put((_EV_METRICS, uid, reg.delta()))
            data_q.put((
                _EV_COMPLETE, uid, out, start_t, done_t, cpu_s, encode_ms,
                _proc_cpu_seconds() - cpu0, device_ms,
                payload.kernel_launches(),
            ))
            idle_since = now()

    threads: List[threading.Thread] = []
    while True:
        try:
            cmd = cmd_q.get(timeout=0.5)
        except queue.Empty:
            if stop.is_set():
                break
            continue
        tag = cmd[0]
        if tag == _CMD_START_PE:
            uid, image = cmd[1], cmd[2]
            replies[uid] = queue.Queue()
            th = threading.Thread(
                target=_pe_thread, args=(uid, image),
                name=f"pe-{widx}-{uid}", daemon=True,
            )
            threads.append(th)
            th.start()
        elif tag == _CMD_REPLY:
            rq = replies.get(cmd[1])
            if rq is not None:
                rq.put(cmd[2])
        elif tag == _CMD_STOP:
            stop.set()
            break
    for th in threads:
        th.join(timeout=1.0)


class _ProcHandle:
    """Master-side bookkeeping for one worker process."""

    __slots__ = ("proc", "cmd_q", "data_q", "pes", "proc_cpu_s",
                 "kernel_launches")

    def __init__(self, proc, cmd_q, data_q):
        self.proc = proc
        self.cmd_q = cmd_q
        self.data_q = data_q
        self.pes: Dict[int, object] = {}  # pe_uid -> LivePE mirror
        self.proc_cpu_s = 0.0  # latest os.times() user+sys delta reported
        self.kernel_launches = 0  # latest payload launch count reported


class MultiprocTransport(Transport):
    """Workers as OS processes with command/data queues per worker.

    The poller task is the data channels' *only* consumer in steady state
    and runs on the event loop thread; ``kill_worker`` also drains on the
    loop thread, so the two can never race (no executor threads touch the
    queues).  Completion bookkeeping therefore happens exactly where the
    in-process backend does it — on the loop — just triggered by wire
    events instead of awaited coroutines.
    """

    name = "multiproc"

    def __init__(
        self,
        start_method: Optional[str] = None,
        poll_wall: float = 0.002,
        measurement: str = "emulated",
    ):
        import multiprocessing as mp

        if start_method is None:
            start_method = (
                "fork" if "fork" in mp.get_all_start_methods() else "spawn"
            )
        self._ctx = mp.get_context(start_method)
        self.start_method = start_method
        self.poll_wall = float(poll_wall)
        if measurement not in ("emulated", "os"):
            raise ValueError(
                f"measurement must be 'emulated' or 'os', got {measurement!r}"
            )
        self.measurement = measurement
        self._procs: Dict[int, _ProcHandle] = {}
        self._retired: List[_ProcHandle] = []
        self._poller: Optional[asyncio.Task] = None
        self._payload_spec: Tuple[str, dict] = ("sleep", {})
        # wire counters (the data channel's serialization ledger)
        self.data_msgs_out = 0   # master → worker message payloads
        self.data_msgs_in = 0    # worker → master completed payloads
        self.data_bytes_out = 0
        self.data_bytes_in = 0
        self.serialize_ms = 0.0  # encode+decode, both sides, both directions
        self.workers_spawned = 0
        # measured-vs-emulated CPU ledger (per completed message)
        self._drift_sum_pp = 0.0
        self._drift_n = 0
        self._real_core_s = 0.0      # Σ thread-CPU seconds across messages
        self._emulated_core_s = 0.0  # Σ cpu_cores · duration (the model)
        self.proc_cpu_s_total = 0.0  # Σ os.times() deltas across processes
        # the payload's device work, reported by the workers
        self.payload_device_ms: List[float] = []  # per completed message
        self.payload_kernel_launches = 0  # Σ across processes

    # ---- provisioning ------------------------------------------------------
    def set_payload_spec(self, name: str, kwargs: dict) -> None:
        """What each worker process should construct as its PE payload."""
        self._payload_spec = (name, dict(kwargs))

    def connect(self) -> None:
        self._poller = asyncio.get_running_loop().create_task(
            self._poll_loop(), name="transport-poller"
        )

    @loop_only
    def start_worker(self, worker) -> None:
        pool = self.pool
        cfg = pool.cfg
        clock = pool.clock
        cmd_q = self._ctx.Queue()
        data_q = self._ctx.Queue()
        mono0, time_scale = clock.anchor()
        proc = self._ctx.Process(
            target=_mp_worker_main,
            args=(
                worker.idx, cmd_q, data_q, time_scale, mono0,
                cfg.pe_start_delay, cfg.container_idle_timeout,
                pool.poll_interval, self._payload_spec,
                pool.master.bus is not None,
            ),
            name=f"irm-worker-{worker.idx}",
            daemon=True,
        )
        proc.start()
        self._procs[worker.idx] = _ProcHandle(proc, cmd_q, data_q)
        self.workers_spawned += 1

    @loop_only
    def stop_worker(self, worker) -> None:
        # scale-down only retires PE-less workers, so the data channel is
        # quiet; park the handle for close() to join
        h = self._procs.pop(worker.idx, None)
        if h is not None:
            h.cmd_q.put_nowait((_CMD_STOP,))
            self._retired.append(h)

    @loop_only
    def spawn_pe(self, worker, pe) -> None:
        h = self._procs.get(worker.idx)
        if h is None:  # pragma: no cover - placement gates on ACTIVE state
            raise RuntimeError(f"worker {worker.idx} has no backing process")
        h.pes[pe.uid] = pe
        h.cmd_q.put_nowait((_CMD_START_PE, pe.uid, pe.image))

    # ---- the data-channel consumer ----------------------------------------
    @loop_only
    async def _poll_loop(self) -> None:
        try:
            while True:
                busy = False
                for idx in list(self._procs):
                    h = self._procs.get(idx)
                    if h is None:
                        continue
                    while True:
                        try:
                            ev = h.data_q.get_nowait()
                        except queue.Empty:
                            break
                        busy = True
                        self._handle_event(idx, h, ev)
                await asyncio.sleep(0.0 if busy else self.poll_wall)
        except asyncio.CancelledError:
            pass

    @loop_only
    @transition("pe", "ready", src="starting", dst="idle")
    @transition("pe", "pe.exit", src="idle", dst="stopped")
    def _handle_event(self, widx: int, h: _ProcHandle, ev: tuple) -> None:
        pool = self.pool
        tag = ev[0]
        if tag == _EV_METRICS:
            # metric deltas outlive their PE mirror (a flush can land after
            # the PE's exit event): merge unconditionally, never drop
            bus = pool.master.bus
            if bus is not None:
                bus.registry.merge(ev[2])
            return
        if tag == _EV_PAYLOAD:
            self._fold_launches(h, ev[1])
            return
        pe = h.pes.get(ev[1])
        if pe is None:
            return  # PE exited or worker was killed while the event flew
        if tag == _EV_PULL:
            self._on_pull(widx, h, pe)
        elif tag == _EV_COMPLETE:
            self._on_complete(widx, h, pe, ev)
        elif tag == _EV_READY:
            pe.state = PEState.IDLE
            pe.idle_since = pool.clock.now()
        elif tag == _EV_PE_EXIT:
            h.pes.pop(pe.uid, None)
            pe.state = PEState.STOPPED
            bus = pool.master.bus
            if bus is not None:
                bus.emit("pe.exit", worker=widx, pe=pe.uid, image=pe.image)
            worker = pool.workers[widx]
            try:
                worker.pes.remove(pe)
            except ValueError:
                pass  # kill_worker already cleared the list
            else:
                pool._pe_total -= 1

    @loop_only
    @transition("msg", "msg.pulled", src="enqueued|requeued", dst="pulled")
    @transition("pe", "msg.pulled", src="idle", dst="busy")
    @transition("msg", "msg.started", src="pulled", dst="started")
    def _on_pull(self, widx: int, h: _ProcHandle, pe) -> None:
        """The master side of a P2P pull: atomically peek the FIFO head,
        run the vector congestion gate against the mirror state, and ship
        the message — all on the loop thread, so the head cannot change
        between peek and pull (same invariant as the in-process PE)."""
        pool = self.pool
        master = pool.master
        worker = pool.workers[widx]
        head = master.head(pe.image)
        if (
            head is None
            or worker.state is not WorkerState.ACTIVE
            or not pool._gate_ok(worker, head)
        ):
            h.cmd_q.put_nowait((_CMD_REPLY, pe.uid, None))
            return
        msg = master.pull(pe.image)
        assert msg is head
        pe.state = PEState.BUSY
        pe.msg = msg
        bus = master.bus
        if bus is not None:
            bus.emit("msg.pulled", msg_id=msg.msg_id, image=msg.image,
                     worker=widx, pe=pe.uid)
            bus.emit("msg.started", msg_id=msg.msg_id, image=msg.image,
                     worker=widx, pe=pe.uid)
        msg.start_t = pool.clock.now()  # refined by the worker's own stamp
        w0 = time.perf_counter()
        blob = self.serialize(msg)
        self.serialize_ms += (time.perf_counter() - w0) * 1e3
        self.data_msgs_out += 1
        self.data_bytes_out += len(blob)
        h.cmd_q.put_nowait((_CMD_REPLY, pe.uid, blob))

    @loop_only
    @transition("msg", "msg.completed", src="started", dst="completed")
    @transition("pe", "msg.completed", src="busy", dst="idle")
    def _on_complete(self, widx: int, h: _ProcHandle, pe, ev: tuple) -> None:
        (_, _, blob, start_t, done_t, cpu_s, encode_ms, proc_cpu_s,
         device_ms, kernel_launches) = ev
        pool = self.pool
        msg = pe.msg
        if msg is None:
            return  # duplicate delivery after a kill-drain already applied it
        w0 = time.perf_counter()
        remote = self.deserialize(blob)
        self.serialize_ms += (time.perf_counter() - w0) * 1e3 + encode_ms
        self.data_msgs_in += 1
        self.data_bytes_in += len(blob)
        assert remote.msg_id == msg.msg_id
        # copy the worker's authoritative stamps onto the master's object
        # (the stream's own Message instances are what SimResult reports)
        msg.start_t = float(start_t)
        msg.done_t = float(done_t)
        # each report is cumulative for its process; fold the delta into
        # the run total (handles come and go with reboots/kills)
        self.proc_cpu_s_total += float(proc_cpu_s) - h.proc_cpu_s
        h.proc_cpu_s = float(proc_cpu_s)
        self._fold_launches(h, kernel_launches)
        if device_ms is not None:
            self.payload_device_ms.append(float(device_ms))
        self._account_cpu(
            pool.workers[widx], pe, msg, float(cpu_s),
            float(done_t - start_t),
        )
        pe.msg = None
        pe.state = PEState.IDLE
        pe.idle_since = pool.clock.now()
        bus = pool.master.bus
        if bus is not None:
            bus.emit("msg.completed", msg_id=msg.msg_id, image=msg.image,
                     worker=widx, pe=pe.uid, start_t=msg.start_t,
                     done_t=msg.done_t, arrival=msg.arrival)
        pool.master.complete(msg)

    @loop_only
    def _fold_launches(self, h: _ProcHandle, kernel_launches: int) -> None:
        """Each report is the process's running count: fold its delta."""
        self.payload_kernel_launches += kernel_launches - h.kernel_launches
        h.kernel_launches = kernel_launches

    @loop_only
    def _account_cpu(
        self, worker, pe, msg: Message, cpu_s: float, busy_virtual_s: float
    ) -> None:
        """Fold one message's *real* CPU measurement into the drift ledger
        (and, under ``measurement='os'``, into the worker's probe so the
        unmodified ``MasterProfiler`` learns from OS numbers instead of
        the emulated model)."""
        pool = self.pool
        cores = float(pool.cfg.cores_per_worker)
        busy_wall = max(busy_virtual_s * pool.clock.time_scale, 1e-9)
        real_frac = (cpu_s / busy_wall) / cores
        emu_frac = msg.cpu_cores / cores
        self._drift_sum_pp += abs(emu_frac - real_frac) * 100.0
        self._drift_n += 1
        self._real_core_s += cpu_s
        self._emulated_core_s += msg.cpu_cores * busy_wall
        if self.measurement == "os":
            acc, counts = worker.probe.accumulators()
            dims = pool._dims
            if len(dims) > 1:
                import numpy as np

                vec = np.zeros(len(dims))
                vec[0] = min(real_frac, 1.0)
                if msg.resources:
                    for j, d in enumerate(dims[1:], start=1):
                        vec[j] = msg.resources.get(d, 0.0)
                sample = vec
            else:
                sample = min(real_frac, 1.0)
            if pe.image in acc:
                acc[pe.image] = acc[pe.image] + sample
                counts[pe.image] += 1
            else:
                acc[pe.image] = sample
                counts[pe.image] = 1

    # ---- failure injection -------------------------------------------------
    @loop_only(blocking=(
        "kill path deliberately stalls the loop: the SIGKILL'd process must "
        "be reaped and its data channel tail-drained synchronously so no "
        "completion can race the harvest (the poller is parked, not a "
        "second consumer)"
    ))
    @transition("pe", "worker.kill", src="starting|idle|busy", dst="stopped",
                scope="worker")
    def kill_worker(self, worker) -> List[Message]:
        """SIGKILL the worker process, then settle the data channel.

        Order matters for the at-least-once accounting the fault suite
        pins: (1) kill, so no *new* completions can be produced; (2) drain
        the data queue — completions the process flushed before dying are
        applied normally (those messages are done, not lost); (3) harvest
        whatever the mirror still marks in flight.  A message whose
        completion was only partially flushed at the kill is treated as
        lost and harvested — it will run again, which is exactly
        at-least-once.  All three steps run on the loop thread and the
        poller never blocks in a queue read, so no other consumer can
        interleave.
        """
        h = self._procs.pop(worker.idx, None)
        if h is not None:
            if h.proc.is_alive():
                h.proc.kill()  # SIGKILL — no cleanup, as a real VM failure
            h.proc.join(timeout=5.0)
            while True:
                try:
                    ev = h.data_q.get(timeout=0.05)
                except (queue.Empty, EOFError, OSError):
                    break
                except Exception:
                    break  # truncated pickle from the severed feeder pipe
                if ev[0] == _EV_COMPLETE:
                    pe = h.pes.get(ev[1])
                    if pe is not None:
                        self._on_complete(worker.idx, h, pe, ev)
                elif ev[0] in (_EV_PE_EXIT, _EV_METRICS, _EV_PAYLOAD):
                    # flushed metric deltas are applied like flushed
                    # completions: they describe work that really happened
                    self._handle_event(worker.idx, h, ev)
                # pending pulls/readies die with the worker
            h.cmd_q.cancel_join_thread()
            h.data_q.cancel_join_thread()
        harvested: List[Message] = []
        for pe in list(worker.pes):
            if pe.msg is not None:
                harvested.append(pe.msg)
                pe.msg = None
            pe.state = PEState.STOPPED
        return harvested

    # ---- teardown ----------------------------------------------------------
    @loop_only(blocking=(
        "teardown after the run: joins worker processes with bounded "
        "timeouts once the clock has stopped and no payload is in flight"
    ))
    async def close(self) -> None:
        if self._poller is not None:
            self._poller.cancel()
            await asyncio.gather(self._poller, return_exceptions=True)
            self._poller = None
        handles = list(self._procs.values()) + self._retired
        self._procs.clear()
        self._retired = []
        for h in handles:
            if h.proc.is_alive():
                try:
                    h.cmd_q.put_nowait((_CMD_STOP,))
                except Exception:
                    pass
        for h in handles:
            h.proc.join(timeout=1.0)
            if h.proc.is_alive():
                h.proc.terminate()
                h.proc.join(timeout=1.0)
            if h.proc.is_alive():  # pragma: no cover - last resort
                h.proc.kill()
                h.proc.join(timeout=1.0)
            h.cmd_q.cancel_join_thread()
            h.data_q.cancel_join_thread()

    # ---- wire/measurement ledger ------------------------------------------
    def stats(self) -> Dict[str, object]:
        n_in = max(self.data_msgs_in, 1)
        return {
            "transport": self.name,
            "start_method": self.start_method,
            "measurement": self.measurement,
            "workers_spawned": self.workers_spawned,
            "data_msgs_out": self.data_msgs_out,
            "data_msgs_in": self.data_msgs_in,
            "data_bytes_out": self.data_bytes_out,
            "data_bytes_in": self.data_bytes_in,
            "serialize_ms": self.serialize_ms,
            "ser_bytes_per_msg": (
                (self.data_bytes_out + self.data_bytes_in)
                / max(self.data_msgs_out + self.data_msgs_in, 1)
            ),
            "ser_ms_per_msg": self.serialize_ms / n_in,
            # emulated-vs-measured CPU, the headline fidelity number: mean
            # |model − os|, in percentage points of one worker's capacity
            "profiler_drift_pp": (
                self._drift_sum_pp / self._drift_n if self._drift_n else 0.0
            ),
            "real_cpu_core_s": self._real_core_s,
            "emulated_cpu_core_s": self._emulated_core_s,
            # whole-process CPU (os.times user+sys), includes the worker's
            # own dispatcher/queue overhead on top of the PE threads
            "proc_cpu_s": self.proc_cpu_s_total,
            # kernel launches of the workers' payloads, counted where the
            # kernel launches (warm-ups included)
            "payload_kernel_launches": self.payload_kernel_launches,
        }


TRANSPORTS = {
    "inproc": InProcTransport,
    "multiproc": MultiprocTransport,
}


def make_transport(name: str, **kwargs) -> Transport:
    """Resolve a transport by name (mirrors ``make_packer``/``make_payload``)."""
    try:
        factory = TRANSPORTS[name]
    except KeyError:
        raise ValueError(
            f"unknown transport {name!r}; available: {sorted(TRANSPORTS)}"
        ) from None
    return factory(**kwargs)

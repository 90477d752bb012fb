"""Live workers: slot bookkeeping over a pluggable Transport.

A ``LiveWorker`` models one worker VM (boot delay, per-image probe,
hosting capacity in resource fractions); each PE it hosts runs the
pull-execute loop the paper describes:

    start delay → idle → P2P pull from the master → execute payload →
    idle → ... → idle-timeout self-termination

*Where* that loop physically runs is the transport's business
(``runtime.transport``): an asyncio task on the master's own loop
(``InProcTransport`` — the original backend, bit-identical) or a thread
inside a separate worker OS process (``MultiprocTransport``).  The pool
itself is transport-blind: it owns the worker slots, their state indices,
and the ``LivePE`` objects every observer reads — for a process-backed
worker those are master-side *mirrors* kept current by data-channel
events, but the observation code cannot tell the difference.

State enums are shared with the simulator (``core.sim.PEState`` /
``WorkerState``) so observation code — scheduled-load views, measurement,
trace recording — reads all backends with identical logic.  All state
mutation happens on the event loop thread; payload *compute* may run in
executor threads or worker processes, but completion bookkeeping
re-enters the loop.

Vector mode: non-CPU dimensions are rigid, so an idle PE only pulls while
its worker's *currently running* messages leave room in every auxiliary
dimension (the sim's congestion gate, restated over live BUSY PEs — the
live runtime cannot key on ``done_t > t`` because a running message's
completion time is unknown until the payload returns).  The FIFO head
blocks rather than being skipped, exactly as in the simulator.
"""

from __future__ import annotations

import heapq
from bisect import insort
from typing import Dict, List, Optional, Tuple

from ..core.profiler import WorkerProbe
from ..core.queues import HostRequest
from ..core.sim import PEState, SimConfig, WorkerState
from ..core.workloads import Message
from .annotations import loop_only, transition
from .clock import ScaledClock
from .master import Master
from .transport import InProcTransport, Transport

__all__ = ["LivePE", "LiveWorker", "WorkerPool", "live_worker_fits_message"]


def live_worker_fits_message(pes, msg: Message, dims: Tuple[str, ...]) -> bool:
    """Rigid non-CPU gate over a live worker's *busy* PEs."""
    mres = msg.resources
    busy = PEState.BUSY
    for d in dims[1:]:
        need = mres.get(d, 0.0) if mres else 0.0
        committed = 0.0
        for pe in pes:
            pmsg = pe.msg
            if pe.state is busy and pmsg is not None and pmsg.resources:
                committed += pmsg.resources.get(d, 0.0)
        if committed + need > 1.0 + 1e-9:
            return False
    return True


class LivePE:
    """One processing element: state + the asyncio task driving it."""

    __slots__ = ("image", "state", "msg", "idle_since", "estimate", "uid",
                 "task")

    def __init__(self, image: str, estimate, uid: int):
        self.image = image
        self.state = PEState.STARTING
        self.msg: Optional[Message] = None
        self.idle_since = -1.0
        self.estimate = estimate  # size estimate at placement time (scheduled)
        self.uid = uid
        self.task: Optional[asyncio.Task] = None


class LiveWorker:
    """One worker VM: boots with a delay, hosts PE tasks, carries a probe."""

    __slots__ = ("idx", "state", "ready_t", "pes", "probe")

    @transition("worker", "ready", src="booting", dst="active")
    def __init__(self, idx: int, t: float, boot_delay: float):
        self.idx = idx
        self.state = (
            WorkerState.BOOTING if boot_delay > 0 else WorkerState.ACTIVE
        )
        self.ready_t = t + boot_delay
        self.pes: List[LivePE] = []
        self.probe = WorkerProbe()


class WorkerPool:
    """Hosts worker slots; their PEs run wherever the transport puts them."""

    def __init__(
        self,
        cfg: SimConfig,
        master: Master,
        clock: ScaledClock,
        payload,
        poll_interval: float,
        transport: Optional[Transport] = None,
    ):
        self.cfg = cfg
        self.master = master
        self.clock = clock
        self.payload = payload
        # how often a gated (vector-blocked) idle PE re-checks the head,
        # in scenario seconds
        self.poll_interval = poll_interval
        self.transport = transport if transport is not None else InProcTransport()
        self.transport.bind(self)
        self.workers: List[LiveWorker] = []
        self._dims = tuple(cfg.resource_dims)
        self._multi = len(self._dims) > 1
        self._pe_uid = 0
        # Fleet-scale indices, mirroring ``SimCluster``'s: every state
        # transition runs through the pool so per-tick queries
        # (promote_booted, n_alive, pe_count, the lifecycle's anti-churn
        # guard) cost O(transitions), not O(workers).
        #   _booting     idx -> ready_t for exactly the BOOTING workers
        #   _active_idx  sorted indices of ACTIVE workers (ascending scan
        #                order == the old full scan filtered to ACTIVE)
        #   _off_heap    min-heap of OFF slot indices; stale entries (slot
        #                rebooted meanwhile) are discarded lazily on peek
        self._booting: Dict[int, float] = {}
        self._active_idx: List[int] = []
        self._off_heap: List[int] = []
        self._n_alive = 0
        self._pe_total = 0

    # ---- lifecycle hooks (called by Lifecycle / the driver) ----------------
    @loop_only
    @transition("worker", "worker.active", src="booting", dst="active")
    def promote_booted(self, t: float) -> None:
        """BOOTING → ACTIVE once the boot delay has elapsed."""
        if not self._booting:
            return
        due = [idx for idx, rt in self._booting.items() if t >= rt]
        bus = self.master.bus
        for idx in due:
            del self._booting[idx]
            self.workers[idx].state = WorkerState.ACTIVE
            insort(self._active_idx, idx)
            if bus is not None:
                bus.emit("worker.active", worker=idx)

    def n_alive(self) -> int:
        return self._n_alive

    def pe_count(self) -> int:
        return self._pe_total

    def boot_in_flight(self, t: float) -> bool:
        """True while any boot is genuinely pending (BOOTING, delay not
        yet elapsed) — the lifecycle's anti-churn predicate, answered from
        the booting index instead of a pool scan."""
        return any(t < rt for rt in self._booting.values())

    def active_indices(self) -> List[int]:
        """Sorted indices of ACTIVE workers (shared list — don't mutate)."""
        return self._active_idx

    # ---- scaling actuation (called by Lifecycle) ---------------------------
    @loop_only
    @transition("worker", "worker.boot", src="created", dst="booting")
    def add_worker(self, t: float) -> LiveWorker:
        """Append a fresh worker slot and register it in the indices."""
        w = LiveWorker(len(self.workers), t, self.cfg.worker_boot_delay)
        self.workers.append(w)
        self._n_alive += 1
        if w.state is WorkerState.BOOTING:
            self._booting[w.idx] = w.ready_t
        else:  # zero boot delay: born ACTIVE
            insort(self._active_idx, w.idx)
        if self.master.bus is not None:
            self.master.bus.emit("worker.boot", worker=w.idx,
                                 ready_t=w.ready_t)
        # provision the backing resource now so it overlaps the boot delay
        # (a process transport forks here; in-process this is a no-op)
        self.transport.start_worker(w)
        return w

    def lowest_off_slot(self) -> Optional[LiveWorker]:
        """Peek the lowest-index OFF slot without claiming it.

        The returned slot may belong to a *failed* worker — the caller
        decides (a failed lowest slot blocks reuse of higher OFF slots,
        exactly like the old ``next(w for w in workers if OFF)`` scan,
        because it stays at the top of the heap un-popped)."""
        heap = self._off_heap
        while heap:
            w = self.workers[heap[0]]
            if w.state is not WorkerState.OFF:
                heapq.heappop(heap)  # stale: slot was rebooted since
                continue
            return w
        return None

    @loop_only
    @transition("worker", "worker.boot", src="off", dst="booting")
    def reboot_slot(self, w: LiveWorker, ready_t: float) -> None:
        """OFF → BOOTING on a slot returned by ``lowest_off_slot``."""
        assert self._off_heap and self._off_heap[0] == w.idx
        heapq.heappop(self._off_heap)
        w.state = WorkerState.BOOTING
        w.ready_t = ready_t
        self._booting[w.idx] = ready_t
        self._n_alive += 1
        if self.master.bus is not None:
            self.master.bus.emit("worker.boot", worker=w.idx,
                                 ready_t=ready_t)
        self.transport.start_worker(w)

    @loop_only
    @transition("worker", "worker.deactivate", src="active", dst="off")
    def deactivate(self, w: LiveWorker) -> None:
        """ACTIVE → OFF (scale-down of an empty worker)."""
        w.state = WorkerState.OFF
        self._active_idx.remove(w.idx)
        heapq.heappush(self._off_heap, w.idx)
        self._n_alive -= 1
        if self.master.bus is not None:
            self.master.bus.emit("worker.deactivate", worker=w.idx)
        self.transport.stop_worker(w)

    @loop_only
    @transition("worker", "worker.kill", src="booting|active", dst="off",
                failing=True)
    def kill_worker(self, idx: int) -> List[Message]:
        """Abruptly terminate a worker and harvest the messages it was
        processing.

        The transport does the backend-specific demolition — cancelling
        PE tasks in-process, or SIGKILL + data-channel drain for a worker
        OS process — and returns exactly the in-flight messages that can
        provably never complete (a completion that already reached the
        master wins over harvesting, so a message can never do both).
        Harvest order is PE order, matching the sim's one-by-one
        ``insert(0, m)`` sequence, so the last PE's message ends up
        globally first once requeued.  Everything here runs synchronously
        on the event-loop thread.
        """
        w = self.workers[idx]
        harvested = self.transport.kill_worker(w)
        # any PE still listed belongs to the corpse: settle the count here
        # (an in-process cancelled task's ``finally`` finds the emptied
        # ``pes`` list and skips its own removal)
        self._pe_total -= len(w.pes)
        w.pes = []
        if w.state is not WorkerState.OFF:
            if w.state is WorkerState.ACTIVE:
                self._active_idx.remove(idx)
            else:  # BOOTING victim
                self._booting.pop(idx, None)
            self._n_alive -= 1
            heapq.heappush(self._off_heap, idx)
        w.state = WorkerState.OFF
        return harvested

    # ---- placement actuation ----------------------------------------------
    @loop_only
    @transition("pe", "pe.spawn", src="created", dst="starting")
    def try_start_pe(self, req: HostRequest) -> bool:
        """Start a PE on the placed worker; False while the VM still boots."""
        idx = req.target_worker
        if idx is None or idx >= len(self.workers):
            return False
        w = self.workers[idx]
        if w.state is not WorkerState.ACTIVE:
            return False  # "a new VM still initializing" (paper V-B.2)
        self._pe_uid += 1
        pe = LivePE(req.image, req.size_estimate, uid=self._pe_uid)
        w.pes.append(pe)
        self._pe_total += 1
        if self.master.bus is not None:
            self.master.bus.emit("pe.spawn", worker=idx, pe=pe.uid,
                                 image=req.image)
        self.transport.spawn_pe(w, pe)
        return True

    # ---- shared gate (both transports' pull paths run through this) --------
    def _gate_ok(self, worker: LiveWorker, msg: Message) -> bool:
        return not self._multi or live_worker_fits_message(
            worker.pes, msg, self._dims
        )

    # ---- shutdown ----------------------------------------------------------
    async def shutdown(self) -> None:
        """Tear down every PE/worker the transport still hosts."""
        await self.transport.close()

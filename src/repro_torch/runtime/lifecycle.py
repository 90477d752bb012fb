"""Worker lifecycle actuator: executes the IRM's scale decisions live.

``Lifecycle.scale_workers`` is the live counterpart of the simulator's
worker pool management and follows the same rules, so a packing run's
``target_workers`` produces the same pool trajectory on both backends:

  - the target is advisory and capped at ``max_workers`` (the paper's
    5-VM SNIC quota) — ``requested_target`` keeps the uncapped ask so
    Fig. 10's "IRM keeps requesting beyond the cap" behavior is visible;
  - scale-up reuses the lowest OFF slot before appending a new worker —
    unless that slot belongs to a *failed* worker (the sim never reboots
    a dead VM; the IRM routes around it instead); either way the worker
    boots with ``worker_boot_delay`` before it can host PEs (placements
    on it fail and TTL-requeue meanwhile);
  - scale-down deactivates only ACTIVE workers with *no* PEs, highest
    index first — PEs are never evicted, they idle out on their own.

``Lifecycle.kill_worker`` is the live port of the sim's ``fail_worker_at``
failure: the victim's PE tasks are cancelled, their in-flight messages
harvested and requeued at the master's queue head (``Master.requeue``:
negative-sequence front insert, at-least-once), and the slot is marked
failed so scale-up never resurrects it.  Placements already targeting the
dead worker fail ``try_start_pe`` and TTL-requeue through the container
queue — the paper's V-B.2 recovery loop, unchanged.
"""

from __future__ import annotations

from typing import Set

from ..core.sim import SimConfig
from .annotations import loop_only, transition
from .clock import ScaledClock
from .worker import WorkerPool

__all__ = ["Lifecycle"]


class Lifecycle:
    """Spawns and retires live workers on the IRM's packing decisions."""

    def __init__(self, pool: WorkerPool, cfg: SimConfig, clock: ScaledClock):
        self.pool = pool
        self.cfg = cfg
        self.clock = clock
        self.requested_target = 0
        self.failed: Set[int] = set()
        # The control tick this actuator is executing in.  The driver sets
        # it to the nominal tick time before each ``IRM.step`` — the same
        # time base ``promote_booted`` runs on — so boot stamps and the
        # anti-churn guard below can never disagree with boot promotion
        # when the event loop falls behind wall clock (the real scaled
        # clock may run ahead of the nominal tick under load).  The sim
        # stamps ``ready_t`` with tick time for the same reason.
        self.nominal_t = 0.0

    @loop_only
    @transition("worker", "worker.kill", src="booting|active", dst="off",
                failing=True)
    def kill_worker(self, idx: int) -> int:
        """Inject a worker failure; returns how many messages requeued.

        Mirrors ``SimCluster._inject_failure``: in-flight messages bounce
        back to the queue head one by one (the last PE's message ends up
        globally first), the worker goes OFF, and its slot is excluded
        from future scale-ups.  Idempotent: a second kill of the same
        slot is a no-op, as in the sim.
        """
        if not 0 <= idx < len(self.pool.workers) or idx in self.failed:
            return 0
        n_pes = len(self.pool.workers[idx].pes)
        harvested = self.pool.kill_worker(idx)
        self.failed.add(idx)
        for m in harvested:
            self.pool.master.requeue(m)
        bus = self.pool.master.bus
        if bus is not None:
            bus.emit("worker.kill", worker=idx, pes=n_pes,
                     requeued=len(harvested))
        return len(harvested)

    @loop_only
    def scale_workers(self, target: int) -> None:
        self.requested_target = target
        cfg = self.cfg
        pool = self.pool
        t = self.nominal_t
        capped = min(target, cfg.max_workers)
        n_alive = pool.n_alive()
        # boot additional workers: reuse the lowest OFF slot unless it is
        # a failed one (a dead lowest slot blocks reuse, matching the old
        # lowest-index scan — the pool never reboots past a corpse)
        while n_alive < capped:
            slot = pool.lowest_off_slot()
            if slot is not None and slot.idx not in self.failed:
                pool.reboot_slot(slot, t + cfg.worker_boot_delay)
            else:
                pool.add_worker(t)
            n_alive += 1
        # Deactivate empty workers above the target (highest index first).
        # Live-only anti-churn guard: scale-down is deferred while a boot
        # is genuinely in flight (BOOTING and younger than the boot
        # delay).  Boot completions are asynchronous here, so a packing
        # run can observe "5 alive, target 4" while four of the five are
        # still initializing and the only ACTIVE worker is the empty one —
        # deactivating it would park the whole pool behind a phantom bin
        # (placements First-Fit into the OFF slot and fail until TTL
        # death).  The tick-synchronized simulator cannot reach that
        # interleaving, so this guard does not diverge from it on any
        # pinned scenario; it only suppresses the live-concurrency race.
        # The age check keeps the guard honest under failure injection: a
        # BOOTING slot whose delay has already elapsed (a stale boot — it
        # will be promoted or was orphaned by a kill) must not pin the
        # pool at max size forever.
        if n_alive > capped and not pool.boot_in_flight(t):
            workers = pool.workers
            # descending active indices == the old reversed full scan
            # filtered to ACTIVE; copy because deactivate() mutates it
            for idx in reversed(list(pool.active_indices())):
                if n_alive <= capped:
                    break
                w = workers[idx]
                if not w.pes:
                    pool.deactivate(w)
                    n_alive -= 1

"""The typed event bus: one in-memory sink for every backend's events.

An :class:`EventBus` is handed to a backend driver (``simulate``,
``run_live``) and threaded — always behind an ``if bus is not None`` guard
so the un-observed hot paths stay untouched — to every site where a
message, worker, PE, or packing decision changes state.  ``emit`` is a
dict append: no I/O, no locks, no blocking primitives, so it is safe to
call from ``@loop_only`` code and from ``async`` bodies (R1/R2 clean by
construction).

Every event carries the same envelope:

- ``ev``   — the event type (``msg.completed``, ``irm.pack``, ...)
- ``seq``  — bus-local monotone sequence number (total order of emission)
- ``t``    — the emitting backend's current time: the scaled wall clock
  on the live runtime, the tick time in the sim
- ``tick`` — the last *nominal* control tick ``n*dt``, set by the driver
  each loop iteration; this is the time base IRM gating uses, so events
  can be joined against packing runs exactly

plus per-type payload fields.  The payload schema of every event type is
pinned in ``event_manifest.json`` and enforced two ways: rule R6 of
``repro-analyze`` checks each ``bus.emit`` call site against the manifest
at AST level, and the schema-equality test asserts all three backends
emit identical field sets at runtime.

Levels: ``"full"`` records everything including the IRM decision audit;
``"lifecycle"`` drops the (comparatively bulky) ``irm.pack`` events and
the allocator's audit capture, keeping only message/worker/PE lifecycle.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from .metrics import MetricsRegistry

#: Envelope fields stamped by the bus itself on every event; everything
#: else in an event dict is that type's payload.
ENVELOPE_FIELDS = ("ev", "seq", "t", "tick")

LEVELS = ("lifecycle", "full")


class EventBus:
    """Ordered in-memory event sink plus the master's metrics registry."""

    def __init__(self, level: str = "full",
                 now: Optional[Callable[[], float]] = None) -> None:
        if level not in LEVELS:
            raise ValueError(f"obs level must be one of {LEVELS}, "
                             f"got {level!r}")
        self.level = level
        self.events: List[dict] = []
        self.registry = MetricsRegistry()
        #: last nominal control tick; drivers update this each loop pass
        self.tick = 0.0
        self.seq = 0
        #: time source for the ``t`` stamp; ``None`` falls back to the
        #: nominal tick (the sim's time base).  The live driver points
        #: this at ``ScaledClock.now`` and the engine clears it at
        #: finalize so results stay picklable.
        self.now = now

    @property
    def audit(self) -> bool:
        """Whether IRM decision-audit capture is on at this level."""
        return self.level == "full"

    def emit(self, ev: str, **fields) -> None:
        t = self.now() if self.now is not None else self.tick
        e = {"ev": ev, "seq": self.seq, "t": t, "tick": self.tick}
        e.update(fields)
        self.events.append(e)
        self.seq += 1

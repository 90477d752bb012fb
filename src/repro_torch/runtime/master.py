"""Live master: asyncio message broker with per-image FIFO queues.

The HarmonicIO master holds the stream backlog and hands messages directly
to idle PEs (P2P): a PE of image ``i`` asks for work and receives the
*globally first* queued message of that image.  This module reproduces the
master as an in-process asyncio broker with exactly the simulator's queue
structure — per-image FIFO deques keyed by a global arrival sequence number
(front re-inserts take decreasing negative numbers, i.e. ``insert(0, m)``
semantics) — so backlog observations (`queue_length`, `queue_image_mix`,
``backlog_head``) are defined identically on both backends.

Handoff is pull-based: PEs call ``pull`` (synchronous, single-threaded on
the event loop, so no locks) and park on a per-image ``asyncio.Event``
while their queue is empty.  Completion tracking lives here too: the
driver awaits ``drained`` instead of polling.  A pulled message is *in
flight* until it is either completed or requeued (worker failure) — the
drain check requires that count to hit zero, so a backlog that happens to
be empty while PEs still hold messages can never end the run early.
"""

from __future__ import annotations

import asyncio
import heapq
from collections import deque
from itertools import islice
from typing import Deque, Dict, List, Optional, Tuple

from ..core.workloads import Message
from .annotations import transition

__all__ = ["Master"]


class Master:
    """In-process asyncio broker: the live runtime's stream master."""

    def __init__(self, total_expected: int = 0, bus=None):
        # optional observability event bus; everything that holds a master
        # (pool, transports, lifecycle) reads it from here
        self.bus = bus
        self._img_queues: Dict[str, Deque[Tuple[int, Message]]] = {}
        self._qlen = 0
        self._seq_back = 0
        self._seq_front = 0
        self._events: Dict[str, asyncio.Event] = {}
        self.total_expected = int(total_expected)
        self.completed: List[Message] = []
        self.max_done_t = 0.0
        self.arrivals_closed = False
        self.drained = asyncio.Event()
        # messages pulled by a PE but neither completed nor requeued yet
        self.in_flight = 0
        # messages harvested from failed workers and re-inserted at the head
        self.requeued = 0

    # ---- enqueue ----------------------------------------------------------
    def _event(self, image: str) -> asyncio.Event:
        ev = self._events.get(image)
        if ev is None:
            ev = self._events[image] = asyncio.Event()
        return ev

    @transition("msg", "msg.enqueued", src="created", dst="enqueued")
    def push_back(self, m: Message) -> None:
        """Normal arrival: append in global FIFO order."""
        self._seq_back += 1
        dq = self._img_queues.get(m.image)
        if dq is None:
            dq = self._img_queues[m.image] = deque()
        dq.append((self._seq_back, m))
        self._qlen += 1
        self._event(m.image).set()
        if self.bus is not None:
            self.bus.emit("msg.enqueued", msg_id=m.msg_id, image=m.image,
                          arrival=m.arrival)

    def push_front(self, m: Message) -> None:
        """Head re-insert (failure requeue): ``list.insert(0, m)`` semantics."""
        self._seq_front -= 1
        dq = self._img_queues.get(m.image)
        if dq is None:
            dq = self._img_queues[m.image] = deque()
        dq.appendleft((self._seq_front, m))
        self._qlen += 1
        self._event(m.image).set()

    @transition("msg", "msg.requeued", src="pulled|started", dst="requeued")
    def requeue(self, m: Message) -> None:
        """Return an in-flight message to the queue head (worker failure).

        The simulator's at-least-once path: the message loses its start
        stamp, re-enters at the head with a decreasing negative sequence
        number, and stops counting as in flight.  ``requeued`` keeps the
        accounting the fault-parity suite compares across backends.
        """
        m.start_t = -1.0
        self.push_front(m)
        self.in_flight -= 1
        self.requeued += 1
        if self.bus is not None:
            self.bus.emit("msg.requeued", msg_id=m.msg_id, image=m.image)

    def close_arrivals(self) -> None:
        """No further pushes will come; enables drain detection."""
        self.arrivals_closed = True
        self._check_drained()

    # ---- backlog observation (identical shape to SimCluster) --------------
    def queue_length(self) -> float:
        return float(self._qlen)

    def _image_heads(self) -> List[Tuple[int, str, int]]:
        """(head seq, image, queued count) per non-empty image queue,
        sorted by each image's first occurrence in global FIFO order —
        the IRM's apportionment breaks ties by this order, same as the
        sim backend."""
        return sorted(
            (dq[0][0], img, len(dq))
            for img, dq in self._img_queues.items()
            if dq
        )

    def queue_image_mix(self) -> Dict[str, float]:
        if self._qlen == 0:
            return {}
        n = float(self._qlen)
        return {img: cnt / n for _, img, cnt in self._image_heads()}

    def backlog_head(self, k: int) -> List[Message]:
        """The first ``k`` queued messages in global FIFO order."""
        if self._qlen == 0 or k <= 0:
            return []
        live = [iter(dq) for dq in self._img_queues.values() if dq]
        if len(live) == 1:
            return [m for _, m in islice(live[0], k)]
        return [m for _, m in islice(heapq.merge(*live), k)]

    def backlog_image_counts(self, k: int) -> List[Tuple[str, int]]:
        """Per-image counts of the first ``min(k, len)`` backlog messages.

        Ordered by each image's first occurrence in global FIFO order (the
        same insertion order as ``queue_image_mix``).  While the whole
        backlog fits in ``k`` — the steady-state case — the per-image
        deque lengths (maintained O(1) by every push/pull/requeue) answer
        directly, O(images) instead of a k-message scan; only a deeper
        backlog walks sequence numbers, and even then no per-message
        estimate lookups happen downstream.
        """
        if self._qlen == 0 or k <= 0:
            return []
        if self._qlen <= k:
            return [(img, cnt) for _, img, cnt in self._image_heads()]
        counts: Dict[str, int] = {}
        for m in self.backlog_head(k):
            counts[m.image] = counts.get(m.image, 0) + 1
        return list(counts.items())

    # ---- P2P handoff ------------------------------------------------------
    def head(self, image: str) -> Optional[Message]:
        """Peek this image's FIFO head (head-blocking gates inspect it)."""
        dq = self._img_queues.get(image)
        return dq[0][1] if dq else None

    def pull(self, image: str) -> Optional[Message]:
        """Pop this image's FIFO head; clears the wakeup when it empties."""
        dq = self._img_queues.get(image)
        if not dq:
            return None
        _, m = dq.popleft()
        self._qlen -= 1
        self.in_flight += 1
        if not dq:
            self._event(image).clear()
        return m

    async def wait_for_work(self, image: str, wall_timeout: float) -> None:
        """Park until a message of ``image`` arrives or the timeout passes."""
        ev = self._event(image)
        try:
            await asyncio.wait_for(ev.wait(), max(wall_timeout, 0.0))
        except asyncio.TimeoutError:
            pass

    # ---- completion -------------------------------------------------------
    def complete(self, msg: Message) -> None:
        self.completed.append(msg)
        self.in_flight -= 1
        if msg.done_t > self.max_done_t:
            self.max_done_t = msg.done_t
        self._check_drained()

    def _check_drained(self) -> None:
        # ``in_flight == 0`` is load-bearing: with ``total_expected``
        # unset (0) the completed-count condition is vacuously true, and
        # an empty backlog alone does not mean the work is done — pulled
        # messages live at PEs (or, during a worker kill, briefly in the
        # harvester's hands) without being queued anywhere.
        if (
            self.arrivals_closed
            and self._qlen == 0
            and self.in_flight == 0
            and len(self.completed) >= self.total_expected
        ):
            self.drained.set()

"""Container queue and allocation queue (paper Sections V-B.1 / V-B.2).

``ContainerQueue`` — FIFO queue of container hosting requests.  Each request
carries the container image name, a time-to-live (TTL) counter used when a
request is requeued following a failed hosting attempt, and the current
profiled size estimate.  While waiting, requests are periodically updated with
metric changes (``refresh_estimates``) and finally consumed by the periodic
bin-packing run.  The queue holds both auto-scaling requests (from the load
predictor) and manual hosting requests from users.

``AllocationQueue`` — placement orders produced by a bin-packing run, each
with the destination worker attached.  As orders are consumed the allocator
attempts to start the PE on the destination worker; on failure (e.g. the
target worker is a new VM still initializing) the target info is stripped and
the request is sent back to the container queue with its TTL decremented —
this TTL-requeue loop is the paper's fault-tolerance mechanism and is reused
verbatim for failed-worker handling in the serving engine.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any, Callable, Deque, Iterator, List, Optional

from .profiler import MasterProfiler
from .resources import ResourceLike

__all__ = ["HostRequest", "ContainerQueue", "AllocationQueue"]

_req_ids = itertools.count()


@dataclasses.dataclass
class HostRequest:
    """A request to host one PE container of class ``image``.

    ``size_estimate`` is the profiled size the bin-packing run uses: a plain
    float (the paper's CPU fraction) or a ``Resources`` vector on a
    multi-resource cluster.  ``refresh_estimates`` keeps it in whichever
    shape the profiler currently produces.
    """

    image: str
    size_estimate: ResourceLike = 0.5
    ttl: int = 3
    target_worker: Optional[int] = None
    enqueue_time: float = 0.0
    source: str = "autoscale"  # "autoscale" | "user" | "failover"
    req_id: int = dataclasses.field(default_factory=lambda: next(_req_ids))
    meta: dict = dataclasses.field(default_factory=dict)

    def strip_target(self) -> "HostRequest":
        """Remove placement info before a TTL requeue (paper V-B.2)."""
        self.target_worker = None
        return self


class ContainerQueue:
    """FIFO queue of host requests with TTL-based drop accounting."""

    def __init__(self) -> None:
        self._q: Deque[HostRequest] = deque()
        self.dropped: List[HostRequest] = []

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self) -> Iterator[HostRequest]:
        return iter(self._q)

    def push(self, req: HostRequest) -> bool:
        """Enqueue; returns False (and records the drop) if TTL is exhausted."""
        if req.ttl <= 0:
            self.dropped.append(req)
            return False
        self._q.append(req)
        return True

    def requeue(self, req: HostRequest) -> bool:
        """TTL-decrement requeue after a failed hosting attempt."""
        req.ttl -= 1
        return self.push(req.strip_target())

    def refresh_estimates(self, profiler: MasterProfiler) -> None:
        """Propagate updated profile averages to waiting requests."""
        for req in self._q:
            req.size_estimate = profiler.estimate(req.image)

    def drain(self, limit: Optional[int] = None) -> List[HostRequest]:
        """Consume up to ``limit`` requests (FIFO) for a bin-packing run."""
        n = len(self._q) if limit is None else min(limit, len(self._q))
        return [self._q.popleft() for _ in range(n)]

    def push_front(self, reqs: List[HostRequest]) -> None:
        """Return unplaced requests to the head, preserving FIFO order."""
        for req in reversed(reqs):
            self._q.appendleft(req)


class AllocationQueue:
    """Placement orders (request + destination worker) awaiting execution."""

    def __init__(self) -> None:
        self._q: Deque[HostRequest] = deque()

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self) -> Iterator[HostRequest]:
        return iter(self._q)

    def push(self, req: HostRequest) -> None:
        if req.target_worker is None:
            raise ValueError("allocation queue requires a destination worker")
        self._q.append(req)

    def refresh_estimates(self, profiler: MasterProfiler) -> None:
        for req in self._q:
            req.size_estimate = profiler.estimate(req.image)

    def consume(
        self,
        try_start: Callable[[HostRequest], bool],
        on_fail: Callable[[HostRequest], Any],
    ) -> int:
        """Attempt every queued placement; returns the number started.

        ``try_start(req)`` must return True if the PE was started on
        ``req.target_worker``.  Failures are passed to ``on_fail`` (normally
        ``ContainerQueue.requeue``).
        """
        started = 0
        pending = len(self._q)
        for _ in range(pending):
            req = self._q.popleft()
            if try_start(req):
                started += 1
            else:
                on_fail(req)
        return started

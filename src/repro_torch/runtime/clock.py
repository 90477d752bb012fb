"""Scaled virtual clock for the live runtime.

The live runtime executes on the asyncio event loop in *wall-clock* time,
but every scenario, delay, and IRM threshold in this repo is expressed in
*scenario seconds* (the paper's SNIC-testbed time base).  ``ScaledClock``
maps between the two: one scenario second costs ``time_scale`` wall
seconds, so a 60-scenario-second smoke run with ``time_scale=0.02``
finishes in ~1.2 s of wall time while keeping every *relative* delay —
worker boot vs. PE start vs. message service time — exactly as configured.

All runtime components speak scenario seconds; only ``sleep``/``wait``
touch the wall.  This is the same trick HarmonicIO-style benchmark
harnesses use to compress hours-long streams into CI-sized runs without
changing the scheduling dynamics under test.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional, Tuple

__all__ = ["ScaledClock"]


class ScaledClock:
    """Virtual time over the running asyncio loop.

    ``now()`` returns scenario seconds since ``start()``; ``sleep(d)``
    suspends the calling task for ``d`` scenario seconds (``d *
    time_scale`` wall seconds).  Must be started inside a running loop.
    """

    def __init__(self, time_scale: float = 0.02):
        if time_scale <= 0:
            raise ValueError(f"time_scale must be positive, got {time_scale}")
        self.time_scale = float(time_scale)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._t0: float = 0.0
        self._mono0: float = 0.0

    def start(self) -> None:
        """Anchor virtual t=0 at the current loop time."""
        self._loop = asyncio.get_running_loop()
        self._t0 = self._loop.time()
        # cross-process anchor: CLOCK_MONOTONIC is system-wide, so a worker
        # OS process can reconstruct this clock from (mono0, time_scale)
        # and stamp messages on the same scenario time base (see
        # ``transport.MultiprocTransport``)
        self._mono0 = time.monotonic()

    def anchor(self) -> Tuple[float, float]:
        """(monotonic t=0, time_scale) — enough to rebuild the clock in
        another process via ``(time.monotonic() - mono0) / time_scale``."""
        assert self._loop is not None, "ScaledClock.start() not called"
        return self._mono0, self.time_scale

    def now(self) -> float:
        """Scenario seconds elapsed since ``start()``."""
        assert self._loop is not None, "ScaledClock.start() not called"
        return (self._loop.time() - self._t0) / self.time_scale

    def to_wall(self, virtual_seconds: float) -> float:
        """Convert a scenario-seconds interval to wall seconds."""
        return virtual_seconds * self.time_scale

    async def sleep(self, virtual_seconds: float) -> None:
        """Suspend for ``virtual_seconds`` scenario seconds (>=0 yields)."""
        if virtual_seconds > 0:
            await asyncio.sleep(virtual_seconds * self.time_scale)
        else:
            await asyncio.sleep(0)

    async def sleep_until(self, virtual_t: float) -> None:
        """Sleep until the virtual clock reads ``virtual_t`` (no-op if past)."""
        await self.sleep(virtual_t - self.now())

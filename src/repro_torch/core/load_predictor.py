"""Load predictor (paper Section V-B.4).

Tracks the pressure of streaming requests by watching the master message
queue length and its rate of change (ROC).  Four threshold cases decide
between a *large* and a *small* increase in PEs:

    case 1: ROC >= roc_high   OR queue >= queue_high   -> large increase
    case 2: ROC >= roc_low    AND queue >= queue_low   -> large increase
    case 3: ROC >= roc_low    (queue moderate)         -> small increase
    case 4: queue >= queue_low (ROC moderate)          -> small increase

i.e. "if the ROC is very large or the queue is very long, this indicates that
data streams are not processed fast enough" (paper).  Queue metrics are read
periodically, and after scheduling more PEs there is a cooldown timeout before
the predictor reads them again — scheduling PEs ahead of need "gives HIO time
to set up additional workers and reduces the congestion".

Multi-resource mode: when the cluster reports the backlog's aggregate
resource demand (a ``Resources`` vector), the predictor scales the queue
pressure on the *bottleneck dimension*.  A backlog whose dominant demand is
memory (or accelerator) represents proportionally more worker-opening
pressure than its message count alone suggests, so the effective queue
length is ``queue_len * (dominant utilization / cpu utilization)`` and the
ROC is tracked on that effective pressure.  With no demand vector (the
scalar paper path) the math is bit-for-bit unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .resources import Resources

__all__ = ["LoadPredictorConfig", "LoadPredictor", "ScaleDecision"]


@dataclasses.dataclass
class LoadPredictorConfig:
    # queue-length thresholds (messages)
    queue_low: float = 8.0
    queue_high: float = 64.0
    # rate-of-change thresholds (messages / second)
    roc_low: float = 1.0
    roc_high: float = 8.0
    # scale-up magnitudes (number of PEs queued)
    small_increase: int = 2
    large_increase: int = 8
    # how often queue metrics are read (seconds)
    read_interval: float = 1.0
    # timeout after a scale-up before metrics are read again (seconds)
    cooldown: float = 5.0


@dataclasses.dataclass
class ScaleDecision:
    num_pes: int
    case: int  # 0 = no action, 1..4 as documented above
    roc: float
    queue_len: float
    # effective pressure the thresholds saw (== queue_len on the scalar path)
    pressure: float = 0.0
    # the backlog's dominant resource dimension ("cpu" when scalar)
    bottleneck: str = "cpu"


class LoadPredictor:
    """Queue-pressure-driven PE scale-up decisions."""

    def __init__(self, config: Optional[LoadPredictorConfig] = None):
        self.config = config or LoadPredictorConfig()
        self._last_read_t: Optional[float] = None
        self._last_len: Optional[float] = None
        self._cooldown_until: float = -1.0

    def reset(self) -> None:
        self._last_read_t = None
        self._last_len = None
        self._cooldown_until = -1.0

    @staticmethod
    def effective_pressure(
        queue_len: float,
        demand: Optional[Resources],
        capacity: Optional[Resources] = None,
    ) -> Tuple[float, str]:
        """(effective queue pressure, bottleneck dimension).

        ``demand`` is the backlog's aggregate resource demand in
        worker-capacity fractions.  When its dominant dimension is not CPU,
        the message count understates how many workers the backlog will
        open, so pressure is scaled by ``util_dominant / util_cpu``.
        Returns ``queue_len`` unchanged on the scalar path (``demand`` is
        None or 1-D).
        """
        if demand is None or len(demand.dims) <= 1:
            return queue_len, "cpu"
        if capacity is not None:
            caps = capacity.align(demand.dims).values
        else:
            caps = np.ones(len(demand.dims))
        util = demand.values / np.maximum(caps, 1e-12)
        i = int(util.argmax())
        bottleneck = demand.dims[i]
        ref = float(util[0])
        if i == 0 or ref <= 1e-12 or float(util[i]) <= ref:
            return queue_len, bottleneck
        return queue_len * float(util[i]) / ref, bottleneck

    def update(
        self,
        t: float,
        queue_len: float,
        demand=None,
        capacity: Optional[Resources] = None,
    ) -> ScaleDecision:
        """Periodic read of queue metrics; returns the scale-up decision.

        ``t`` is the current (simulated or wall) time in seconds.  Returns a
        decision with ``num_pes == 0`` while within the read interval or the
        post-scale-up cooldown.  ``demand``/``capacity`` enable the
        bottleneck-dimension scaling documented in ``effective_pressure``;
        ``demand`` may be a ``Resources``, ``None``, or a zero-arg callable
        returning either — a callable is only evaluated on ticks that pass
        the read-interval/cooldown gates, so the (possibly expensive)
        backlog scan never runs on gated ticks.  Gated noop decisions
        therefore report ``pressure == queue_len``.
        """
        cfg = self.config

        if t < self._cooldown_until or (
            self._last_read_t is not None
            and (t - self._last_read_t) < cfg.read_interval
        ):
            return ScaleDecision(0, 0, 0.0, queue_len, pressure=queue_len)

        if callable(demand):
            demand = demand()
        pressure, bottleneck = self.effective_pressure(queue_len, demand, capacity)

        roc = 0.0
        if self._last_read_t is not None and t > self._last_read_t:
            roc = (pressure - self._last_len) / (t - self._last_read_t)
        self._last_read_t = t
        self._last_len = pressure

        case, num = 0, 0
        if roc >= cfg.roc_high or pressure >= cfg.queue_high:
            case, num = 1, cfg.large_increase
        elif roc >= cfg.roc_low and pressure >= cfg.queue_low:
            case, num = 2, cfg.large_increase
        elif roc >= cfg.roc_low:
            case, num = 3, cfg.small_increase
        elif pressure >= cfg.queue_low:
            case, num = 4, cfg.small_increase

        if num > 0:
            self._cooldown_until = t + cfg.cooldown
        return ScaleDecision(num_pes=num, case=case, roc=roc,
                             queue_len=queue_len, pressure=pressure,
                             bottleneck=bottleneck)

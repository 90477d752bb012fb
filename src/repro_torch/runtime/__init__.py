"""Live streaming runtime: a real asyncio master/worker backend for the IRM.

The third ``ClusterView`` implementation (after the discrete-event
simulator): an in-process but genuinely concurrent
master/worker system — per-image FIFO broker, PE tasks running pluggable
payloads, lifecycle actuation with boot delays — that the *unmodified*
IRM schedules.  ``run_live`` mirrors ``core.sim.simulate`` and returns a
``SimResult``, so every scenario, summary metric, and expectation check
runs on either backend (``run_scenario(..., backend="live")``).

Master↔worker communication goes through an explicit ``Transport``
(``runtime.transport``): ``InProcTransport`` keeps the original
zero-copy asyncio semantics, ``MultiprocTransport`` promotes each worker
to an OS process behind pickled command/data queues
(``run_scenario(..., backend="multiproc")``).
"""

from .clock import ScaledClock
from .lifecycle import Lifecycle
from .live import LiveCluster, RuntimeConfig, run_live
from .master import Master
from .payloads import SleepPayload, TorchPayload, make_payload
from .trace import TraceRecorder
from .transport import (
    InProcTransport,
    MultiprocTransport,
    Transport,
    make_transport,
)
from .worker import LivePE, LiveWorker, WorkerPool

__all__ = [
    "ScaledClock",
    "Lifecycle",
    "LiveCluster",
    "RuntimeConfig",
    "run_live",
    "Master",
    "SleepPayload",
    "TorchPayload",
    "make_payload",
    "TraceRecorder",
    "Transport",
    "InProcTransport",
    "MultiprocTransport",
    "make_transport",
    "LivePE",
    "LiveWorker",
    "WorkerPool",
]

"""Compatibility shim — the generators live in ``scenarios``.

The paper's two workloads (Section VI-A synthetic batches, Section VI-B
microscopy use case) live in ``scenarios.streams`` next to the extended
traffic shapes (bursty, diurnal, heavy-tailed, multi-tenant), and are
registered in the scenario catalogue (``scenarios.registry``).

Import from ``scenarios`` in new code; this module keeps the
``core.workloads`` import path the sim and the runtime use.
"""

from __future__ import annotations

from ..scenarios.streams import (  # noqa: F401
    Message,
    Stream,
    synthetic_workload,
    usecase_workload,
)

__all__ = ["Message", "Stream", "synthetic_workload", "usecase_workload"]

"""Built-in scenarios: the paper's two evaluations plus four extended shapes.

Each registration pins the workload generator to the cluster configuration
the experiment runs on and to the claims it is expected to exhibit.  The
``synthetic`` and ``microscopy`` scenarios reproduce the paper's Section VI
setups bit-for-bit (same generators, same SNIC-testbed sim parameters the
seed benchmarks used); the other four cover the traffic shapes the
elasticity literature says an autoscaler must be judged on: spike trains,
diurnal cycles, heavy tails, and multi-tenant image mixes.

To add a scenario: write a ``(seed, **knobs) -> Stream`` generator (or
import one from ``streams``), decorate it with ``@register_scenario``, and
give it a ``smoke_overrides`` so tests and CI can run it in seconds.  See
docs/ARCHITECTURE.md for the full authoring guide.
"""

from __future__ import annotations

import numpy as np

from ..core.irm import IRMConfig
from ..core.sim import SimConfig, SimResult
from .engine import ACTIVE_THRESHOLD
from .registry import Expectation, register_scenario
from . import streams

__all__ = ["PAPER_SIM", "PAPER_SIM_USECASE", "MEM_SIM", "ACCEL_SIM",
           "VECTOR_IRM"]


def PAPER_SIM() -> SimConfig:
    """The SNIC testbed model used for the paper's synthetic runs."""
    return SimConfig(
        dt=0.5, cores_per_worker=8, max_workers=5,
        worker_boot_delay=15.0, pe_start_delay=2.5,
        container_idle_timeout=1.0, report_interval=1.0,
        t_max=1500.0, seed=0,
    )


def PAPER_SIM_USECASE() -> SimConfig:
    """Same testbed with the use case's longer horizon (767 images)."""
    cfg = PAPER_SIM()
    cfg.t_max = 3600.0
    return cfg


def MEM_SIM() -> SimConfig:
    """The SNIC testbed with a rigid memory dimension per worker."""
    cfg = PAPER_SIM_USECASE()
    cfg.resource_dims = ("cpu", "mem")
    return cfg


def ACCEL_SIM() -> SimConfig:
    """The testbed with one accelerator per worker as a rigid dimension."""
    cfg = PAPER_SIM()
    cfg.resource_dims = ("cpu", "accel")
    return cfg


def VECTOR_IRM() -> IRMConfig:
    """IRM configured for vector bin-packing (paper Sec. VII direction)."""
    cfg = IRMConfig()
    cfg.allocator.algorithm = "vector-first-fit"
    return cfg


# ---------------------------------------------------------------------------
# Shared expectation checks
# ---------------------------------------------------------------------------


def _completes(res: SimResult) -> bool:
    return res.completed == res.total


def _nearly_completes(res: SimResult) -> bool:
    """>= 99% processed.

    The paper's threshold predictor can starve a sub-threshold tail: a
    backlog smaller than ``queue_low`` with ~zero rate-of-change never
    triggers a scale-up (all four cases miss), so the last stragglers of a
    trickle can sit in the queue forever once their PEs idle out.  The
    synthetic run reproduces this faithfully (292/293 at t_max).
    """
    return res.completed >= 0.99 * res.total


def _capacity_respected(res: SimResult) -> bool:
    return bool((res.scheduled_cpu <= 1.0 + 1e-9).all())


def _low_index_concentration(res: SimResult) -> bool:
    """Fig. 3: 'the workload is focused toward the lower index workers'."""
    per_worker = res.scheduled_cpu.sum(axis=0)
    w = len(per_worker)
    return bool(
        per_worker.argmax() == 0
        and per_worker[: w // 2 + 1].sum() > per_worker[w // 2 + 1:].sum()
    )


def _error_centered(res: SimResult) -> bool:
    """Fig. 5: scheduled-vs-measured error is noisy but centered near zero."""
    active = res.scheduled_cpu > ACTIVE_THRESHOLD
    err = res.error[active]
    return bool(abs(err.mean()) < 15.0) if err.size else True


def _workers_filled_before_spill(res: SimResult) -> bool:
    """Fig. 8: a worker opens only when the lower-index ones are ~full."""
    ok = []
    for w in range(1, res.scheduled_cpu.shape[1]):
        started = res.scheduled_cpu[:, w] > ACTIVE_THRESHOLD
        if started.any():
            t_first = int(np.argmax(started))
            ok.append(float(res.scheduled_cpu[t_first, :w].min()) > 0.7)
    return bool(ok and all(ok))


def _target_exceeds_cap(res: SimResult) -> bool:
    """Fig. 10: the IRM keeps requesting workers beyond the cap."""
    return bool(res.target_workers.max() > res.active_workers.max())


def _scales_up_and_down(res: SimResult) -> bool:
    """The pool grows under pressure and shrinks as the backlog drains."""
    peak = int(res.pe_count.max())
    return peak >= 3 and int(res.pe_count[-1]) < peak


def _queue_spikes(res: SimResult) -> bool:
    return bool(res.queue_len.max() >= 8)


def _multiple_images_served(res: SimResult) -> bool:
    return len({m.image for m in res.messages}) >= 3


COMPLETES = Expectation(
    "completes", "every streamed message is processed", _completes
)
CAPACITY = Expectation(
    "capacity_respected", "scheduled load never exceeds worker capacity",
    _capacity_respected,
)


# ---------------------------------------------------------------------------
# The paper's two scenarios (Section VI)
# ---------------------------------------------------------------------------

register_scenario(
    "synthetic",
    "Paper Sec. VI-A: regular small batches + two large peaks, four "
    "single-core job classes (5/10/20/40 s).",
    sim_config=PAPER_SIM,
    tags=("paper", "synthetic"),
    expectations=(
        Expectation(
            "nearly_completes",
            ">= 99% of messages processed (the threshold predictor starves "
            "sub-queue_low tails — faithful paper behavior)",
            _nearly_completes,
        ),
        CAPACITY,
        Expectation(
            "low_index_concentration",
            "Fig. 3: load concentrates on low-index workers",
            _low_index_concentration,
        ),
        Expectation(
            "error_centered",
            "Fig. 5: scheduled-vs-measured error centered near zero",
            _error_centered,
        ),
    ),
    smoke_overrides={
        "t_end": 60.0, "peak_times": (30.0,), "peak_size": 8,
        "batch_size": (2, 4),
    },
    smoke_t_max=600.0,
)(streams.synthetic_workload)


register_scenario(
    "microscopy",
    "Paper Sec. VI-B: 767 CellProfiler microscopy images streamed as one "
    "batch, 10-20 s each; 10 runs with a persistent profiler.",
    sim_config=PAPER_SIM_USECASE,
    n_runs=10,
    tags=("paper", "usecase"),
    expectations=(
        COMPLETES,
        CAPACITY,
        Expectation(
            "workers_filled_before_spill",
            "Fig. 8: workers reach ~100% before the next one opens",
            _workers_filled_before_spill,
        ),
        Expectation(
            "target_exceeds_cap",
            "Fig. 10: the IRM requests more workers than the cap allows",
            _target_exceeds_cap,
        ),
    ),
    smoke_overrides={"n_images": 40, "duration_range": (4.0, 8.0)},
    smoke_t_max=600.0,
)(streams.usecase_workload)


# ---------------------------------------------------------------------------
# Extended traffic shapes
# ---------------------------------------------------------------------------

register_scenario(
    "bursty",
    "Spike trains: a thin Poisson trickle punctuated by large random "
    "bursts — the adversarial case for queue-ROC prediction.",
    sim_config=PAPER_SIM,
    tags=("extended", "bursty"),
    expectations=(
        COMPLETES,
        CAPACITY,
        Expectation(
            "queue_spikes", "bursts show up as backlog spikes", _queue_spikes
        ),
        Expectation(
            "scales_up_and_down",
            "the PE pool grows under a burst and shrinks after",
            _scales_up_and_down,
        ),
    ),
    smoke_overrides={
        "t_end": 60.0, "burst_rate": 1.0 / 30.0, "burst_size": (8, 12),
        "duration_range": (3.0, 8.0),
    },
    smoke_t_max=600.0,
)(streams.bursty_workload)


register_scenario(
    "diurnal",
    "Diurnal sinusoid: arrival rate rides a compressed day/night cycle; "
    "the pool must track the curve without thrashing.",
    sim_config=PAPER_SIM,
    tags=("extended", "diurnal"),
    expectations=(
        COMPLETES,
        CAPACITY,
        Expectation(
            "scales_up_and_down",
            "the PE pool follows the traffic curve up and back down",
            _scales_up_and_down,
        ),
    ),
    smoke_overrides={
        "t_end": 120.0, "period": 60.0, "peak_arrivals_per_s": 0.8,
        "duration_range": (3.0, 8.0),
    },
    smoke_t_max=700.0,
)(streams.diurnal_workload)


register_scenario(
    "heavy-tailed",
    "Pareto service times: most messages quick, a few 10-30x longer — the "
    "stress case for the profiler's mean-based size estimates.",
    sim_config=PAPER_SIM,
    tags=("extended", "heavy-tailed"),
    expectations=(COMPLETES, CAPACITY),
    smoke_overrides={
        "n_messages": 40, "t_end": 60.0, "duration_cap": 30.0,
    },
    smoke_t_max=700.0,
)(streams.heavy_tailed_workload)


# ---------------------------------------------------------------------------
# Multi-resource scenarios (vector bin-packing — paper Sec. VII future work)
# ---------------------------------------------------------------------------


def _dims_capacity_respected(res: SimResult) -> bool:
    """No dimension of any worker is ever scheduled above capacity."""
    if res.scheduled_res is None:
        return False  # a multi-resource scenario must record per-dim loads
    return bool((res.scheduled_res <= 1.0 + 1e-9).all())


def _memory_is_bottleneck(res: SimResult) -> bool:
    """Memory saturates workers while their CPU stays far from full."""
    if res.scheduled_res is None:
        return False
    d = res.resource_dims.index("mem")
    mem = res.scheduled_res[:, :, d]
    cpu = res.scheduled_res[:, :, 0]
    hot = mem > 0.5
    if not hot.any():
        return False
    # wherever memory is half-committed, CPU is never the tighter dimension
    # (<=: the cold-start default estimate is equal in every dimension), and
    # memory carries well over the CPU's total scheduled load
    return bool(
        (cpu[hot] <= mem[hot] + 1e-9).all() and mem.sum() > 1.5 * cpu.sum()
    )


def _accel_and_cpu_colocated(res: SimResult) -> bool:
    """Vector packing co-locates accelerator and CPU tenants on one worker."""
    if res.scheduled_res is None:
        return False
    d = res.resource_dims.index("accel")
    accel = res.scheduled_res[:, :, d]
    cpu = res.scheduled_res[:, :, 0]
    return bool(((accel > 0.2) & (cpu > 0.3)).any())


register_scenario(
    "microscopy-mem",
    "Memory-bound microscopy: each analysis pins 1 core but holds 25-45% "
    "of worker RAM — memory, not CPU, dictates the packing.",
    sim_config=MEM_SIM,
    irm_config=VECTOR_IRM,
    n_runs=3,
    tags=("extended", "vector", "usecase"),
    expectations=(
        COMPLETES,
        CAPACITY,
        Expectation(
            "dims_capacity_respected",
            "no worker dimension is scheduled above capacity",
            _dims_capacity_respected,
        ),
        Expectation(
            "memory_is_bottleneck",
            "memory saturates workers while CPU stays slack",
            _memory_is_bottleneck,
        ),
    ),
    smoke_overrides={"n_images": 30, "duration_range": (4.0, 8.0)},
    smoke_t_max=600.0,
)(streams.microscopy_mem_workload)


register_scenario(
    "mixed-accel",
    "Mixed CPU/accelerator tenants: multi-core ETL jobs interleave with "
    "accelerator-hungry inference — complementary vector items.",
    sim_config=ACCEL_SIM,
    irm_config=VECTOR_IRM,
    tags=("extended", "vector", "multi-tenant"),
    expectations=(
        COMPLETES,
        CAPACITY,
        Expectation(
            "dims_capacity_respected",
            "no worker dimension is scheduled above capacity",
            _dims_capacity_respected,
        ),
        Expectation(
            "accel_and_cpu_colocated",
            "accelerator and CPU tenants share a worker at least once",
            _accel_and_cpu_colocated,
        ),
        Expectation(
            "multiple_images_served",
            "at least three tenant images are processed",
            _multiple_images_served,
        ),
    ),
    smoke_overrides={"t_end": 80.0, "batch_size": (2, 5)},
    smoke_t_max=700.0,
)(streams.mixed_accel_workload)


register_scenario(
    "multi-tenant",
    "Multi-image mix: four tenants with different durations and CPU "
    "draws — the packer must handle genuinely heterogeneous item sizes.",
    sim_config=PAPER_SIM,
    tags=("extended", "multi-tenant"),
    expectations=(
        COMPLETES,
        CAPACITY,
        Expectation(
            "multiple_images_served",
            "at least three tenant images are processed",
            _multiple_images_served,
        ),
    ),
    smoke_overrides={"t_end": 60.0, "batch_size": (2, 5)},
    smoke_t_max=600.0,
)(streams.multi_tenant_workload)

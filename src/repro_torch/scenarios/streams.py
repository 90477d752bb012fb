"""Stream generators for the scenario engine.

The paper evaluates its bin-packing IRM on exactly two workloads: the
Section VI-A synthetic batches and the Section VI-B 767-image microscopy
use case.  The resource-elasticity literature (de Assunção et al.,
1709.01363; Will et al., 2501.14456) shows that autoscaler quality is only
measurable across *diverse* traffic shapes, so this module also provides
bursty spike trains, a diurnal sinusoid, heavy-tailed (Pareto) service
times, and multi-tenant image mixes.

Every generator is a pure function ``(seed, **knobs) -> Stream`` with no
dependency on the rest of the package; the scenario registry
(``scenarios.registry``) wraps them with cluster configs and
expected-behavior assertions.  ``core.workloads`` re-exports the
paper's two generators.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Message",
    "Stream",
    "synthetic_workload",
    "usecase_workload",
    "bursty_workload",
    "diurnal_workload",
    "heavy_tailed_workload",
    "multi_tenant_workload",
    "microscopy_mem_workload",
    "mixed_accel_workload",
]

_msg_ids = itertools.count()


@dataclasses.dataclass
class Message:
    """One stream message: data to process + the container image to run.

    ``cpu_cores`` is the CPU draw while processing, in cores; ``duration`` is
    the processing time in seconds.  ``resources`` optionally carries the
    draw on *auxiliary* worker dimensions while busy (e.g. ``{"mem": 0.3}``
    = 30% of a worker's memory), as fractions of one worker; CPU stays in
    ``cpu_cores``.  ``None`` is the paper's scalar CPU-only model.
    """

    image: str
    duration: float
    cpu_cores: float = 1.0
    arrival: float = 0.0
    resources: Optional[Dict[str, float]] = None
    msg_id: int = dataclasses.field(default_factory=lambda: next(_msg_ids))
    # bookkeeping filled in by the sim
    start_t: float = -1.0
    done_t: float = -1.0


@dataclasses.dataclass
class Stream:
    """A time-ordered schedule of message batches."""

    batches: List[Tuple[float, List[Message]]]

    @property
    def num_messages(self) -> int:
        return sum(len(msgs) for _, msgs in self.batches)

    @property
    def images(self) -> List[str]:
        seen: Dict[str, None] = {}
        for _, msgs in self.batches:
            for m in msgs:
                seen.setdefault(m.image, None)
        return list(seen)

    def horizon(self) -> float:
        return max(t for t, _ in self.batches) if self.batches else 0.0


# ---------------------------------------------------------------------------
# The paper's two workloads (Section VI)
# ---------------------------------------------------------------------------


def synthetic_workload(
    seed: int = 0,
    *,
    t_end: float = 480.0,
    batch_interval: float = 12.0,
    batch_size: Tuple[int, int] = (3, 7),
    peak_times: Tuple[float, ...] = (120.0, 330.0),
    peak_size: int = 48,
) -> Stream:
    """Paper Section VI-A: periodic small batches plus two large peaks.

    Four synthetic classes all busy one core at ~100%, with durations
    5 / 10 / 20 / 40 s ("various amounts of time").
    """
    rng = np.random.default_rng(seed)
    classes = [
        ("synthetic/cpu100-d5", 5.0),
        ("synthetic/cpu100-d10", 10.0),
        ("synthetic/cpu100-d20", 20.0),
        ("synthetic/cpu100-d40", 40.0),
    ]

    def make_msgs(n: int, t: float) -> List[Message]:
        idx = rng.integers(0, len(classes), size=n)
        out = []
        for i in idx:
            image, dur = classes[int(i)]
            jitter = float(rng.uniform(0.9, 1.1))
            out.append(
                Message(image=image, duration=dur * jitter, cpu_cores=1.0, arrival=t)
            )
        return out

    batches: List[Tuple[float, List[Message]]] = []
    t = 0.0
    while t < t_end:
        n = int(rng.integers(batch_size[0], batch_size[1] + 1))
        batches.append((t, make_msgs(n, t)))
        t += batch_interval
    for pt in peak_times:
        batches.append((pt, make_msgs(peak_size, pt)))
    batches.sort(key=lambda b: b[0])
    return Stream(batches=batches)


def usecase_workload(
    seed: int = 0,
    *,
    n_images: int = 767,
    duration_range: Tuple[float, float] = (10.0, 20.0),
    image: str = "haste/cellprofiler:3.1.9",
) -> Stream:
    """Paper Section VI-B: the CellProfiler microscopy batch.

    The entire collection is streamed as a single batch; per-image analysis
    takes 10–20 s ("Due to variations in the images they take varying
    amounts of time to process").  The streaming order is randomized per run
    (the ``seed``).
    """
    rng = np.random.default_rng(seed)
    durations = rng.uniform(duration_range[0], duration_range[1], size=n_images)
    rng.shuffle(durations)  # randomized streaming order
    msgs = [
        Message(image=image, duration=float(d), cpu_cores=1.0, arrival=0.0)
        for d in durations
    ]
    return Stream(batches=[(0.0, msgs)])


# ---------------------------------------------------------------------------
# Extended traffic shapes (beyond the paper)
# ---------------------------------------------------------------------------


def bursty_workload(
    seed: int = 0,
    *,
    t_end: float = 480.0,
    trickle_interval: float = 8.0,
    trickle_size: Tuple[int, int] = (1, 3),
    burst_rate: float = 1.0 / 90.0,
    burst_size: Tuple[int, int] = (24, 56),
    burst_times: Optional[Tuple[float, ...]] = None,
    duration_range: Tuple[float, float] = (5.0, 20.0),
    image: str = "bursty/worker",
) -> Stream:
    """Spike trains: a thin Poisson trickle punctuated by large random bursts.

    Bursts arrive as a Poisson process of rate ``burst_rate`` (per second) —
    or at the fixed ``burst_times`` when given (the paper's deterministic
    two-peak shape); each dumps a uniform-random number of messages at once.
    This is the adversarial case for a queue-ROC load predictor: pressure
    jumps from ~0 to tens of messages inside one read interval.
    """
    rng = np.random.default_rng(seed)
    batches: List[Tuple[float, List[Message]]] = []

    def make_msgs(n: int, t: float) -> List[Message]:
        durs = rng.uniform(duration_range[0], duration_range[1], size=n)
        return [
            Message(image=image, duration=float(d), cpu_cores=1.0, arrival=t)
            for d in durs
        ]

    t = 0.0
    while t < t_end:
        n = int(rng.integers(trickle_size[0], trickle_size[1] + 1))
        batches.append((t, make_msgs(n, t)))
        t += trickle_interval
    if burst_times is not None:
        for bt in burst_times:
            n = int(rng.integers(burst_size[0], burst_size[1] + 1))
            batches.append((float(bt), make_msgs(n, float(bt))))
    else:
        # Poisson burst arrivals
        t = float(rng.exponential(1.0 / burst_rate))
        while t < t_end:
            n = int(rng.integers(burst_size[0], burst_size[1] + 1))
            batches.append((t, make_msgs(n, t)))
            t += float(rng.exponential(1.0 / burst_rate))
    batches.sort(key=lambda b: b[0])
    return Stream(batches=batches)


def diurnal_workload(
    seed: int = 0,
    *,
    t_end: float = 600.0,
    period: float = 300.0,
    batch_interval: float = 5.0,
    peak_arrivals_per_s: float = 1.2,
    base_arrivals_per_s: float = 0.1,
    duration_range: Tuple[float, float] = (4.0, 12.0),
    image: str = "diurnal/worker",
) -> Stream:
    """Diurnal sinusoid: arrival rate follows a day/night cycle.

    The per-batch message count is Poisson with mean
    ``base + (peak - base) * (1 + sin) / 2`` integrated over the batch
    interval — a compressed version of the daily traffic curve every
    production autoscaler has to ride without thrashing.
    """
    rng = np.random.default_rng(seed)
    batches: List[Tuple[float, List[Message]]] = []
    t = 0.0
    while t < t_end:
        phase = (1.0 + math.sin(2.0 * math.pi * t / period - math.pi / 2.0)) / 2.0
        rate = base_arrivals_per_s + (peak_arrivals_per_s - base_arrivals_per_s) * phase
        n = int(rng.poisson(rate * batch_interval))
        if n > 0:
            durs = rng.uniform(duration_range[0], duration_range[1], size=n)
            batches.append(
                (
                    t,
                    [
                        Message(image=image, duration=float(d), arrival=t)
                        for d in durs
                    ],
                )
            )
        t += batch_interval
    return Stream(batches=batches)


def heavy_tailed_workload(
    seed: int = 0,
    *,
    n_messages: int = 400,
    t_end: float = 300.0,
    batch_interval: float = 6.0,
    pareto_shape: float = 1.6,
    duration_scale: float = 4.0,
    duration_cap: float = 120.0,
    image: str = "pareto/worker",
) -> Stream:
    """Heavy-tailed service times: Pareto-distributed durations.

    Most messages are quick, a few run 10-30x longer (capped at
    ``duration_cap``).  Mean-based size profiles systematically underestimate
    the tail, so this is the stress case for the profiler's moving average —
    the failure mode the elasticity surveys flag for percentile-blind
    autoscalers.
    """
    rng = np.random.default_rng(seed)
    durations = np.minimum(
        duration_scale * (1.0 + rng.pareto(pareto_shape, size=n_messages)),
        duration_cap,
    )
    n_batches = max(1, int(t_end / batch_interval))
    per_batch = np.array_split(durations, n_batches)
    batches: List[Tuple[float, List[Message]]] = []
    for i, chunk in enumerate(per_batch):
        t = i * batch_interval
        if len(chunk) == 0:
            continue
        batches.append(
            (
                t,
                [
                    Message(image=image, duration=float(d), arrival=t)
                    for d in chunk
                ],
            )
        )
    return Stream(batches=batches)


def microscopy_mem_workload(
    seed: int = 0,
    *,
    n_images: int = 300,
    duration_range: Tuple[float, float] = (10.0, 20.0),
    mem_range: Tuple[float, float] = (0.25, 0.45),
    image: str = "haste/cellprofiler-bigimg:3.1.9",
) -> Stream:
    """Memory-bound microscopy: the use case with large image working sets.

    Each analysis pins one core (a small CPU fraction on an 8-core worker)
    but holds a working set of 25-45% of a worker's memory while busy, so
    *memory* is the dominant dimension: a worker fits ~2-3 concurrent
    analyses by RAM long before its CPU fills.  A CPU-only packer would
    schedule 8 PEs per worker and overcommit memory ~3x; the vector packer
    opens workers on the memory dimension instead.
    """
    rng = np.random.default_rng(seed)
    durations = rng.uniform(duration_range[0], duration_range[1], size=n_images)
    mems = rng.uniform(mem_range[0], mem_range[1], size=n_images)
    rng.shuffle(durations)  # randomized streaming order (as the use case)
    msgs = [
        Message(
            image=image,
            duration=float(d),
            cpu_cores=1.0,
            arrival=0.0,
            resources={"mem": float(mem)},
        )
        for d, mem in zip(durations, mems, strict=True)
    ]
    return Stream(batches=[(0.0, msgs)])


def mixed_accel_workload(
    seed: int = 0,
    *,
    t_end: float = 360.0,
    batch_interval: float = 10.0,
    batch_size: Tuple[int, int] = (3, 8),
    tenants: Sequence[Tuple[str, float, float, float]] = (
        # (image, mean duration s, cpu cores busy, accel fraction busy)
        ("tenant-cpu/etl", 8.0, 4.0, 0.0),
        ("tenant-cpu/report", 5.0, 2.0, 0.0),
        ("tenant-accel/vision", 12.0, 0.8, 0.5),
        ("tenant-accel/asr", 6.0, 0.5, 0.25),
    ),
    tenant_weights: Tuple[float, ...] = (0.35, 0.25, 0.25, 0.15),
) -> Stream:
    """Mixed CPU / accelerator tenants sharing one worker pool.

    CPU tenants draw several cores and no accelerator; accelerator tenants
    draw a large accelerator fraction but little CPU.  The two are
    *complementary*: a vector packer can co-locate one vision job (accel
    0.5, cpu 0.1) with ETL jobs (cpu 0.5, accel 0) on the same worker,
    which no single-dimension formulation can even express.
    """
    rng = np.random.default_rng(seed)
    weights = np.asarray(tenant_weights, dtype=float)
    weights = weights / weights.sum()
    batches: List[Tuple[float, List[Message]]] = []
    t = 0.0
    while t < t_end:
        n = int(rng.integers(batch_size[0], batch_size[1] + 1))
        picks = rng.choice(len(tenants), size=n, p=weights)
        msgs = []
        for p in picks:
            image, mean_dur, cores, accel = tenants[int(p)]
            dur = float(rng.uniform(0.7, 1.3)) * mean_dur
            msgs.append(
                Message(
                    image=image,
                    duration=dur,
                    cpu_cores=cores,
                    arrival=t,
                    resources={"accel": accel} if accel > 0 else None,
                )
            )
        batches.append((t, msgs))
        t += batch_interval
    return Stream(batches=batches)


def multi_tenant_workload(
    seed: int = 0,
    *,
    t_end: float = 360.0,
    batch_interval: float = 10.0,
    batch_size: Tuple[int, int] = (4, 10),
    tenants: Sequence[Tuple[str, float, float]] = (
        # (image, mean duration s, cpu cores while busy)
        ("tenant-a/etl", 6.0, 1.0),
        ("tenant-b/ml-inference", 15.0, 1.0),
        ("tenant-c/thumbnailer", 3.0, 0.5),
        ("tenant-d/video-transcode", 30.0, 2.0),
    ),
    tenant_weights: Tuple[float, ...] = (0.4, 0.3, 0.2, 0.1),
) -> Stream:
    """Multi-image / multi-tenant mix: several container images per batch.

    Each tenant has its own image, mean duration, and CPU draw, so the
    profiler must learn one size per image and the packer must pack items of
    genuinely different sizes — the regime where First-Fit's 1.7 ratio
    actually matters (all-equal items make every Any-Fit algorithm trivial).
    """
    rng = np.random.default_rng(seed)
    weights = np.asarray(tenant_weights, dtype=float)
    weights = weights / weights.sum()
    batches: List[Tuple[float, List[Message]]] = []
    t = 0.0
    while t < t_end:
        n = int(rng.integers(batch_size[0], batch_size[1] + 1))
        picks = rng.choice(len(tenants), size=n, p=weights)
        msgs = []
        for p in picks:
            image, mean_dur, cores = tenants[int(p)]
            dur = float(rng.uniform(0.7, 1.3)) * mean_dur
            msgs.append(
                Message(image=image, duration=dur, cpu_cores=cores, arrival=t)
            )
        batches.append((t, msgs))
        t += batch_interval
    return Stream(batches=batches)

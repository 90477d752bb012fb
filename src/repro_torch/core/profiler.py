"""Worker profiler (paper Section V-B.3).

Two-part design, exactly as in the paper:

  1. ``WorkerProbe`` lives on each worker VM and periodically measures the
     current CPU usage of every running PE, averages per container image, and
     reports the per-image means to the master.
  2. ``MasterProfiler`` aggregates reports from all active workers and keeps a
     moving average over the last N measurements per image (N configurable).
     The average is the *item size* used by the bin-packing manager, and
     updated averages are propagated to requests waiting in the container and
     allocation queues (see ``queues.ContainerQueue.refresh_estimates``).

This is the paper's "run-time learning process" that replaces trained models:
no training data, no fitting — just profiled observations of the running
workloads.  The same class profiles decode-step cost per request class in the
serving engine and per-source document length in the data pipeline.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

from .resources import ResourceLike, Resources, as_resources

__all__ = ["ProfilerConfig", "MasterProfiler", "WorkerProbe", "clamp_estimate"]


def clamp_estimate(est: ResourceLike, config: "ProfilerConfig") -> ResourceLike:
    """Clamp a profiled size into the packer's valid item domain.

    Scalar estimates clamp to [min_size, max_size] exactly as before; vector
    estimates clamp per dimension (CPU keeps the min_size floor so items stay
    in the paper's (0, 1] domain; auxiliary dimensions may be zero).
    """
    if isinstance(est, Resources):
        return est.clamp(config.min_size, config.max_size)
    return min(config.max_size, max(config.min_size, est))


@dataclasses.dataclass
class ProfilerConfig:
    # Number of most-recent measurements in the moving average ("N being
    # arbitrarily configurable" — paper V-B.3).
    window: int = 32
    # Initial guess for a never-before-seen workload class.  The paper notes
    # the first run performs slightly worse while this guess is corrected.
    default_size: float = 0.5
    # Clamp profiled sizes into (0, 1] so they are valid bin-packing items.
    min_size: float = 1e-3
    max_size: float = 1.0


class MasterProfiler:
    """Moving-average profile of resource usage per workload class."""

    def __init__(self, config: Optional[ProfilerConfig] = None):
        self.config = config or ProfilerConfig()
        self._samples: Dict[str, deque] = {}
        self._count: Dict[str, int] = {}
        # Memoized estimates: the moving average only changes when a new
        # measurement arrives (every report_interval), but the simulation
        # hot path queries it for every PE and backlog message every tick —
        # cache per image, invalidate on observe().
        self._est_cache: Dict[str, ResourceLike] = {}
        # None => scalar (the paper's CPU-fraction profile).  Set by a
        # multi-resource cluster so defaults for unseen images are vectors.
        self._dims: Optional[Tuple[str, ...]] = None

    # -- multi-resource mode -------------------------------------------------
    def set_resource_dims(self, dims: Sequence[str]) -> None:
        """Switch default estimates to ``Resources`` over ``dims``.

        A profiler that already holds samples keeps them: scalar samples
        become CPU-only vectors and existing vectors re-align, so a
        persistent IRM (the paper's cross-run profile) can carry its learned
        profile from a scalar cluster onto a multi-resource one without
        mixing floats and vectors inside one moving-average window.
        """
        dims = tuple(dims)
        if dims == self._dims:
            return
        self._dims = dims
        for image, dq in self._samples.items():
            self._samples[image] = deque(
                (as_resources(v, dims) for v in dq), maxlen=dq.maxlen
            )
        self._est_cache.clear()

    @property
    def resource_dims(self) -> Optional[Tuple[str, ...]]:
        return self._dims

    def _default_estimate(self) -> ResourceLike:
        """First-guess size for a never-before-seen workload class."""
        if self._dims is None:
            return self.config.default_size
        return Resources.full(self._dims, self.config.default_size)

    # -- ingest --------------------------------------------------------------
    def observe(self, image: str, value: ResourceLike) -> None:
        """Record one aggregated measurement for a workload class."""
        dq = self._samples.get(image)
        if dq is None:
            dq = deque(maxlen=self.config.window)
            self._samples[image] = dq
            self._count[image] = 0
        dq.append(value if isinstance(value, Resources) else float(value))
        self._count[image] += 1
        self._est_cache.pop(image, None)

    def observe_report(self, report: Mapping[str, ResourceLike]) -> None:
        """Ingest a worker probe report: {image: mean usage on that worker}."""
        for image, value in report.items():
            self.observe(image, value)

    # -- query ---------------------------------------------------------------
    def estimate(self, image: str) -> ResourceLike:
        """Moving-average item size for ``image`` (default guess if unseen)."""
        cached = self._est_cache.get(image)
        if cached is not None:
            return cached
        dq = self._samples.get(image)
        if not dq:
            est = self._default_estimate()
        else:
            est = sum(dq) / len(dq)
        est = clamp_estimate(est, self.config)
        self._est_cache[image] = est
        return est

    def num_observations(self, image: str) -> int:
        return self._count.get(image, 0)

    def known_images(self) -> Tuple[str, ...]:
        return tuple(self._samples)

    def snapshot(self) -> Dict[str, float]:
        return {img: self.estimate(img) for img in self._samples}


class WorkerProbe:
    """Worker-side half: per-PE CPU samples -> per-image means.

    ``sample`` is called at ``report_interval`` (the paper's experiments use
    1 second) with the instantaneous usage of every PE on this worker.
    """

    def __init__(self) -> None:
        # Running (sum, count) per image — bit-identical to accumulating a
        # list and taking sum()/len() at report time (same left-to-right
        # float addition order), without growing per-tick Python lists.
        self._sum: Dict[str, float] = {}
        self._n: Dict[str, int] = {}

    def sample(self, pe_usages: Iterable[Tuple[str, float]]) -> None:
        """Accumulate one round of (image, usage) samples."""
        acc, counts = self._sum, self._n
        for image, usage in pe_usages:
            if image in acc:
                acc[image] += float(usage)
                counts[image] += 1
            else:
                acc[image] = float(usage)
                counts[image] = 1

    def accumulators(self) -> Tuple[Dict[str, float], Dict[str, int]]:
        """The live (sum, count) dicts — the simulation's per-PE fast path.

        Callers may accumulate into these directly (same semantics as one
        ``sample()`` call per entry: add to the sum, bump the count); the
        representation is owned here so ``report()`` and the hot loop can
        never drift apart.
        """
        return self._sum, self._n

    def report(self) -> Dict[str, float]:
        """Flush: per-image mean since the last report (sent to the master)."""
        counts = self._n
        out = {image: s / counts[image] for image, s in self._sum.items()}
        self._sum = {}
        self._n = {}
        return out

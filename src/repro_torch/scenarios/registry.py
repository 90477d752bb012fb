"""Scenario registry: a pluggable catalogue of (workload, cluster, checks).

A *scenario* bundles everything needed to evaluate the IRM on one traffic
shape:

  - a stream factory (``make_stream(seed, **overrides) -> Stream``),
  - the cluster configuration to run it on (``sim_config``),
  - the IRM configuration (``irm_config``) — the packing policy inside it is
    swept by the runner,
  - how many back-to-back runs the experiment takes (the profiler persists
    across runs, as in the paper's 10-run microscopy experiment),
  - expected-behavior assertions (``Expectation``) that encode the claims a
    scenario is supposed to exhibit (e.g. "load concentrates on low-index
    workers").

Scenarios are registered with the ``@register_scenario`` decorator on their
stream factory; the factory itself stays importable and directly callable.
Adding a workload to the repo is now one registered function — benchmarks,
examples, tests, and the ``python -m repro_torch.scenarios.run`` CLI all pick it
up from here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from ..core.irm import IRMConfig
from ..core.sim import SimConfig, SimResult
from .streams import Stream

__all__ = [
    "Expectation",
    "Scenario",
    "register_scenario",
    "get_scenario",
    "list_scenarios",
    "scenario_names",
    "unregister_scenario",
]


@dataclasses.dataclass(frozen=True)
class Expectation:
    """A named check over a finished run (the paper's per-figure claims)."""

    name: str
    description: str
    check: Callable[[SimResult], bool]

    def evaluate(self, result: SimResult) -> bool:
        return bool(self.check(result))


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One registered workload + cluster + expected behavior."""

    name: str
    description: str
    make_stream: Callable[..., Stream]
    sim_config: Callable[[], SimConfig] = SimConfig
    irm_config: Callable[[], IRMConfig] = IRMConfig
    # number of back-to-back runs; the IRM profiler persists across them
    # (run ``i`` streams with seed ``base_seed + i``)
    n_runs: int = 1
    tags: Tuple[str, ...] = ()
    expectations: Tuple[Expectation, ...] = ()
    # kwargs for make_stream that shrink the scenario to a seconds-long
    # deterministic run — used by tests and the CI smoke invocation
    smoke_overrides: Optional[Dict[str, object]] = None
    # sim-time cap to pair with smoke_overrides
    smoke_t_max: Optional[float] = None
    # execution backends this scenario supports (``run_scenario`` rejects
    # others; ``--list`` prints the set).  Default: every backend — a
    # scenario narrows this only when its semantics genuinely require one
    # engine (e.g. a wall-clock-calibration scenario that is sim-only).
    backends: Tuple[str, ...] = ("sim", "live", "multiproc")

    def stream(self, seed: int = 0, **overrides: object) -> Stream:
        return self.make_stream(seed, **overrides)


_SCENARIOS: Dict[str, Scenario] = {}


def register_scenario(
    name: str,
    description: str,
    *,
    sim_config: Callable[[], SimConfig] = SimConfig,
    irm_config: Callable[[], IRMConfig] = IRMConfig,
    n_runs: int = 1,
    tags: Tuple[str, ...] = (),
    expectations: Tuple[Expectation, ...] = (),
    smoke_overrides: Optional[Dict[str, object]] = None,
    smoke_t_max: Optional[float] = None,
    backends: Tuple[str, ...] = ("sim", "live", "multiproc"),
) -> Callable[[Callable[..., Stream]], Callable[..., Stream]]:
    """Decorator: register a stream factory as a named scenario.

    The decorated function is returned unchanged, so it remains a plain
    importable generator; the registry holds a ``Scenario`` wrapping it.
    """

    def deco(fn: Callable[..., Stream]) -> Callable[..., Stream]:
        if name in _SCENARIOS:
            raise ValueError(f"scenario {name!r} is already registered")
        _SCENARIOS[name] = Scenario(
            name=name,
            description=description,
            make_stream=fn,
            sim_config=sim_config,
            irm_config=irm_config,
            n_runs=n_runs,
            tags=tuple(tags),
            expectations=tuple(expectations),
            smoke_overrides=dict(smoke_overrides) if smoke_overrides else None,
            smoke_t_max=smoke_t_max,
            backends=tuple(backends),
        )
        return fn

    return deco


def _ensure_library_loaded() -> None:
    # The built-in scenarios register on import; defer it so the registry
    # module itself stays import-cycle-free.
    from . import library  # noqa: F401


def get_scenario(name: str) -> Scenario:
    _ensure_library_loaded()
    try:
        return _SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {sorted(_SCENARIOS)}"
        ) from None


def list_scenarios() -> List[Scenario]:
    """All registered scenarios, sorted by name."""
    _ensure_library_loaded()
    return [_SCENARIOS[k] for k in sorted(_SCENARIOS)]


def scenario_names() -> List[str]:
    _ensure_library_loaded()
    return sorted(_SCENARIOS)


def unregister_scenario(name: str) -> None:
    """Remove a scenario (used by tests registering throwaway scenarios)."""
    _SCENARIOS.pop(name, None)

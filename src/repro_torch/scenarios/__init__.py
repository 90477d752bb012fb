"""Scenario engine: pluggable workloads + cluster configs + expectations.

``streams`` (the generators and the ``Message``/``Stream`` types) is
imported eagerly and has no dependency on the rest of the package —
``core.workloads`` re-exports from it, so everything else here loads
lazily (PEP 562) to keep that edge acyclic.

Public surface:

  - ``Message``, ``Stream`` and the stream generators (``streams``),
  - ``Scenario``, ``Expectation``, ``register_scenario``, ``get_scenario``,
    ``list_scenarios``, ``scenario_names`` (``registry``),
  - ``run_scenario``, ``sweep_policies``, ``ScenarioResult``,
    ``summarize_result``, ``POLICIES`` (``engine``),
  - the built-in catalogue registers on first registry access (``library``).

CLI: ``PYTHONPATH=src python -m repro_torch.scenarios.run --list``.
"""

from .streams import (
    Message,
    Stream,
    bursty_workload,
    diurnal_workload,
    heavy_tailed_workload,
    microscopy_mem_workload,
    mixed_accel_workload,
    multi_tenant_workload,
    synthetic_workload,
    usecase_workload,
)

_LAZY = {
    "Expectation": "registry",
    "Scenario": "registry",
    "register_scenario": "registry",
    "get_scenario": "registry",
    "list_scenarios": "registry",
    "scenario_names": "registry",
    "unregister_scenario": "registry",
    "ScenarioResult": "engine",
    "run_scenario": "engine",
    "sweep_policies": "engine",
    "summarize_result": "engine",
    "policies_for": "engine",
    "POLICIES": "engine",
    "VECTOR_POLICIES": "engine",
}

__all__ = [
    "Message",
    "Stream",
    "synthetic_workload",
    "usecase_workload",
    "bursty_workload",
    "diurnal_workload",
    "heavy_tailed_workload",
    "microscopy_mem_workload",
    "mixed_accel_workload",
    "multi_tenant_workload",
    *_LAZY,
]


def __getattr__(name: str):
    try:
        module = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    import importlib

    mod = importlib.import_module(f".{module}", __name__)
    value = getattr(mod, name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(__all__)

"""``ClusterView`` conformance checking.

The IRM schedules any cluster that implements the ``ClusterView`` protocol
(``core.irm``).  Three backends do today — the discrete-event simulator,
the live asyncio runtime, and the serving engine's adapter — and the
protocol is structural (``typing.Protocol``), so nothing enforces it at
class-definition time.  ``verify_cluster_view`` is the executable contract:
it checks that a view object exposes every required method, that the
observational ones return sanely-typed values, and that the *optional*
``backlog_resource_demand`` — which the IRM probes with ``getattr`` — is
either absent or returns ``None`` / a ``Resources`` vector.

Used by ``tests/test_view_conformance.py`` against all three backends and
intended for any future backend to self-check in its own tests.
"""

from __future__ import annotations

from typing import List

from .resources import Resources

__all__ = [
    "verify_cluster_view",
    "REQUIRED_METHODS",
    "OPTIONAL_METHODS",
    "ACTUATOR_METHODS",
]

# Observational methods: called by the checker, return values validated.
OBSERVER_METHODS = ("queue_length", "queue_image_mix",
                    "worker_scheduled_loads")
# Actuators: presence/callability checked only (calling them mutates the
# cluster, which a conformance check must not do).
ACTUATOR_METHODS = ("try_start_pe", "scale_workers")
REQUIRED_METHODS = OBSERVER_METHODS + ACTUATOR_METHODS
# Tolerated but not required; the IRM degrades gracefully without them.
OPTIONAL_METHODS = ("backlog_resource_demand",)


def verify_cluster_view(view) -> List[str]:
    """Check ``view`` against the ``ClusterView`` contract.

    Returns a list of human-readable problems — empty means conformant.
    Only observational methods are invoked; actuators are checked for
    presence and callability.
    """
    problems: List[str] = []
    for name in REQUIRED_METHODS:
        fn = getattr(view, name, None)
        if fn is None:
            problems.append(f"missing required method {name!r}")
        elif not callable(fn):
            problems.append(f"{name!r} is not callable")
    if problems:
        return problems  # can't meaningfully probe further

    q = view.queue_length()
    if not isinstance(q, (int, float)):
        problems.append(
            f"queue_length() must return a number, got {type(q).__name__}"
        )
    elif q < 0:
        problems.append(f"queue_length() must be non-negative, got {q}")

    mix = view.queue_image_mix()
    if not hasattr(mix, "items"):
        problems.append(
            f"queue_image_mix() must return a mapping, got {type(mix).__name__}"
        )
    else:
        for img, frac in mix.items():
            if not isinstance(img, str):
                problems.append(f"queue_image_mix() key {img!r} is not a str")
            if not isinstance(frac, (int, float)) or frac < 0:
                problems.append(
                    f"queue_image_mix()[{img!r}] must be a non-negative "
                    f"number, got {frac!r}"
                )
        total = sum(mix.values()) if mix else 0.0
        if mix and abs(total - 1.0) > 1e-6:
            problems.append(
                f"queue_image_mix() fractions must sum to 1, got {total}"
            )

    loads = view.worker_scheduled_loads()
    try:
        loads = list(loads)
    except TypeError:
        problems.append(
            "worker_scheduled_loads() must return an iterable, got "
            f"{type(loads).__name__}"
        )
        loads = []
    for i, load in enumerate(loads):
        if isinstance(load, Resources):
            if any(v < 0 for v in load.values):
                problems.append(
                    f"worker_scheduled_loads()[{i}] has a negative dimension"
                )
        elif isinstance(load, (int, float)):
            if load < 0:
                problems.append(
                    f"worker_scheduled_loads()[{i}] is negative: {load}"
                )
        else:
            problems.append(
                f"worker_scheduled_loads()[{i}] must be float or Resources, "
                f"got {type(load).__name__}"
            )

    # Optional: absent is fine (the IRM getattr-probes); when present it
    # must be callable and return None or a Resources vector.
    demand_fn = getattr(view, "backlog_resource_demand", None)
    if demand_fn is not None:
        if not callable(demand_fn):
            problems.append("backlog_resource_demand is not callable")
        else:
            demand = demand_fn()
            if demand is not None and not isinstance(demand, Resources):
                problems.append(
                    "backlog_resource_demand() must return None or "
                    f"Resources, got {type(demand).__name__}"
                )

    return problems

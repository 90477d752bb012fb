"""Distribution: sharding rules on DTensor, gradient compression."""

from .compression import GradCompressor
from .sharding import (
    Rules,
    axes_to_pspec,
    batch_shardings,
    cache_shardings,
    make_rules,
    param_shardings,
    spec_to_pspec,
)

__all__ = [
    "GradCompressor",
    "Rules",
    "axes_to_pspec",
    "batch_shardings",
    "cache_shardings",
    "make_rules",
    "param_shardings",
    "spec_to_pspec",
]

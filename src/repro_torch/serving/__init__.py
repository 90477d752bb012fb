"""Serving substrate: paged KV cache, continuous batching, IRM autoscaling."""

from .engine import (
    EngineConfig,
    ReplicaConfig,
    Request,
    ServingEngine,
    SimulatedBackend,
)
from .kv_cache import PageAllocator, PagedCacheLayout

__all__ = [
    "EngineConfig",
    "ReplicaConfig",
    "Request",
    "ServingEngine",
    "SimulatedBackend",
    "PageAllocator",
    "PagedCacheLayout",
]

"""Core of the reproduction: the paper's Intelligent Resource Manager.

Online bin-packing (Section IV), the IRM components (Section V), the
discrete-event evaluation environment (Section VI), and the Spark
dynamic-allocation baseline (Section VI-B.1).
"""

from .binpack import (
    ASYMPTOTIC_RATIO,
    AnyFit,
    BestFit,
    Bin,
    DominantFit,
    FirstFit,
    FirstFitDecreasing,
    FirstFitTree,
    Harmonic,
    Item,
    NextFit,
    PackResult,
    VectorAnyFit,
    VectorBestFit,
    VectorBin,
    VectorFirstFit,
    VectorFirstFitDecreasing,
    VectorItem,
    VectorNextFit,
    WorstFit,
    is_vector_policy,
    lower_bound,
    make_packer,
    vector_equivalent,
    vector_lower_bound,
)
from .resources import ResourceLike, Resources, as_resources
from .allocator import AllocatorConfig, BinPackingManager, PackingRun, idle_buffer
from .irm import IRM, ClusterView, IRMConfig, IRMMetrics
from .load_predictor import LoadPredictor, LoadPredictorConfig, ScaleDecision
from .profiler import MasterProfiler, ProfilerConfig, WorkerProbe
from .queues import AllocationQueue, ContainerQueue, HostRequest
from .sim import SimCluster, SimConfig, SimResult, simulate

from .workloads import Message, Stream, synthetic_workload, usecase_workload

__all__ = [
    "ASYMPTOTIC_RATIO",
    "AnyFit",
    "BestFit",
    "Bin",
    "FirstFit",
    "FirstFitDecreasing",
    "FirstFitTree",
    "Harmonic",
    "Item",
    "NextFit",
    "PackResult",
    "DominantFit",
    "VectorAnyFit",
    "VectorBestFit",
    "VectorBin",
    "VectorFirstFit",
    "VectorFirstFitDecreasing",
    "VectorItem",
    "VectorNextFit",
    "WorstFit",
    "is_vector_policy",
    "lower_bound",
    "make_packer",
    "vector_equivalent",
    "vector_lower_bound",
    "ResourceLike",
    "Resources",
    "as_resources",
    "AllocatorConfig",
    "BinPackingManager",
    "PackingRun",
    "idle_buffer",
    "IRM",
    "ClusterView",
    "IRMConfig",
    "IRMMetrics",
    "LoadPredictor",
    "LoadPredictorConfig",
    "ScaleDecision",
    "MasterProfiler",
    "ProfilerConfig",
    "WorkerProbe",
    "AllocationQueue",
    "ContainerQueue",
    "HostRequest",
    "SimCluster",
    "SimConfig",
    "SimResult",
    "simulate",
    "Message",
    "Stream",
    "synthetic_workload",
    "usecase_workload",
]

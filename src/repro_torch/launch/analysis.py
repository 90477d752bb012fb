"""The card's figures, the collective wire-byte rule, and a step's cost and
memory summaries: the counterpart of ``repro/launch/analysis.py``.

The JAX package reads these from a compiled XLA executable
(``cost_analysis()``, ``memory_analysis()``, the HLO's collectives).  The
port has no compiled program: ``trace_analysis.analyze_step`` runs the
step on stand-ins and counts what it dispatches, and the summaries here
read that count (a ``StepCost``).  The JAX module's ``DTYPE_BYTES``
parses HLO type strings; a tensor here carries its element size.

``HW`` holds one NVIDIA H100 SXM's figures, the roofline's denominators.
The JAX package's ``ici``/``dcn`` keys are kept so that a record reads the
same, but on this card they mean NVLink inside an 8-GPU node (a record's
``hw`` field says so) and the network between nodes: the 8-GPU node
(``NODE_GPUS``) takes the place of the JAX package's 256-chip pod.
"""

from __future__ import annotations

from typing import Any, Dict

__all__ = ["HW", "HW_NAME", "KINDS", "NODE_GPUS", "collective_kind",
           "collective_wire_bytes", "cost_summary", "memory_summary"]

HW_NAME = "NVIDIA H100 SXM 80GB; ici = NVLink inside an 8-GPU node, dcn = the network"
NODE_GPUS = 8  # an HGX H100 node: the domain the JAX package's pod becomes
HW = {
    # dense bf16 on the tensor cores (NVIDIA H100 data sheet, SXM, no sparsity)
    "peak_flops_bf16": 989e12,
    # HBM3 (the same data sheet)
    "hbm_bw": 3.35e12,
    # NVLink 4 inside an HGX node: 900 GB/s a GPU both ways, 450 each way
    # (the same data sheet)
    "ici_bw": 450e9,
    # between nodes: one 400 Gb/s NDR InfiniBand port a GPU (NVIDIA DGX H100
    # reference architecture), 50 GB/s
    "dcn_bw": 50e9,
    # device memory (the same data sheet)
    "hbm_bytes": 80e9,
}

# the functional collectives DTensor and the port dispatch, by the JAX
# package's kind names
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def collective_kind(op_name: str) -> str:
    """The JAX package's kind of a functional collective (``all_reduce``,
    ``all_gather_into_tensor``, ...), or "" for any other op."""
    return _KINDS.get(op_name, "")


def collective_wire_bytes(kind: str, in_bytes: float, out_bytes: float) -> float:
    """Bytes a device puts on the wire for one collective, by the JAX
    package's ring conventions (``repro/launch/hlo_analysis.py``):
    all-reduce 2x the tensor (reduce-scatter then all-gather), all-gather
    the output, reduce-scatter the input, all-to-all and permute the
    tensor."""
    if kind == "all-reduce":
        return 2.0 * out_bytes
    if kind == "all-gather":
        return out_bytes
    if kind == "reduce-scatter":
        return in_bytes
    return out_bytes


def cost_summary(cost: Any) -> Dict[str, float]:
    """The counterpart of the JAX package's ``xla_cost``: FLOPs and the
    bytes in and out of every dispatched op (``eager_bytes``: the traffic of
    an unfused eager step, where XLA's ``bytes accessed`` counts a fused
    program's, loop bodies once)."""
    return {"flops": float(cost.flops), "eager_bytes": float(cost.eager_bytes),
            "ops": float(cost.ops)}


def memory_summary(cost: Any) -> Dict[str, float]:
    """Per-device memory of a step: the arguments' shards (parameters,
    optimizer state, batch, cache) and the peak of the bytes the step held
    beyond them (``temp``), as the live storages of its dispatched ops
    read.  ``total_hbm_bytes`` is their sum, the JAX package's key."""
    out = {
        "argument_size_in_bytes": float(cost.arg_bytes),
        "temp_size_in_bytes": float(cost.peak_bytes - cost.arg_bytes),
        "peak_memory_in_bytes": float(cost.peak_bytes),
        "output_size_in_bytes": float(cost.out_bytes),
    }
    out["total_hbm_bytes"] = out["peak_memory_in_bytes"]
    return out

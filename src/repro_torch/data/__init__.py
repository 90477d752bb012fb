"""Streaming data pipeline: document sources, First-Fit packing, prefetch."""

from .packing import PackedBatch, SequencePacker, pack_documents, packing_efficiency
from .sources import bimodal_documents, synthetic_documents
from .stream import StreamingPipeline

__all__ = [
    "PackedBatch",
    "SequencePacker",
    "pack_documents",
    "packing_efficiency",
    "bimodal_documents",
    "synthetic_documents",
    "StreamingPipeline",
]

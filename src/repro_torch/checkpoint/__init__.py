"""Checkpointing: atomic save/restore in the JAX package's on-disk format."""

from .manager import CheckpointManager

__all__ = ["CheckpointManager"]

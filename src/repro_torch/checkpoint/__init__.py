"""Disk checkpoints for cold restart (``CheckpointManager``)."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]

"""Utilities: metric logging and checkpointing."""

from imageretrievalresearch_tpu_torch.utils.checkpoint import (
    CheckpointManager,
)
from imageretrievalresearch_tpu_torch.utils.logging import MetricLogger

__all__ = ["MetricLogger", "CheckpointManager"]

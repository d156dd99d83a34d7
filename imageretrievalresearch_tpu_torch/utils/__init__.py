"""Utilities: metric logging, checkpointing, profiling
(``utils.profiling``) and the analysis helpers (``utils.analysis``)."""

from imageretrievalresearch_tpu_torch.utils.analysis import (
    cos_sim_score_booster,
    cos_sim_score_with_threshold,
    find_lr_cos_sim_score,
    roc_curve,
)
from imageretrievalresearch_tpu_torch.utils.checkpoint import (
    CheckpointManager,
)
from imageretrievalresearch_tpu_torch.utils.logging import MetricLogger

__all__ = ["MetricLogger", "CheckpointManager", "roc_curve",
           "cos_sim_score_with_threshold", "cos_sim_score_booster",
           "find_lr_cos_sim_score"]

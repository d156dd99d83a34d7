"""Utilities: metric logging, checkpointing, profiling
(``utils.profiling``) and the analysis helpers (``utils.analysis``).

The names below load with their module at first use, so that
``utils.profiling``, which the ops import, does not pull in the
checkpointing (which imports the ops)."""

import importlib

_MODULE_OF = {"MetricLogger": "logging", "CheckpointManager": "checkpoint",
              "roc_curve": "analysis",
              "cos_sim_score_with_threshold": "analysis",
              "cos_sim_score_booster": "analysis",
              "find_lr_cos_sim_score": "analysis"}

__all__ = ["MetricLogger", "CheckpointManager", "roc_curve",
           "cos_sim_score_with_threshold", "cos_sim_score_booster",
           "find_lr_cos_sim_score"]


def __getattr__(name: str):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_MODULE_OF[name]}"),
                   name)

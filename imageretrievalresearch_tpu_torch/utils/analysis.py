"""Analysis utilities: ROC/AUC from scratch and the cosine-score boosters.

Counterpart of ``imageretrievalresearch_tpu/utils/analysis.py`` (the same
formulas on plain floats and numpy):

- :func:`roc_curve` — threshold sweep 0..1 step .05 over (actual, prediction)
  rows, TPR/FPR + trapezoid AUC, optional scatter plot
  (reference utils/roc_curve_from_scratch.py:5-84 — vectorized here; the
  reference iterates the dataframe per threshold). pandas and matplotlib
  are imported only when it is called.
- score boosters — post-hoc cosine-score calibration formulas
  (reference utils/score_booster.py:1-37; applied live in find_lr logging,
  train/find_lr.py:89-95).
"""

from __future__ import annotations

import numpy as np


def roc_curve(path_or_df, *, plot: bool = False):
    """Compute (tpr, fpr, thresholds, auc) from a csv with columns
    ``actual`` / ``prediction``; optionally draw the reference's scatter."""
    import pandas as pd

    df = pd.read_csv(path_or_df) if isinstance(path_or_df, str) else path_or_df
    actual = df["actual"].to_numpy()
    pred = df["prediction"].to_numpy()
    thresholds = np.asarray(list(range(0, 105, 5))) / 100

    # vectorized confusion counts per threshold
    pred_cls = pred[None, :] >= thresholds[:, None]        # (T, N)
    pos = actual[None, :] == 1
    tp = (pred_cls & pos).sum(axis=1)
    fn = (~pred_cls & pos).sum(axis=1)
    fp = (pred_cls & ~pos).sum(axis=1)
    tn = (~pred_cls & ~pos).sum(axis=1)
    tpr = tp / np.maximum(tp + fn, 1)
    fpr = fp / np.maximum(tn + fp, 1)
    auc = round(abs(np.trapezoid(tpr, fpr)), 4)

    if plot:
        import matplotlib.pyplot as plt
        plt.scatter(fpr, tpr, label=f"AUC Score: {auc:.3f}", c="red",
                    alpha=0.7)
        plt.plot([0, 1], c="blue", alpha=0.7)
        plt.xlabel("FAR (FPR)")
        plt.ylabel("FRR (TPR)")
        plt.legend()
    return tpr, fpr, thresholds, auc


def cos_sim_score_with_threshold(score: float, eps: float, alpha: float,
                                 threshold: float) -> float:
    """reference utils/score_booster.py:1-19 (minus the debug print)."""
    if score >= threshold:
        return (score + eps) / (eps + alpha)
    return abs((score + (alpha / eps)) / (2 * eps))


def cos_sim_score_booster(score: float, eps: float, alpha: float,
                          mode: str) -> float:
    """reference utils/score_booster.py:21-37."""
    if mode == "for_pos":
        return (score + eps) / (eps + alpha)
    if mode == "for_neg":
        return abs((score + (alpha / eps)) / (2 * eps))
    raise ValueError(f"unknown mode {mode!r}")


def find_lr_cos_sim_score(score: float, eps: float, alpha: float,
                          mode: str) -> float:
    """The find_lr variant with the low-score branch
    (reference train/find_lr.py:90-95)."""
    if mode == "for_pos":
        if score < 0.3:
            return (score + eps) / (eps + eps * alpha)
        return (score + eps) / (eps + alpha)
    if mode == "for_neg":
        return (score + (alpha / eps)) / (2 * eps)
    raise ValueError(f"unknown mode {mode!r}")

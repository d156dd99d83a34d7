"""Script equivalent of the reference's score_booster_sample.ipynb +
utils/roc_curve_from_scratch.py module-run behavior.

Counterpart of the repo's ``examples/score_booster_demo.py`` on the port's
``utils.analysis``. The reference notebook sweeps the two post-hoc
cosine-score calibration formulas (threshold-based and mode-based,
utils/score_booster.py:1-37) over example scores;
roc_curve_from_scratch.py computes an ROC/AUC from a CSV of (actual,
prediction) rows and scatter-plots it.

    python -m imageretrievalresearch_tpu_torch.examples.score_booster_demo \
        [--csv preds.csv] [--plot roc.png]

Without --csv a synthetic prediction set is generated. It needs pandas
(and matplotlib for --plot), which the rest of the port does not.
"""

from __future__ import annotations

import argparse

import numpy as np

from imageretrievalresearch_tpu_torch.utils.analysis import (
    cos_sim_score_booster,
    cos_sim_score_with_threshold,
    find_lr_cos_sim_score,
    roc_curve,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--csv", default=None,
                   help="csv with 'actual'/'prediction' columns "
                        "(utils/binary_preds.csv format)")
    p.add_argument("--plot", default=None, help="write the ROC plot here")
    p.add_argument("--eps", type=float, default=0.3)
    p.add_argument("--alpha", type=float, default=0.25)
    p.add_argument("--threshold", type=float, default=0.5)
    return p


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)

    # --- booster sweep (score_booster_sample.ipynb cells) ---
    print(f"{'score':>7} {'thresh-boost':>13} {'for_pos':>9} "
          f"{'for_neg':>9} {'find_lr':>9}")
    for score in np.linspace(0.05, 0.95, 10):
        bt = cos_sim_score_with_threshold(score, args.eps, args.alpha,
                                          args.threshold)
        bp = cos_sim_score_booster(score, args.eps, args.alpha, "for_pos")
        bn = cos_sim_score_booster(score, args.eps, args.alpha, "for_neg")
        bl = find_lr_cos_sim_score(score, args.eps, args.alpha, "for_pos")
        print(f"{score:7.3f} {bt:13.4f} {bp:9.4f} {bn:9.4f} {bl:9.4f}")

    # --- ROC from scratch (roc_curve_from_scratch.py:5-84) ---
    if args.csv:
        tpr, fpr, thresholds, auc = roc_curve(args.csv)
    else:
        import pandas as pd

        rng = np.random.default_rng(0)
        actual = rng.integers(0, 2, 2000)
        pred = np.clip(actual * 0.35 + rng.normal(0.3, 0.22, 2000), 0, 1)
        df = pd.DataFrame({"actual": actual, "prediction": pred})
        tpr, fpr, thresholds, auc = roc_curve(df)
    print(f"\nAUC: {auc:.4f}")
    print("thr   fpr    tpr")
    for t, f, r in zip(thresholds, fpr, tpr):
        print(f"{t:.2f} {f:6.3f} {r:6.3f}")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(5, 5))
        ax.scatter(fpr, tpr, c="tab:blue")
        ax.plot([0, 1], [0, 1], "k--", lw=0.8)
        ax.set_xlabel("FPR")
        ax.set_ylabel("TPR")
        ax.set_title(f"ROC (AUC={auc:.3f})")
        fig.savefig(args.plot, dpi=120, bbox_inches="tight")
        plt.close(fig)
        print(f"wrote {args.plot}")


if __name__ == "__main__":
    main()

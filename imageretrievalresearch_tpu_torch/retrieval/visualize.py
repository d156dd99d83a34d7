"""Retrieval-result visualization — the notebook's gallery view as a function.

Counterpart of ``imageretrievalresearch_tpu/retrieval/visualize.py``
(training_analysis.ipynb cell 4): for each query show the query image,
its ground-truth positive, and the top retrieved sketches captioned with
cosine similarity + predicted class; optional Grad-CAM overlay. Writes
matplotlib grids to files instead of notebook display. matplotlib is
imported inside :func:`retrieval_grid` only: nothing else of the port
needs it.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _to_uint8(im: np.ndarray) -> np.ndarray:
    im = np.asarray(im)
    if im.dtype == np.uint8:
        return im
    # float input: treat anything that LOOKS unit-ranged as [0, 1] — the
    # threshold is generous (2.0) because resize overshoot / normalize
    # wobble pushes unit-range data slightly past 1.0, and clipping such
    # an image against 255 would render a near-black panel
    if np.issubdtype(im.dtype, np.floating) and float(im.max()) <= 2.0:
        im = im * 255.0
    return np.clip(im, 0, 255).astype(np.uint8)


def retrieval_grid(results: dict, idx_to_clss: dict[int, str],
                   out_dir: str, *, num_queries: int = 8,
                   num_retrieved: int = 3, cams=None) -> list[str]:
    """Render per-query retrieval panels from
    :meth:`RetrievalEngine.evaluate_class_dedup` output (requires
    ``keep_images=True`` when embedding). ``cams``: (N, h, w) maps (numpy
    or a tensor on any device) overlaid in a last column.

    Returns the written file paths, ``retrieval_%03d.png`` under
    ``out_dir``.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if torch.is_tensor(cams):
        cams = cams.detach().cpu().numpy()
    os.makedirs(out_dir, exist_ok=True)
    ims = results["ims"]
    poss = results["poss"]
    classes = np.asarray(results["classes_all"])
    topk_inds = np.asarray(results["topk_inds"])
    top_vals = np.asarray(results["top_vals"])
    top_r = np.asarray(results["top_r_list"])

    paths = []
    n = min(num_queries, len(ims))
    # the dedup arrays carry only num_unique columns; asking for more
    # retrieved panels than exist must not IndexError mid-render
    num_retrieved = min(num_retrieved, topk_inds.shape[1])
    for i in range(n):
        cols = 2 + num_retrieved + (1 if cams is not None else 0)
        fig, axes = plt.subplots(1, cols, figsize=(2.2 * cols, 2.6))
        axes[0].imshow(_to_uint8(ims[i]))
        axes[0].set_title(f"query\n{idx_to_clss.get(int(classes[i]), '?')}",
                          fontsize=8)
        axes[1].imshow(_to_uint8(poss[i]))
        axes[1].set_title("positive", fontsize=8)
        for j in range(num_retrieved):
            ax = axes[2 + j]
            gi = int(topk_inds[i][j])
            if gi < 0:
                ax.axis("off")
                continue
            ax.imshow(_to_uint8(poss[gi]))
            ax.set_title(
                f"cos_sim:{float(top_vals[i][j]):.3f}\n"
                f"pred: {idx_to_clss.get(int(top_r[i][j]), '?')}",
                fontsize=7)
        if cams is not None:
            ax = axes[-1]
            ax.imshow(_to_uint8(ims[i]))
            ax.imshow(np.asarray(cams[i]), cmap="jet", alpha=0.45,
                      extent=(0, ims[i].shape[1], ims[i].shape[0], 0))
            ax.set_title("Grad-CAM", fontsize=8)
        for ax in axes:
            ax.set_xticks([])
            ax.set_yticks([])
        path = os.path.join(out_dir, f"retrieval_{i:03d}.png")
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        paths.append(path)
    return paths

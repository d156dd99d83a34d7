"""Plain exact cosine retrieval with class deduplication: the answer a
serving request owes. Nothing here imports the program.

Scores are float32 dot products of L2-normalised rows (TF32 off); the top
``k`` per query by score, then, walking that ranking, the first
``num_unique`` distinct gallery classes with their rows and scores.
"""

from __future__ import annotations

import numpy as np
import torch


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp(
        min=1e-12)


def scores(queries: torch.Tensor, gallery_hat: torch.Tensor) -> torch.Tensor:
    """(Q, G) cosine scores of raw queries against normalised rows."""
    return normalize(queries.float()) @ gallery_hat.T


def class_dedup(s: torch.Tensor, classes: np.ndarray, k: int,
                num_unique: int):
    """Per query the first ``num_unique`` distinct classes of its top-k:
    (rows, scores, classes) as numpy arrays (Q, num_unique)."""
    vals, inds = torch.topk(s, k, dim=1)
    vals, inds = vals.cpu().numpy(), inds.cpu().numpy()
    q = s.shape[0]
    rows = np.full((q, num_unique), -1, np.int64)
    out_s = np.full((q, num_unique), -np.inf, np.float64)
    out_c = np.full((q, num_unique), -1, np.int64)
    for i in range(q):
        seen, j = set(), 0
        for r, v in zip(inds[i], vals[i]):
            c = int(classes[r])
            if c in seen:
                continue
            seen.add(c)
            rows[i, j], out_s[i, j], out_c[i, j] = r, v, c
            j += 1
            if j == num_unique:
                break
    return rows, out_s, out_c

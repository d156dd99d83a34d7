"""The loss pieces the retrieval slice needs, with the reference semantics.

Counterpart of ``imageretrievalresearch_tpu/losses.py`` (``COSINE_SIM_EPS``,
``cosine_similarity``, ``contrastive_loss``).
"""

from __future__ import annotations

import torch

# torch.nn.CosineSimilarity default eps used throughout the reference
# (train/train.py:73: CosineSimilarity(dim=1, eps=1e-6)).
COSINE_SIM_EPS = 1e-6
# reference utils/contrastive_loss.py:34 (self.eps = 1e-9).
CONTRASTIVE_EPS = 1e-9


def cosine_similarity(x1: torch.Tensor, x2: torch.Tensor, *, dim: int = -1,
                      eps: float = COSINE_SIM_EPS) -> torch.Tensor:
    """torch >= 1.12 CosineSimilarity: each norm clamped at eps,
    ``dot / (max(|x1|, eps) * max(|x2|, eps))``."""
    x1 = x1.float()
    x2 = x2.float()
    dot = torch.sum(x1 * x2, dim=dim)
    n1 = torch.clamp(torch.linalg.vector_norm(x1, dim=dim), min=eps)
    n2 = torch.clamp(torch.linalg.vector_norm(x2, dim=dim), min=eps)
    return dot / (n1 * n2)


def contrastive_loss(fm1: torch.Tensor, fm2: torch.Tensor,
                     label: torch.Tensor | float, *, margin: float,
                     mean: bool = True,
                     eps: float = CONTRASTIVE_EPS) -> torch.Tensor:
    """Euclidean contrastive loss (reference utils/contrastive_loss.py:56-61):
    ``0.5 * (label * dis + (1 - label) * relu(margin - sqrt(dis + eps))**2)``
    with ``dis = ||fm2 - fm1||^2``."""
    fm1 = fm1.float()
    fm2 = fm2.float()
    dis = torch.sum(torch.square(fm2 - fm1), dim=1)
    label = torch.as_tensor(label, dtype=torch.float32, device=dis.device)
    hinge = torch.relu(margin - torch.sqrt(dis + eps))
    losses = 0.5 * (label * dis + (1.0 - label) * torch.square(hinge))
    return losses.mean() if mean else losses.sum()

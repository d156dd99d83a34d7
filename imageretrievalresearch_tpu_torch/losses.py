"""Loss functions with the reference semantics.

Counterpart of ``imageretrievalresearch_tpu/losses.py``: the cosine
similarity, ``CosineEmbeddingLoss``, the Euclidean contrastive loss,
``CrossEntropyLoss`` over integer labels, and the triplet / contrastive pair
combinations of the training recipes. Every loss is computed in f32.
"""

from __future__ import annotations

import torch

# torch.nn.CosineSimilarity default eps used throughout the reference
# (train/train.py:73: CosineSimilarity(dim=1, eps=1e-6)).
COSINE_SIM_EPS = 1e-6
# torch.nn.CosineEmbeddingLoss adds 1e-12 to each SQUARED norm inside the
# denominator: cos = <x1,x2> / sqrt((||x1||^2+eps)(||x2||^2+eps)).
_COS_EMBED_SQ_EPS = 1e-12
# reference utils/contrastive_loss.py:34 (self.eps = 1e-9).
CONTRASTIVE_EPS = 1e-9


def _f32_on(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as f32 on ``like``'s device: a Python number is filled in
    there, not copied from the host (a copy that waits for the card, and
    that a CUDA graph's capture refuses)."""
    if isinstance(value, (int, float)):
        return torch.full((), value, dtype=torch.float32, device=like.device)
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)


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
    label = _f32_on(label, dis)
    hinge = torch.relu(margin - torch.sqrt(dis + eps))
    losses = 0.5 * (label * dis + (1.0 - label) * torch.square(hinge))
    return losses.mean() if mean else losses.sum()


def _reduce(losses: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return losses.mean()
    if reduction == "sum":
        return losses.sum()
    if reduction == "none":
        return losses
    raise ValueError(f"unknown reduction {reduction!r}")


def cosine_embedding_loss(x1: torch.Tensor, x2: torch.Tensor,
                          target: torch.Tensor | float, *,
                          margin: float = 0.0,
                          reduction: str = "mean") -> torch.Tensor:
    """torch.nn.CosineEmbeddingLoss: per row ``1 - cos`` for target 1 and
    ``max(0, cos - margin)`` for target -1, with 1e-12 added to each
    squared norm (not a norm clamp)."""
    x1 = x1.float()
    x2 = x2.float()
    dot = torch.sum(x1 * x2, dim=-1)
    sq1 = torch.sum(torch.square(x1), dim=-1) + _COS_EMBED_SQ_EPS
    sq2 = torch.sum(torch.square(x2), dim=-1) + _COS_EMBED_SQ_EPS
    cos = dot / torch.sqrt(sq1 * sq2)
    target = _f32_on(target, cos).expand(cos.shape)
    losses = torch.where(target > 0, 1.0 - cos,
                         torch.clamp(cos - margin, min=0.0))
    return _reduce(losses, reduction)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       reduction: str = "mean") -> torch.Tensor:
    """torch.nn.CrossEntropyLoss over integer class labels, in f32."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(log_probs, 1, labels.long()[:, None])[:, 0]
    return _reduce(nll, reduction)


def triplet_losses(fm_qry: torch.Tensor, fm_pos: torch.Tensor,
                   fm_neg: torch.Tensor, *,
                   cos_margin: float) -> dict[str, torch.Tensor]:
    """The cosine-embedding pair of every triplet recipe, targets +1 / -1
    (reference train/train.py:214-216)."""
    poss = cosine_embedding_loss(fm_qry, fm_pos, 1.0, margin=cos_margin)
    negs = cosine_embedding_loss(fm_qry, fm_neg, -1.0, margin=cos_margin)
    return {"loss_cos_poss": poss, "loss_cos_negs": negs,
            "loss_cos": poss + negs}


def contrastive_pair_losses(fm_qry: torch.Tensor, fm_pos: torch.Tensor,
                            fm_neg: torch.Tensor, *,
                            margin: float) -> dict[str, torch.Tensor]:
    """Contrastive pos/neg pair, targets 1 / 0
    (reference train/train_efficient_cos_con_ce_loss.py:233-238)."""
    poss = contrastive_loss(fm_qry, fm_pos, 1.0, margin=margin)
    negs = contrastive_loss(fm_qry, fm_neg, 0.0, margin=margin)
    return {"loss_con_poss": poss, "loss_con_negs": negs,
            "loss_con": poss + negs}

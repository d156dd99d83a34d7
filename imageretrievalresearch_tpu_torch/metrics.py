"""Retrieval metrics: the reference's top-k definitions.

Counterpart of ``imageretrievalresearch_tpu/metrics.py``: the in-batch
class match of training and validation (``inbatch_topk``), the gallery
index match (``gallery_topk_index_match``), the unique-class dedup of
ranked retrievals (``unique_class_dedup``, ``dedup_and_score``, with the
batch dimension written out where JAX uses ``vmap``) and the gallery
metric over a dense score matrix (``gallery_topk_class_dedup``), the pairwise
``cos_sims`` / ``cos_unsims`` that drive checkpointing and early stopping,
and the classifier top-k. Top-k ties go to the lowest index, as
``lax.top_k`` does (stable sorts; ``torch.topk`` does not promise it).
"""

from __future__ import annotations

import math

import torch

from imageretrievalresearch_tpu_torch.losses import (
    COSINE_SIM_EPS,
    cosine_similarity,
)
from imageretrievalresearch_tpu_torch.ops.retrieval import _stable_topk


def cosine_sim_matrix(queries: torch.Tensor, gallery: torch.Tensor, *,
                      eps: float = COSINE_SIM_EPS) -> torch.Tensor:
    """All-pairs cosine similarity (Q, G): ``dots / max(|q| |g|, eps)``."""
    queries = queries.float()
    gallery = gallery.float()
    qn = torch.linalg.vector_norm(queries, dim=-1, keepdim=True)
    gn = torch.linalg.vector_norm(gallery, dim=-1, keepdim=True)
    return (queries @ gallery.t()) / torch.clamp(qn * gn.t(), min=eps)


def inbatch_topk(fm_qry: torch.Tensor, fm_pos: torch.Tensor,
                 classes: torch.Tensor, *, k: int = 3
                 ) -> dict[str, torch.Tensor]:
    """In-batch class-match top-1/top-k (metric definition #1): each query
    against every positive of the batch; k is clamped to the batch (a
    partial final batch), the key keeps the requested k."""
    sims = cosine_sim_matrix(fm_qry, fm_pos)
    _, inds = _stable_topk(sims, min(k, sims.shape[-1]))
    match = classes[inds] == classes[:, None]
    return {f"top{k}": match.any(dim=1).float().mean(),
            "top1": match[:, 0].float().mean()}


def pairwise_cos_stats(fm_qry: torch.Tensor, fm_pos: torch.Tensor,
                       fm_neg: torch.Tensor) -> dict[str, torch.Tensor]:
    """Mean pairwise cos(qry, pos) / cos(qry, neg): the logged
    ``cos_sims`` (the checkpoint and early-stop monitor) / ``cos_unsims``."""
    return {"cos_sims": cosine_similarity(fm_qry, fm_pos).mean(),
            "cos_unsims": cosine_similarity(fm_qry, fm_neg).mean()}


def gallery_topk_index_match(sims: torch.Tensor, *,
                             ks: tuple[int, ...] = (1, 3)
                             ) -> dict[str, torch.Tensor]:
    """Gallery index-match top-k (metric definition #2): query i's true
    positive sits at gallery index i."""
    kmax = min(max(ks), sims.shape[-1])
    _, inds = _stable_topk(sims, kmax)
    hit = inds == torch.arange(sims.shape[0], device=sims.device)[:, None]
    return {f"top{k}": hit[:, :k].any(dim=1).float().mean() for k in ks}


def classifier_topk(logits: torch.Tensor, labels: torch.Tensor, *,
                    k: int = 3) -> dict[str, torch.Tensor]:
    """Classifier-logit top-k: hit iff the label is among the k largest
    logits (reference train/train_vit_crossentropy.py:209-218, the
    validation form)."""
    _, inds = _stable_topk(logits.float(), k)
    match = inds == labels.long()[:, None]
    return {f"top{k}": match.any(dim=1).float().mean(),
            "top1": match[:, 0].float().mean()}


def unique_class_dedup(inds: torch.Tensor, vals: torch.Tensor,
                       classes: torch.Tensor, *, num_unique: int = 3
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dedup ranked retrievals to the first ``num_unique`` unique classes
    (training_analysis.ipynb cell 2): walk each ranked row, keep an
    index/value/class the first time its class appears.

    ``inds``/``vals`` are (K,) or (B, K); ``classes`` is (G,). Returns
    ``(uniq_inds, uniq_vals, uniq_classes)``, each (num_unique,) or
    (B, num_unique); slots beyond the distinct classes present hold
    -1 / -inf / -1.
    """
    single = inds.ndim == 1
    if single:
        inds, vals = inds[None], vals[None]
    b, k = inds.shape
    cls = classes[inds.long()]                                # (B, K)
    eq = cls[:, :, None] == cls[:, None, :]                   # (B, K, K)
    lower = torch.tril(torch.ones((k, k), dtype=torch.bool,
                                  device=inds.device), diagonal=-1)
    first = ~(eq & lower).any(dim=2)                          # (B, K)
    rank = torch.where(first, torch.cumsum(first.int(), dim=1) - 1, k)
    slot = torch.where(rank < num_unique, rank,
                       torch.full_like(rank, num_unique)).long()

    def scatter(fill, src):
        out = torch.full((b, num_unique + 1), fill, dtype=src.dtype,
                         device=src.device)
        # overflow positions all land in the dummy slot num_unique; the
        # in-range slots are collision-free
        out.scatter_(1, slot, src)
        return out[:, :num_unique]

    out = (scatter(-1, inds), scatter(-math.inf, vals), scatter(-1, cls))
    return tuple(o[0] for o in out) if single else out


def dedup_and_score(vals: torch.Tensor, inds: torch.Tensor,
                    gallery_classes: torch.Tensor,
                    query_classes: torch.Tensor, *, num_unique: int = 3
                    ) -> dict[str, torch.Tensor]:
    """Per-query unique-class dedup + top1/topN scoring from an already
    ranked (vals, inds)."""
    uniq_inds, uniq_vals, uniq_cls = unique_class_dedup(
        inds, vals, gallery_classes, num_unique=num_unique)
    gt = query_classes.reshape(-1, 1).to(uniq_cls.dtype)
    top_n = (uniq_cls == gt).any(dim=1).float().mean()
    top_1 = (uniq_cls[:, 0] == gt[:, 0]).float().mean()
    return {
        f"top{num_unique}": top_n,
        "top1": top_1,
        "topk_inds": uniq_inds,
        "top_vals": uniq_vals,
        "top_r_list": uniq_cls,
    }


def gallery_topk_class_dedup(sims: torch.Tensor, query_classes: torch.Tensor,
                             gallery_classes: torch.Tensor, *, k: int = 150,
                             num_unique: int = 3) -> dict[str, torch.Tensor]:
    """Gallery unique-class-dedup top-k (metric definition #3, notebook
    cell 2) over a dense (Q, G) score matrix: the stable top-``min(k, G)``
    of each row, then :func:`dedup_and_score` (top1 / topN and the
    deduplicated ``topk_inds`` / ``top_vals`` / ``top_r_list``)."""
    sims = torch.as_tensor(sims)
    vals, inds = _stable_topk(sims, min(k, sims.shape[1]))
    return dedup_and_score(
        vals, inds, torch.as_tensor(gallery_classes, device=sims.device),
        torch.as_tensor(query_classes, device=sims.device),
        num_unique=num_unique)

"""Unique-class dedup of ranked retrievals (metric definition #3).

Counterpart of ``imageretrievalresearch_tpu/metrics.py``
(``unique_class_dedup``, ``dedup_and_score``), with the batch dimension
written out where JAX uses ``vmap``.
"""

from __future__ import annotations

import math

import torch


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

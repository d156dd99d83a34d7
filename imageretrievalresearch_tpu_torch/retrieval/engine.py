"""RetrievalEngine — batched embedding + exact ranking, both eval variants.

Counterpart of ``imageretrievalresearch_tpu/retrieval/engine.py``
(``embed_batch``, ``search``, ``evaluate_class_dedup``,
``evaluate_index_match``) with an explicit device: ``None`` means
``cuda``. Ranking goes through :func:`ops.retrieval.cosine_topk`, whose
'exact' method takes the fused CUDA kernel on the card when eligible.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

from imageretrievalresearch_tpu_torch import metrics as M
from imageretrievalresearch_tpu_torch._device import resolve_device
from imageretrievalresearch_tpu_torch.losses import (
    contrastive_loss,
    cosine_similarity,
)
from imageretrievalresearch_tpu_torch.models.backbone import Backbone
from imageretrievalresearch_tpu_torch.ops.retrieval import (
    cosine_topk,
    l2_normalize,
)


class RetrievalEngine:
    def __init__(self, backbone: Backbone, *,
                 transform: Callable | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.backbone = backbone.to(self.device).eval()
        self.transform = transform

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x, device=self.device)

    # --- embedding ---

    @torch.no_grad()
    def embed_batch(self, images) -> torch.Tensor:
        """(B, H, W, C) uint8/float NHWC -> (B, D) embeddings on the
        device (transform first, when one is set)."""
        x = self._tensor(images)
        if self.transform is not None:
            x = self.transform(x)
        return self.backbone.embed(x.float())

    # --- ranking ---

    def search(self, queries, gallery, k: int = 150, *,
               matmul_dtype: str = "float32"
               ) -> tuple[np.ndarray, np.ndarray]:
        """Rank the raw f32 ``gallery`` for each query; numpy ``(vals,
        inds)``. ``matmul_dtype`` ('float32', 'bfloat16' or 'int8') picks
        the score arithmetic of :func:`ops.retrieval.cosine_topk`."""
        vals, inds = cosine_topk(self._tensor(queries).float(),
                                 self._tensor(gallery).float(), k,
                                 matmul_dtype=matmul_dtype)
        return vals.cpu().numpy(), inds.cpu().numpy()

    # --- full evaluations ---

    def evaluate_class_dedup(self, embeds: dict, *, k: int = 150,
                             num_unique: int = 3) -> OrderedDict:
        """Notebook-parity evaluation (training_analysis.ipynb cell 2)."""
        q = embeds["fms_ims_all"]
        g = embeds["fms_poss_all"]
        classes = embeds["classes_all"]
        vals, inds = self.search(q, g, k=min(k, len(g)))
        cls = self._tensor(classes)
        scored = M.dedup_and_score(self._tensor(vals), self._tensor(inds),
                                   cls, cls, num_unique=num_unique)
        out = OrderedDict([
            ("top1", float(scored["top1"])),
            (f"top{num_unique}", float(scored[f"top{num_unique}"])),
            ("scores", float(np.mean(_pairwise_cos(self, q, g)))),
            ("neg_scores", float(np.mean(
                _pairwise_cos(self, q, embeds["fms_negs_all"])))),
            ("fms_ims_all", q), ("classes_all", classes),
            ("fms_poss_all", g), ("fms_negs_all", embeds["fms_negs_all"]),
            ("topk_inds", scored["topk_inds"].cpu().numpy()),
            ("top_vals", scored["top_vals"].cpu().numpy()),
            ("top_r_list", scored["top_r_list"].cpu().numpy()),
        ])
        for key in ("ims", "poss", "negs"):
            if key in embeds:
                out[key] = embeds[key]
        return out

    def evaluate_index_match(self, embeds: dict, *, margin: float = 0.5
                             ) -> OrderedDict:
        """inference.py-parity evaluation: ContrastiveLoss(qry, pos, 1.) +
        index-match top1/top3 + normalized embeddings."""
        q = self._tensor(embeds["fms_ims_all"]).float()
        g = self._tensor(embeds["fms_poss_all"]).float()
        loss = float(contrastive_loss(q, g, 1.0, margin=margin))
        _, inds = self.search(q, g, k=3)
        hits = inds == np.arange(len(inds))[:, None]
        return OrderedDict([
            ("loss", loss),
            ("top1", float(np.mean(hits[:, 0]))),
            ("top3", float(np.mean(np.any(hits, axis=1)))),
            ("scores", float(np.mean(_pairwise_cos(self, q, g)))),
            ("normalized_embeddings", l2_normalize(q).cpu().numpy()),
        ])


def _pairwise_cos(engine: RetrievalEngine, a, b) -> np.ndarray:
    return cosine_similarity(engine._tensor(a).float(),
                             engine._tensor(b).float()).cpu().numpy()

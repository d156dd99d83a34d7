"""Grad-CAM saliency on torch autograd — the reference's lost analysis
capability.

Counterpart of ``imageretrievalresearch_tpu/retrieval/gradcam.py``. The
CAM is ``relu(Σ_c w_c · fm_c)`` with ``w_c`` the spatial mean of
``∂target/∂fm_c``, where ``fm`` is the backbone's last feature map: one
forward without a graph, then ``torch.autograd.grad`` of the target with
respect to that map alone (no backward through the backbone, as JAX's
``jax.grad`` of the map).

Targets:
- classification: the logit of a chosen class,
- retrieval (the north-star use): cosine similarity of the image's pooled
  embedding against a retrieved gallery embedding.

Inputs go to the backbone's device; the maps come back on it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from imageretrievalresearch_tpu_torch.losses import cosine_similarity
from imageretrievalresearch_tpu_torch.models.backbone import Backbone
from imageretrievalresearch_tpu_torch.ops.pooling import get_fm


def _spatialize(fm: torch.Tensor) -> torch.Tensor:
    """Transformer feature maps are (B, L, C) token sequences (Swin's
    ``forward_features``): fold L back into the (H, W) grid so the CAM is
    spatial. CNN (B, H, W, C) maps pass through."""
    if fm.ndim == 4:
        return fm
    if fm.ndim == 3:
        b, length, c = fm.shape
        side = int(round(length ** 0.5))
        if side * side != length:
            raise ValueError(
                f"cannot spatialize a length-{length} token sequence "
                "(not a square grid)")
        return fm.reshape(b, side, side, c)
    raise ValueError(f"expected (B,H,W,C) or (B,L,C) feature map, "
                     f"got shape {tuple(fm.shape)}")


def _cam_from_fm(fm: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) or (B, L, C) fm + grads -> (B, H, W) normalized CAM."""
    fm, grads = _spatialize(fm), _spatialize(grads)
    weights = grads.mean(dim=(1, 2), keepdim=True)            # (B,1,1,C)
    cam = torch.relu((weights * fm).sum(dim=-1))              # (B,H,W)
    cam_min = cam.amin(dim=(1, 2), keepdim=True)
    cam_max = cam.amax(dim=(1, 2), keepdim=True)
    return (cam - cam_min) / torch.clamp(cam_max - cam_min, min=1e-8)


def _on(backbone: Backbone, x) -> torch.Tensor:
    device = next(backbone.parameters()).device
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device)


def grad_cam(backbone: Backbone, images,
             target_fn: Callable[[torch.Tensor], torch.Tensor]
             ) -> torch.Tensor:
    """Generic Grad-CAM: ``target_fn`` maps the feature map -> one scalar
    per image. ``images`` are (B, H, W, 3) NHWC model inputs (already
    transformed). Returns (B, H, W) maps at feature-map resolution. The
    backbone runs in evaluation mode (JAX's ``train=False``) and is put
    back in its own mode after."""
    was_training = backbone.training
    backbone.eval()
    try:
        with torch.no_grad():
            fm = backbone.forward_features(_on(backbone, images).float())
        fm = fm.detach().requires_grad_()
        with torch.enable_grad():
            (grads,) = torch.autograd.grad(target_fn(fm).sum(), fm)
    finally:
        backbone.train(was_training)
    return _cam_from_fm(fm.detach(), grads)


def grad_cam_class(backbone: Backbone, images, class_idx) -> torch.Tensor:
    """CAM for the class logit (classic Grad-CAM). ``class_idx``: one
    class for every image, or one per image."""
    def target(fm):
        logits = backbone.head(fm)
        idx = _on(backbone, class_idx).long().reshape(-1, 1)
        return torch.gather(logits, 1, idx.expand(logits.shape[0], 1))[:, 0]

    return grad_cam(backbone, images, target)


def grad_cam_pair(backbone: Backbone, images, ref_embeddings
                  ) -> torch.Tensor:
    """CAM of retrieval similarity: which image regions drive
    cos(embed(image), retrieved_embedding) — saliency on retrieved pairs
    (BASELINE.json config #5)."""
    ref = _on(backbone, ref_embeddings).float()

    def target(fm):
        return cosine_similarity(get_fm(fm), ref)

    return grad_cam(backbone, images, target)

"""Retrieval layer: gallery engine and index, Grad-CAM saliency,
visualization."""

from imageretrievalresearch_tpu_torch.retrieval.engine import RetrievalEngine
from imageretrievalresearch_tpu_torch.retrieval.gradcam import (
    grad_cam,
    grad_cam_pair,
)
from imageretrievalresearch_tpu_torch.retrieval.index import GalleryIndex
from imageretrievalresearch_tpu_torch.retrieval.visualize import (
    retrieval_grid,
)

__all__ = ["RetrievalEngine", "GalleryIndex", "grad_cam", "grad_cam_pair",
           "retrieval_grid"]

"""Retrieval layer: gallery index and engine."""

from imageretrievalresearch_tpu_torch.retrieval.engine import RetrievalEngine
from imageretrievalresearch_tpu_torch.retrieval.index import GalleryIndex

__all__ = ["RetrievalEngine", "GalleryIndex"]

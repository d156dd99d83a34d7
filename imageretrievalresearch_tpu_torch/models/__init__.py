"""Embedding backbones with a timm-like ``forward_features`` / ``head``
split (EfficientNet family)."""

from imageretrievalresearch_tpu_torch.models.backbone import (
    Backbone,
    create_model,
    list_models,
)

__all__ = ["create_model", "list_models", "Backbone"]

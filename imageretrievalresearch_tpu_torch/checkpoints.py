"""Published-checkpoint registry — the reference's checkpoints_path.txt.

Counterpart of ``imageretrievalresearch_tpu/checkpoints.py``. The
reference ships 6 Google-Drive links to trained Lightning checkpoints
(reference checkpoints/checkpoints_path.txt:1-6). Nothing is downloaded:
the registry records their metadata, and a ``.ckpt`` already on disk
feeds straight into :func:`models.convert.load_checkpoint`.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PublishedCheckpoint:
    name: str
    model_name: str
    recipe: str
    note: str


REGISTRY: dict[str, PublishedCheckpoint] = {
    "rexnet_150_base": PublishedCheckpoint(
        "rexnet_150_base", "rexnet_150", "train",
        "reference checkpoints_path.txt:1"),
    "efficientnet_b3a_base": PublishedCheckpoint(
        "efficientnet_b3a_base", "efficientnet_b3a", "train_efficientnet",
        "reference checkpoints_path.txt:2"),
    "efficientnet_b3a_cos_ce": PublishedCheckpoint(
        "efficientnet_b3a_cos_ce", "efficientnet_b3a", "train_efficientnet",
        "cosine-embedding + CE; reference checkpoints_path.txt:3"),
    "efficientnet_b3a_cos_con_ce_m05": PublishedCheckpoint(
        "efficientnet_b3a_cos_con_ce_m05", "efficientnet_b3a",
        "train_efficient_cos_con_ce_loss",
        "margin 0.5; reference checkpoints_path.txt:4"),
    "efficientnet_b3a_cos_con_ce_m03": PublishedCheckpoint(
        "efficientnet_b3a_cos_con_ce_m03", "efficientnet_b3a",
        "train_efficient_cos_con_ce_loss",
        "margin 0.3; reference checkpoints_path.txt:5"),
    "efficientnet_b3a_cos_con_ce_m02": PublishedCheckpoint(
        "efficientnet_b3a_cos_con_ce_m02", "efficientnet_b3a",
        "train_efficient_cos_con_ce_loss",
        "margin 0.2; reference checkpoints_path.txt:6"),
}


def load_published(name: str, ckpt_path: str, *,
                   device: str | torch.device | None = None,
                   **model_kwargs):
    """Build the right backbone for a published checkpoint on ``device``
    (``cuda`` by default) and load ``ckpt_path`` into it; returns the
    backbone."""
    from imageretrievalresearch_tpu_torch.models import create_model
    from imageretrievalresearch_tpu_torch.models.convert import (
        load_checkpoint,
    )

    meta = REGISTRY[name]
    backbone = create_model(meta.model_name, device=device, **model_kwargs)
    return load_checkpoint(ckpt_path, backbone)

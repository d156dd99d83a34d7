"""Global average pooling — the reference's ``get_fm``.

Counterpart of ``imageretrievalresearch_tpu/ops/pooling.py``. The port's
backbone keeps feature maps NCHW internally, while the public layout is the
JAX package's NHWC, so ``channels_last`` says which one a 4-D map is in.
"""

from __future__ import annotations

import torch


def get_fm(fm: torch.Tensor, *, channels_last: bool = True) -> torch.Tensor:
    """(B, H, W, C) [or (B, C, H, W) with ``channels_last=False``] or
    (B, L, C) feature map -> (B, C) by spatial mean. (B, C) passes
    through."""
    if fm.ndim == 4:
        return fm.mean(dim=(1, 2) if channels_last else (2, 3))
    if fm.ndim == 3:
        return fm.mean(dim=1)
    if fm.ndim == 2:
        return fm
    raise ValueError(f"expected 2-4D feature map, got shape {tuple(fm.shape)}")

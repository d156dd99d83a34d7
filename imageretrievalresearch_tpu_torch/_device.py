"""Device resolution and float32 precision flags, in one place.

Every entry point of the port runs on ``cuda`` unless the caller passes
``device="cpu"`` (as the tests do). With no GPU and no explicit device it
raises: it never carries on silently on the CPU.

float32 precision: the port computes true float32 on the card.
``torch.backends.cuda.matmul.allow_tf32`` is already False by default, but
``torch.backends.cudnn.allow_tf32`` is True by default, which would run the
backbone's convolutions in TF32 (about three decimal digits) and move the
embeddings away from the JAX float32 forward by ~1e-3. Both are set to
False here, whenever a CUDA device is resolved.
"""

from __future__ import annotations

import torch


def set_float32_precision() -> None:
    """True float32 matmuls and convolutions on the card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when CUDA is absent); anything else is
    taken as given. Resolving a CUDA device sets the precision flags."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' explicitly to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        set_float32_precision()
    return device

"""Batched image preprocessing on the device, NHWC in and out.

Counterpart of ``imageretrievalresearch_tpu/ops/preprocess.py`` (and of
``cli/inference.py::build_eval_transform``): the eval, plain training and
AutoAugment training transforms (``ops/autoaugment.py``). ``ToTensor``
semantics: uint8 -> float / 255.

``resize_bilinear`` reproduces ``jax.image.resize(method='bilinear',
antialias=True)``, which is not ``F.interpolate(antialias=True)``: per
axis, a weight matrix from a triangle kernel, widened by 1/scale when
downsampling, normalized per output pixel (``jax.image.scale_and_translate``),
applied as two small matmuls.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from imageretrievalresearch_tpu_torch._device import resolve_device
from imageretrievalresearch_tpu_torch.ops.autoaugment import (
    imagenet_policy_batch,
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def square_pad(images: torch.Tensor, *, fill: int = 255) -> torch.Tensor:
    """Pad a (B, H, W, C) batch to square with ``fill`` (SquarePad parity:
    left/top get ``(max-d)//2``, the odd remainder goes right/bottom)."""
    h, w = images.shape[1], images.shape[2]
    m = max(h, w)
    hp, hp_rem = (m - w) // 2, (m - w) % 2
    vp, vp_rem = (m - h) // 2, (m - h) % 2
    out = torch.full((images.shape[0], m, m, images.shape[3]), fill,
                     dtype=images.dtype, device=images.device)
    out[:, vp:vp + h, hp:hp + w] = images
    return out


def _weight_matrix(in_size: int, out_size: int,
                   antialias: bool) -> np.ndarray:
    """(in, out) f32 resampling weights, jax.image.compute_weight_mat with
    the triangle kernel and translation 0, in the same f32 arithmetic."""
    f32 = np.float32
    scale = out_size / in_size          # a Python float, as in JAX
    inv_scale = 1.0 / scale
    kernel_scale = f32(max(inv_scale, 1.0)) if antialias else f32(1.0)
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5))
                * f32(inv_scale) - f32(0.0) * f32(inv_scale) - f32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None])
         / kernel_scale)
    weights = np.maximum(f32(0), f32(1) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1)),
                       f32(0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0)).astype(f32)


def resize_bilinear(images: torch.Tensor, size: tuple[int, int],
                    *, antialias: bool = True) -> torch.Tensor:
    """Batched bilinear resize of (B, H, W, C) -> (B, h, w, C) float32,
    the arithmetic of ``jax.image.resize(..., 'bilinear', antialias)``."""
    x = images.float()
    h, w = x.shape[1], x.shape[2]
    dev = x.device
    if size[0] != h:
        wh = torch.from_numpy(_weight_matrix(h, size[0], antialias)).to(dev)
        x = torch.einsum("bhwc,ho->bowc", x, wh)
    if size[1] != w:
        ww = torch.from_numpy(_weight_matrix(w, size[1], antialias)).to(dev)
        x = torch.einsum("bhwc,wo->bhoc", x, ww)
    return x


@dataclasses.dataclass(frozen=True)
class TransformSpec:
    """Per-role transform: square_pad -> resize -> AutoAugment (on uint8)
    -> to float [0, 1] -> normalize -> ``dtype``."""

    resize: tuple[int, int] | None = (224, 224)
    square_pad_fill: int | None = None       # None = no SquarePad
    autoaugment: bool = False                # ImageNetPolicy
    normalize: tuple[tuple[float, ...], tuple[float, ...]] | None = None
    dtype: str = "float32"                   # or "bfloat16"

    @staticmethod
    def train_plain(size: int = 224) -> "TransformSpec":
        """Resize + ToTensor (train/train.py:48-50)."""
        return TransformSpec(resize=(size, size))

    @staticmethod
    def train_autoaugment(size: int = 224) -> "TransformSpec":
        """Resize + AutoAugment ImageNetPolicy + ToTensor
        (train/train_efficientnet.py:49-64)."""
        return TransformSpec(resize=(size, size), autoaugment=True)

    @staticmethod
    def eval_squarepad(size: int | None = None) -> "TransformSpec":
        """SquarePad + ToTensor + Normalize(ImageNet), with an optional
        resize after padding (inference/inference.py:48-62)."""
        return TransformSpec(resize=(size, size) if size else None,
                             square_pad_fill=255,
                             normalize=(IMAGENET_MEAN, IMAGENET_STD))


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _apply(spec: TransformSpec, images, generator: torch.Generator | None,
           device) -> torch.Tensor:
    # every batch goes to ``device``, the card when it is None (a CUDA
    # tensor stays where it is); with no card and no device it raises
    x = torch.as_tensor(images, device=resolve_device(device))
    if spec.square_pad_fill is not None:
        x = square_pad(x, fill=spec.square_pad_fill)
    if spec.resize is not None and (x.shape[1], x.shape[2]) != spec.resize:
        x = resize_bilinear(x, spec.resize)
    if spec.autoaugment:
        if generator is None:
            raise ValueError("autoaugment transform requires a generator")
        if x.dtype != torch.uint8:
            # round (not truncate) post-resize floats back to the uint8
            # domain AutoAugment operates in
            x = torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
        x = imagenet_policy_batch(x, generator)
    x = x.float() / 255.0
    if spec.normalize is not None:
        mean, std = (torch.tensor(v, dtype=torch.float32, device=x.device)
                     for v in spec.normalize)
        x = (x - mean) / std
    return x.to(_DTYPES[spec.dtype])


def build_batch_transform(spec: TransformSpec, *,
                          device: str | torch.device | None = None
                          ) -> Callable:
    """``fn(uint8 NHWC batch, generator=None) -> float NHWC`` on
    ``device``, the card by default (with no card it raises unless
    ``device='cpu'``). AutoAugment draws from ``generator``, a
    ``torch.Generator`` on that device, and raises ``ValueError`` without
    one."""
    def fn(images, generator: torch.Generator | None = None
           ) -> torch.Tensor:
        return _apply(spec, images, generator, device)

    return fn


def build_image_transform(spec: TransformSpec, *,
                          device: str | torch.device | None = None
                          ) -> Callable:
    """``fn({'image': u8 NHWC, 'label': i32}, generator=None)`` for
    single-image classification batches (the T5 recipe's
    ``Compose([ToTensor()])`` plus the resize)."""
    def fn(batch: dict, generator: torch.Generator | None = None) -> dict:
        out = {"image": _apply(spec, batch["image"], generator, device)}
        if "label" in batch:
            out["label"] = batch["label"]
        return out

    return fn


def build_triplet_transform(qry: TransformSpec, pos: TransformSpec,
                            neg: TransformSpec, *,
                            device: str | torch.device | None = None
                            ) -> Callable:
    """``fn({'qry': u8, 'pos': [u8...], 'neg': [u8...]}, generator=None)``
    -> the same dict of float batches. AutoAugment roles draw from the one
    generator in a fixed order: qry, then pos..., then neg...."""
    def fn(batch: dict, generator: torch.Generator | None = None) -> dict:
        out = {"qry": _apply(qry, batch["qry"], generator, device),
               "pos": [_apply(pos, b, generator, device)
                       for b in batch["pos"]],
               "neg": [_apply(neg, b, generator, device)
                       for b in batch["neg"]]}
        for extra in ("cat_idx", "prod_idx"):
            if extra in batch:
                out[extra] = batch[extra]
        return out

    return fn


def build_eval_transform(kind: str, input_size: int, *,
                         device: str | torch.device | None = None
                         ) -> Callable:
    """The inference CLI's batch transform: 'squarepad' (SquarePad(255) ->
    resize -> ToTensor -> Normalize(ImageNet)) or 'plain' (resize + /255,
    the trainer's plain pipeline)."""
    spec = (TransformSpec.eval_squarepad(input_size) if kind == "squarepad"
            else TransformSpec.train_plain(input_size))
    return build_batch_transform(spec, device=device)

"""Backbone registry and the timm-like model surface the reference consumes.

Counterpart of ``imageretrievalresearch_tpu/models/backbone.py``.
``create_model(name, ...)`` mirrors ``timm.create_model`` and returns a
:class:`Backbone` module: ``forward_features`` (an NHWC map, or Swin's
(B, L, C) tokens), ``head`` (logits, or the pooled embedding when
``embed_only``), ``embed`` (``get_fm(forward_features(x))``),
``features_and_logits`` (embedding and logits from one pass, in train or
eval mode), with the optional ``conv_input`` stem. The registry holds the
JAX package's five families: EfficientNet, RexNet, Swin, ResNet / ResNeXt
and DarkNet; each net has ``forward_features``, ``forward_head`` and
``num_features``.
"""

from __future__ import annotations

import math
import re

import torch
from torch import nn

from imageretrievalresearch_tpu_torch._device import resolve_device
from imageretrievalresearch_tpu_torch.models.darknet import (
    DARKNET_CONFIGS,
    DarkNet,
)
from imageretrievalresearch_tpu_torch.models.efficientnet import (
    EFFICIENTNET_CONFIGS,
    EfficientNet,
)
from imageretrievalresearch_tpu_torch.models.layers import (
    ConvStem,
    Dropout,
    DropPath,
)
from imageretrievalresearch_tpu_torch.models.resnet import (
    RESNET_CONFIGS,
    ResNet,
)
from imageretrievalresearch_tpu_torch.models.rexnet import (
    REXNET_CONFIGS,
    RexNet,
)
from imageretrievalresearch_tpu_torch.models.swin import (
    SWIN_CONFIGS,
    SwinTransformer,
    WindowAttention,
)
from imageretrievalresearch_tpu_torch.ops.pooling import get_fm

_REGISTRY = {name: (ctor, cfg)
             for configs, ctor in ((EFFICIENTNET_CONFIGS, EfficientNet),
                                   (REXNET_CONFIGS, RexNet),
                                   (SWIN_CONFIGS, SwinTransformer),
                                   (RESNET_CONFIGS, ResNet),
                                   (DARKNET_CONFIGS, DarkNet))
             for name, cfg in configs.items()}
# timm 0.4.12's Swin saves these recomputable buffers; the port rebuilds
# them (non-persistent), as the JAX package's converter ignores them
_RECOMPUTED_BUFFERS = re.compile(
    r"(^|\.)(relative_position_index|attn_mask)$")


def list_models() -> list[str]:
    return sorted(_REGISTRY)


class Backbone(nn.Module):
    """``net`` (timm naming) plus the optional ``conv_input`` stem."""

    def __init__(self, name: str, net: nn.Module,
                 stem: nn.Module | None = None, embed_only: bool = False):
        super().__init__()
        self.name = name
        self.net = net
        self.stem = stem
        self.embed_only = embed_only

    def _stem_apply(self, x: torch.Tensor) -> torch.Tensor:
        if self.stem is None:
            return x
        return self.stem(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        return self.net.forward_features(self._stem_apply(x))

    def head(self, fm: torch.Tensor) -> torch.Tensor:
        if self.embed_only:
            return get_fm(fm)
        return self.net.forward_head(fm)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """get_fm(forward_features(x)) — the reference's embedding path."""
        return get_fm(self.forward_features(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.forward_features(x))

    def features_and_logits(self, x: torch.Tensor, *, train: bool = False,
                            generator: torch.Generator | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
        """One pass -> (pooled embedding, logits). ``train`` switches the
        module to training (BatchNorm on batch statistics, updating its
        running ones; dropout on) or evaluation; the dropout layers draw
        their masks from ``generator``, a ``torch.Generator`` on x's
        device."""
        self.train(train)
        drops = [m for m in self.modules()
                 if isinstance(m, (Dropout, DropPath))]
        for m in drops:
            m.generator = generator
        try:
            emb = self.embed(x)
            return emb, self.head(emb)
        finally:
            for m in drops:
                m.generator = None

    @property
    def num_features(self) -> int:
        return self.net.num_features

    def load_timm_state_dict(self, state_dict: dict) -> None:
        """Load a timm-layout state dict (strict, but for timm Swin's
        ``relative_position_index`` / ``attn_mask`` buffers, which the
        model recomputes). A ``conv_input`` model takes the reference's
        Sequential layout: the stem conv at ``0.0.weight`` and the timm
        keys under ``1.``."""
        sd = dict(state_dict)
        if self.stem is not None:
            self.stem.conv.weight.data.copy_(sd.pop("0.0.weight"))
            sd = {k[2:]: v for k, v in sd.items() if k.startswith("1.")}
        sd = {k: v for k, v in sd.items()
              if not _RECOMPUTED_BUFFERS.search(k)}
        self.net.load_state_dict(sd, strict=True)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init: He-normal conv kernels (std sqrt(2/fan_in)),
    lecun-normal linear kernels, zero biases, identity BatchNorm (scale 1,
    shift 0, running mean 0, running var 1) and LayerNorm, and Swin's
    relative-position bias tables from a normal of std 0.02 truncated at
    two standard deviations (JAX's ``truncated_normal(0.02)``). With
    lecun-normal convs the b3a embeddings of random weights shrink to
    ~1e-8, below the cosine eps; He-normal keeps them near 1e-4."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                gain = 2.0 if isinstance(m, nn.Conv2d) else 1.0
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w * math.sqrt(gain / fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.reset_parameters()
            elif isinstance(m, WindowAttention):
                nn.init.trunc_normal_(m.relative_position_bias_table,
                                      std=0.02, a=-0.04, b=0.04,
                                      generator=generator)


def create_model(model_name: str, num_classes: int = 1000,
                 conv_input: bool = False, embed_only: bool = False, *,
                 device: str | torch.device | None = None,
                 seed: int | None = 0, **kwargs) -> Backbone:
    """timm.create_model-equivalent factory, in eval mode on ``device``
    (``cuda`` by default). Weights are random from ``seed`` (a
    ``torch.Generator``); load real ones with
    :meth:`Backbone.load_timm_state_dict` or
    :func:`models.convert.params_from_jax`."""
    device = resolve_device(device)
    if model_name not in _REGISTRY:
        raise ValueError(f'Unknown model name "{model_name}". '
                         f"Available models are: {list_models()}")
    ctor, cfg = _REGISTRY[model_name]
    net = ctor(**{**cfg, "num_classes": num_classes, **kwargs})
    bb = Backbone(model_name, net, ConvStem() if conv_input else None,
                  embed_only)
    if seed is not None:
        init_weights(bb, torch.Generator().manual_seed(seed))
    return bb.to(device).eval()

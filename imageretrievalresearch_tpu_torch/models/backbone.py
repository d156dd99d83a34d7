"""Backbone registry and the timm-like model surface the reference consumes.

Counterpart of ``imageretrievalresearch_tpu/models/backbone.py``.
``create_model(name, ...)`` mirrors ``timm.create_model`` and returns a
:class:`Backbone` module: ``forward_features`` (NHWC map), ``head``
(logits, or the pooled embedding when ``embed_only``), ``embed``
(``get_fm(forward_features(x))``), ``features_and_logits`` (embedding and
logits from one pass, in train or eval mode), with the optional
``conv_input`` stem. Only the EfficientNet family is ported so far.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from imageretrievalresearch_tpu_torch._device import resolve_device
from imageretrievalresearch_tpu_torch.models.efficientnet import (
    EFFICIENTNET_CONFIGS,
    EfficientNet,
)
from imageretrievalresearch_tpu_torch.models.layers import (
    ConvStem,
    Dropout,
    DropPath,
)
from imageretrievalresearch_tpu_torch.ops.pooling import get_fm

_REGISTRY = {name: (EfficientNet, cfg)
             for name, cfg in EFFICIENTNET_CONFIGS.items()}
# the JAX package's other families, still to be ported
_NOT_PORTED = ("rexnet", "swin", "resne", "ig_resnext", "darknet")


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
        return self.net.head(fm)

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
        """Load a timm-layout state dict (strict). A ``conv_input`` model
        takes the reference's Sequential layout: the stem conv at
        ``0.0.weight`` and the timm keys under ``1.``."""
        sd = dict(state_dict)
        if self.stem is not None:
            self.stem.conv.weight.data.copy_(sd.pop("0.0.weight"))
            sd = {k[2:]: v for k, v in sd.items() if k.startswith("1.")}
        self.net.load_state_dict(sd, strict=True)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init: He-normal conv kernels (std sqrt(2/fan_in)),
    lecun-normal linear kernels, zero biases, identity BatchNorm (scale 1,
    shift 0, running mean 0, running var 1). With lecun-normal convs the
    b3a embeddings of random weights shrink to ~1e-8, below the cosine
    eps; He-normal keeps them near 1e-4."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                gain = 2.0 if isinstance(m, nn.Conv2d) else 1.0
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w * math.sqrt(gain / fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


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
        if model_name.startswith(_NOT_PORTED):
            raise ValueError(f'model "{model_name}" is not ported yet; '
                             f"available: {list_models()}")
        raise ValueError(f'Unknown model name "{model_name}". '
                         f"Available models are: {list_models()}")
    ctor, cfg = _REGISTRY[model_name]
    net = ctor(**{**cfg, "num_classes": num_classes, **kwargs})
    bb = Backbone(model_name, net, ConvStem() if conv_input else None,
                  embed_only)
    if seed is not None:
        init_weights(bb, torch.Generator().manual_seed(seed))
    return bb.to(device).eval()

"""Checkpoint loading, and weights carried from the JAX package's
``variables`` into the port.

``load_checkpoint(path, backbone)`` is the counterpart of
``models/convert.py::load_checkpoint``: an empty path keeps the model's
seeded init, a directory is read as the port's ``CheckpointManager``
layout, a file as a torch / Lightning state dict (``strip_model_prefix``),
for every family. ``export_timm_state_dict(backbone)`` is the counterpart
of ``export_torch_state_dict``: the port's model as the timm-layout
state dict that the reference's torch tooling and JAX's loader read
(``cli/convert.py`` writes it).

``params_from_jax(variables, backbone)`` takes the JAX ``variables`` pytree
as nested (numpy-convertible) dicts — ``net/params/forward_features/...``
and ``net/batch_stats/...`` — and returns the timm-layout state dict that
:meth:`models.backbone.Backbone.load_timm_state_dict` loads: conv kernels
HWIO -> OIHW (depthwise ``(K,K,1,C)`` -> ``(C,1,K,K)``), linear kernels
transposed, BN ``scale/bias/mean/var`` -> ``weight/bias/running_mean/
running_var``, LayerNorm ``scale`` -> ``weight``, Swin's bias tables as
they are. The port keeps its own copy of the JAX package's timm key maps
(``models/convert.py::*_key_map`` there): :func:`key_map_for` picks the
backbone's family by name.
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np
import torch

from imageretrievalresearch_tpu_torch.models.efficientnet import (
    _B0_STAGES,
    _round_repeats,
)
from imageretrievalresearch_tpu_torch.models.rexnet import rexnet_block_cfg
from imageretrievalresearch_tpu_torch.utils.checkpoint import saved_checkpoint

_BN = (("weight", "scale", "params"), ("bias", "bias", "params"),
       ("running_mean", "mean", "batch_stats"),
       ("running_var", "var", "batch_stats"))
FF = "forward_features"


def _bn(m: dict, dst: str, bn_src: str) -> None:
    for t_suf, ours, coll in _BN:
        m[f"{bn_src}.{t_suf}"] = (coll, f"{dst}/{ours}", "raw")


def _conv_and_bn(m: dict, conv_dst: str, bn_dst: str, conv_src: str,
                 bn_src: str) -> None:
    """A timm conv + BN pair -> JAX's conv ``conv_dst`` and BN ``bn_dst``."""
    m[f"{conv_src}.weight"] = ("params", f"{conv_dst}/kernel", "conv")
    _bn(m, bn_dst, bn_src)


def _conv_bn(m: dict, dst: str, conv_src: str, bn_src: str) -> None:
    """A bare timm conv + BN pair -> JAX's ConvBnAct ``dst``."""
    _conv_and_bn(m, f"{dst}/conv", f"{dst}/bn", conv_src, bn_src)


def _cba(m: dict, dst: str, src: str) -> None:
    """timm ConvBnAct ``<src>.conv`` / ``<src>.bn`` -> JAX's ConvBnAct."""
    _conv_bn(m, dst, f"{src}.conv", f"{src}.bn")


def _dense(m: dict, dst: str, src: str, bias: bool = True) -> None:
    m[f"{src}.weight"] = ("params", f"{dst}/kernel", "linear")
    if bias:
        m[f"{src}.bias"] = ("params", f"{dst}/bias", "raw")


def _se_conv(m: dict, dst: str, src: str) -> None:
    m[f"{src}.weight"] = ("params", f"{dst}/kernel", "conv")
    m[f"{src}.bias"] = ("params", f"{dst}/bias", "raw")


def efficientnet_key_map(depth_mult: float) -> dict:
    """timm key -> (collection, Flax path under it, kind)."""
    m: dict = {}
    _conv_bn(m, f"{FF}/conv_stem", "conv_stem", "bn1")
    for sidx, (_, _, r, _, e) in enumerate(_B0_STAGES):
        for i in range(_round_repeats(r, depth_mult)):
            t, dst = f"blocks.{sidx}.{i}", f"{FF}/blocks_{sidx}_{i}"
            if e == 1:
                _conv_bn(m, f"{dst}/conv_dw", f"{t}.conv_dw", f"{t}.bn1")
                _conv_bn(m, f"{dst}/conv_pwl", f"{t}.conv_pw", f"{t}.bn2")
            else:
                _conv_bn(m, f"{dst}/conv_pw", f"{t}.conv_pw", f"{t}.bn1")
                _conv_bn(m, f"{dst}/conv_dw", f"{t}.conv_dw", f"{t}.bn2")
                _conv_bn(m, f"{dst}/conv_pwl", f"{t}.conv_pwl", f"{t}.bn3")
            for conv in ("conv_reduce", "conv_expand"):
                _se_conv(m, f"{dst}/se/{conv}", f"{t}.se.{conv}")
    _conv_bn(m, f"{FF}/conv_head", "conv_head", "bn2")
    _dense(m, "head/classifier", "classifier")
    return m


def rexnet_key_map(width_mult: float, depth_mult: float,
                   ch_div: int = 1) -> dict:
    """timm RexNet: ``stem``, ``features.{i}`` (``conv_exp``, ``conv_dw``,
    SEWithNorm ``se.fc1`` / ``se.bn`` / ``se.fc2``, ``conv_pwl``),
    ``features.{N}`` the final ConvBnAct, ``head.fc``."""
    m: dict = {}
    _cba(m, f"{FF}/stem", "stem")
    cfg = rexnet_block_cfg(width_mult, depth_mult, ch_div=ch_div)
    for i, (_, e, _, se) in enumerate(cfg):
        t, dst = f"features.{i}", f"{FF}/features_{i}"
        if e != 1:
            _cba(m, f"{dst}/conv_exp", f"{t}.conv_exp")
        _cba(m, f"{dst}/conv_dw", f"{t}.conv_dw")
        if se > 0:
            _se_conv(m, f"{dst}/se/conv_reduce", f"{t}.se.fc1")
            _bn(m, f"{dst}/se/bn", f"{t}.se.bn")
            _se_conv(m, f"{dst}/se/conv_expand", f"{t}.se.fc2")
        _cba(m, f"{dst}/conv_pwl", f"{t}.conv_pwl")
    _cba(m, f"{FF}/final_conv", f"features.{len(cfg)}")
    _dense(m, "head/fc", "head.fc")
    return m


def resnet_key_map(layers) -> dict:
    """timm ResNet: ``conv1`` / ``bn1``, ``layer{s}.{i}`` Bottlenecks
    (``conv1..3`` / ``bn1..3``, ``downsample.0`` / ``.1`` on the first
    block of a stage), ``fc``."""
    m: dict = {}
    _conv_and_bn(m, f"{FF}/conv1", f"{FF}/bn1", "conv1", "bn1")
    for sidx, blocks in enumerate(layers):
        for i in range(blocks):
            t, dst = f"layer{sidx + 1}.{i}", f"{FF}/layer{sidx + 1}_{i}"
            for j in (1, 2, 3):
                _conv_and_bn(m, f"{dst}/conv{j}", f"{dst}/bn{j}",
                              f"{t}.conv{j}", f"{t}.bn{j}")
            if i == 0:
                _conv_and_bn(m, f"{dst}/downsample_conv",
                              f"{dst}/downsample_bn", f"{t}.downsample.0",
                              f"{t}.downsample.1")
    _dense(m, "head/fc", "fc")
    return m


def darknet_key_map(depths) -> dict:
    """Modern timm's cspnet darknet53 names: ``stem.conv1``,
    ``stages.{s}.conv_down``, ``stages.{s}.blocks.{b}.conv{1,2}`` (each
    ``conv`` / ``bn``), ``head.fc``."""
    m: dict = {}

    def conv_bn(src: str, conv_dst: str, bn_dst: str) -> None:
        _conv_and_bn(m, f"{FF}/{conv_dst}", f"{FF}/{bn_dst}", f"{src}.conv",
                      f"{src}.bn")

    conv_bn("stem.conv1", "stem_conv", "stem_bn")
    for s, depth in enumerate(depths):
        conv_bn(f"stages.{s}.conv_down", f"stage{s}_down_conv",
                f"stage{s}_down_bn")
        for b in range(depth):
            blk = f"stage{s}_block{b}"
            for j in (1, 2):
                conv_bn(f"stages.{s}.blocks.{b}.conv{j}", f"{blk}/conv{j}",
                        f"{blk}/bn{j}")
    _dense(m, "head/fc", "head.fc")
    return m


def swin_key_map(depths) -> dict:
    """timm SwinTransformer: ``patch_embed.proj`` / ``.norm``,
    ``layers.{s}.blocks.{b}`` (``norm1``, ``attn.qkv`` / ``.proj`` /
    ``.relative_position_bias_table``, ``norm2``, ``mlp.fc1`` / ``.fc2``),
    ``layers.{s}.downsample.norm`` / ``.reduction``, ``norm``, ``head``."""
    m: dict = {}

    def ln(dst: str, src: str) -> None:
        m[f"{src}.weight"] = ("params", f"{dst}/scale", "raw")
        m[f"{src}.bias"] = ("params", f"{dst}/bias", "raw")

    m["patch_embed.proj.weight"] = ("params", f"{FF}/patch_embed/kernel",
                                    "conv")
    m["patch_embed.proj.bias"] = ("params", f"{FF}/patch_embed/bias", "raw")
    ln(f"{FF}/patch_norm", "patch_embed.norm")
    for s, depth in enumerate(depths):
        for b in range(depth):
            t, dst = f"layers.{s}.blocks.{b}", f"{FF}/layers_{s}_blocks_{b}"
            ln(f"{dst}/norm1", f"{t}.norm1")
            _dense(m, f"{dst}/attn/qkv", f"{t}.attn.qkv")
            _dense(m, f"{dst}/attn/proj", f"{t}.attn.proj")
            m[f"{t}.attn.relative_position_bias_table"] = (
                "params", f"{dst}/attn/relative_position_bias_table", "raw")
            ln(f"{dst}/norm2", f"{t}.norm2")
            _dense(m, f"{dst}/mlp_fc1", f"{t}.mlp.fc1")
            _dense(m, f"{dst}/mlp_fc2", f"{t}.mlp.fc2")
        if s < len(depths) - 1:
            t, dst = f"layers.{s}.downsample", f"{FF}/layers_{s}_downsample"
            ln(f"{dst}/norm", f"{t}.norm")
            _dense(m, f"{dst}/reduction", f"{t}.reduction", bias=False)
    ln(f"{FF}/norm", "norm")
    _dense(m, "head/fc", "head")
    return m


_FAMILIES = (
    (r"^efficientnet", lambda net: efficientnet_key_map(net.depth_mult)),
    (r"^rexnet", lambda net: rexnet_key_map(net.width_mult, net.depth_mult,
                                            net.ch_div)),
    (r"^swin", lambda net: swin_key_map(net.depths)),
    (r"^(ig_)?resne(t|xt)", lambda net: resnet_key_map(net.layers)),
    (r"^darknet", lambda net: darknet_key_map(net.depths)),
)
# the classifier's timm keys, absent when num_classes <= 0
_HEAD_KEYS = ("classifier.", "head.", "fc.")


def key_map_for(backbone) -> dict:
    """The timm key map of the port's ``backbone`` (its family by name,
    its depths and widths from its net)."""
    for pattern, key_map in _FAMILIES:
        if re.match(pattern, backbone.name):
            return key_map(backbone.net)
    raise ValueError(f"no timm key map for {backbone.name!r}")


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v, dtype=np.float32)
    return out


def params_from_jax(variables: dict, backbone) -> dict:
    """JAX ``variables`` of any family -> the timm-layout state dict of
    the port's ``backbone``, the same architecture (``num_batches_tracked``
    zeros included; :func:`key_map_for` gives the keys). With a ``stem``
    entry the dict takes the reference's Sequential layout (``0.0.weight``
    + ``1.``)."""
    flat = _flatten(variables["net"])
    seq = "1." if "stem" in variables else ""
    sd: dict = {}
    used = set()
    for tkey, (coll, path, kind) in key_map_for(backbone).items():
        src = f"{coll}/{path}"
        if src not in flat:
            if tkey.startswith(_HEAD_KEYS) and not any(
                    p.startswith("params/head/") for p in flat):
                continue      # num_classes <= 0: no classifier
            raise KeyError(f"{tkey}: no JAX leaf {src}")
        val = flat[src]
        used.add(src)
        if kind == "conv":
            val = np.transpose(val, (3, 2, 0, 1))          # HWIO -> OIHW
        elif kind == "linear":
            val = val.T                                    # (in,out)->(out,in)
        sd[seq + tkey] = torch.tensor(val)
        if tkey.endswith(".running_var"):
            nbt = tkey.rsplit(".", 1)[0] + ".num_batches_tracked"
            sd[seq + nbt] = torch.zeros((), dtype=torch.long)
    unused = sorted(set(flat) - used)
    if unused:
        raise KeyError(f"JAX leaves with no timm key: {unused[:8]}")
    if seq:
        kern = _flatten(variables["stem"])["params/conv/kernel"]
        sd["0.0.weight"] = torch.tensor(np.transpose(kern, (3, 2, 0, 1)))
    return sd


def _whole_cpu(t: torch.Tensor) -> torch.Tensor:
    """A tensor gathered whole (a DTensor of an FSDP model: a collective,
    every rank calls it), on the CPU, contiguous, floats in f32."""
    from imageretrievalresearch_tpu_torch.parallel.fsdp import full_tensor
    t = full_tensor(t).detach().to("cpu")
    if t.is_floating_point():
        t = t.float()
    return t.contiguous().clone()


def export_timm_state_dict(backbone, *, lightning: bool = False,
                           template: dict | None = None,
                           strict: bool = True) -> dict:
    """The port's ``backbone`` -> a timm-layout torch state dict, the
    inverse of :meth:`Backbone.load_timm_state_dict` and the counterpart
    of the JAX package's ``export_torch_state_dict``: what the
    reference's torch tooling (inference/inference.py:114-124) and JAX's
    ``load_checkpoint`` load strictly.

    The port's ``net`` carries timm's keys already, so the export is
    ``net.state_dict()`` (every BatchNorm with its ``num_batches_tracked``)
    with tensors on the CPU, contiguous, floats in f32; a ``conv_input``
    model takes the reference's Sequential layout (the stem conv at
    ``0.0.weight``, the timm keys under ``1.``); ``lightning=True``
    prefixes every key with ``model.`` (the published checkpoints'
    layout). With a ``template`` (a ``state_dict()`` of the target torch
    module) the export is overlaid on a copy of it, as JAX's is, so
    buffers the port does not save (Swin's ``relative_position_index`` and
    ``attn_mask``, which it rebuilds) keep the template's values; with
    ``strict`` a key the template lacks raises ``KeyError`` (else it is
    dropped). An FSDP-sharded model's parameters are gathered whole."""
    seq = "1." if backbone.stem is not None else ""
    prefix = "model." if lightning else ""
    sd: dict = ({f"{prefix}{k}": v for k, v in template.items()}
                if template is not None else {})
    if seq:
        sd[f"{prefix}0.0.weight"] = _whole_cpu(backbone.stem.conv.weight)
    for key, val in backbone.net.state_dict().items():
        out = f"{prefix}{seq}{key}"
        if template is not None and out not in sd:
            if strict:
                raise KeyError(f"{key}: not present in the provided "
                               "template")
            continue
        sd[out] = _whole_cpu(val)
    return sd


def strip_model_prefix(state_dict: dict) -> dict:
    """Lightning 'model.' prefix strip (inference/inference.py:117-121)."""
    return {k.replace("model.", "", 1) if k.startswith("model.") else k: v
            for k, v in state_dict.items()}


def load_checkpoint(checkpoint_path: str, backbone, *,
                    from_pytorch_lightning: bool = True,
                    strict: bool = True):
    """Load weights into ``backbone`` in place and return it (reference
    load_checkpoint, inference/inference.py:77-149).

    - ``""``: the model keeps its seeded random init;
    - a directory: the port's ``CheckpointManager`` layout; ``["model"]``
      of the ``state.pt`` its ``restore()`` would load (the best step of
      ``best/``, else the newest of ``last/``; ``TrainState.state_dict``)
      goes to ``Backbone.load_state_dict``;
    - a file: ``torch.load``, its ``state_dict`` entry if it has one,
      Lightning's ``model.`` prefix stripped (``from_pytorch_lightning``),
      then ``Backbone.load_timm_state_dict`` (the ``conv_input`` layout
      too; ``strict=False``: keys missing from the file keep the seeded
      init and unused ones are reported, as JAX's ``strict=False``).

    Messages go to stderr. Tensors saved from the card load to the CPU
    first and are copied into the model's device."""
    if not checkpoint_path:
        print(f"Model {backbone.name} randomly initialized (no checkpoint "
              "given)", file=sys.stderr)
        return backbone
    if os.path.isdir(checkpoint_path):
        state = saved_checkpoint(checkpoint_path)
        if state is None:
            raise ValueError(
                f"{checkpoint_path} holds no state.pt: the port reads torch "
                "checkpoints only (a CheckpointManager directory or a torch "
                "file), not JAX orbax directories")
        payload = torch.load(state, map_location="cpu", weights_only=True)
        backbone.load_state_dict(payload["model"])
        print(f"Model {backbone.name} trainer checkpoint ({state}) loaded",
              file=sys.stderr)
        return backbone
    payload = torch.load(checkpoint_path, map_location="cpu",
                         weights_only=False)
    state_dict = (payload.get("state_dict", payload)
                  if isinstance(payload, dict) else payload)
    if from_pytorch_lightning:
        state_dict = strip_model_prefix(state_dict)
    backbone.load_timm_state_dict(state_dict, strict=strict)
    print(f"Model {backbone.name} trained checkpoint successfully loaded",
          file=sys.stderr)
    return backbone

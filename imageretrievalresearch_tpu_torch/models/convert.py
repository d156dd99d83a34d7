"""Carry weights from the JAX package's ``variables`` into the port.

``params_from_jax(variables)`` takes the JAX ``variables`` pytree as nested
(numpy-convertible) dicts — ``net/params/forward_features/blocks_{s}_{i}/...``
and ``net/batch_stats/...`` — and returns the timm-layout state dict that
:meth:`models.backbone.Backbone.load_timm_state_dict` loads: conv kernels
HWIO -> OIHW (depthwise ``(K,K,1,C)`` -> ``(C,1,K,K)``), linear kernels
transposed, BN ``scale/bias/mean/var`` -> ``weight/bias/running_mean/
running_var``. The port keeps its own copy of the EfficientNet key map
(counterpart of ``models/convert.py::efficientnet_key_map``).
"""

from __future__ import annotations

import numpy as np
import torch

from imageretrievalresearch_tpu_torch.models.efficientnet import (
    _B0_STAGES,
    _round_repeats,
)

_BN = (("weight", "scale", "params"), ("bias", "bias", "params"),
       ("running_mean", "mean", "batch_stats"),
       ("running_var", "var", "batch_stats"))


def _conv_bn(m: dict, dst: str, conv_src: str, bn_src: str) -> None:
    m[f"{conv_src}.weight"] = ("params", f"{dst}/conv/kernel", "conv")
    for t_suf, ours, coll in _BN:
        m[f"{bn_src}.{t_suf}"] = (coll, f"{dst}/bn/{ours}", "raw")


def efficientnet_key_map(depth_mult: float) -> dict:
    """timm key -> (collection, Flax path under it, kind)."""
    m: dict = {}
    ff = "forward_features"
    _conv_bn(m, f"{ff}/conv_stem", "conv_stem", "bn1")
    for sidx, (_, _, r, _, e) in enumerate(_B0_STAGES):
        for i in range(_round_repeats(r, depth_mult)):
            t, dst = f"blocks.{sidx}.{i}", f"{ff}/blocks_{sidx}_{i}"
            if e == 1:
                _conv_bn(m, f"{dst}/conv_dw", f"{t}.conv_dw", f"{t}.bn1")
                _conv_bn(m, f"{dst}/conv_pwl", f"{t}.conv_pw", f"{t}.bn2")
            else:
                _conv_bn(m, f"{dst}/conv_pw", f"{t}.conv_pw", f"{t}.bn1")
                _conv_bn(m, f"{dst}/conv_dw", f"{t}.conv_dw", f"{t}.bn2")
                _conv_bn(m, f"{dst}/conv_pwl", f"{t}.conv_pwl", f"{t}.bn3")
            for conv in ("conv_reduce", "conv_expand"):
                m[f"{t}.se.{conv}.weight"] = (
                    "params", f"{dst}/se/{conv}/kernel", "conv")
                m[f"{t}.se.{conv}.bias"] = (
                    "params", f"{dst}/se/{conv}/bias", "raw")
    _conv_bn(m, f"{ff}/conv_head", "conv_head", "bn2")
    m["classifier.weight"] = ("params", "head/classifier/kernel", "linear")
    m["classifier.bias"] = ("params", "head/classifier/bias", "raw")
    return m


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v, dtype=np.float32)
    return out


def params_from_jax(variables: dict, *, depth_mult: float) -> dict:
    """JAX EfficientNet ``variables`` -> the port's timm-layout state dict
    (``num_batches_tracked`` zeros included). ``depth_mult`` is the
    model's (it fixes the block count). With a ``stem`` entry the dict
    takes the reference's Sequential layout (``0.0.weight`` + ``1.``)."""
    flat = _flatten(variables["net"])
    seq = "1." if "stem" in variables else ""
    sd: dict = {}
    used = set()
    for tkey, (coll, path, kind) in efficientnet_key_map(depth_mult).items():
        src = f"{coll}/{path}"
        if src not in flat:
            if tkey.startswith("classifier."):
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

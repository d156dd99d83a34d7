"""A linear layer in f32 on tensor cores with one hand-written CUDA kernel:
``act(x · Wᵀ + b)``, act the identity or the exact (erf) GELU, for f32
inference. Swin's MLP (``models/swin.py`` ``Mlp``) calls it twice: fc1
with the GELU, fc2 without.

Counterpart of the MLP inside ``imageretrievalresearch_tpu/models/swin.py``
(two flax ``Dense`` layers and ``nn.gelu``): no TPU kernel is replaced. The kernel
(``csrc/linear_tf32x3.cu``) computes the 3xTF32 product of kernels 1 and 4:
each operand split as hi + lo (:func:`~imageretrievalresearch_tpu_torch.ops.
retrieval.split_3xtf32`), lo·hi + hi·lo + hi·hi summed in f32, within ~1e-7
of an f64 product. W is split once per weight version (the parameter's
storage and ``_version``): the split is cached beside the parameter and
holds twice its bytes.

:func:`linear` launches the kernel for a CUDA tensor, or raises; for a CPU
tensor it runs the plain version, :func:`linear_reference`, which repeats
the kernel's arithmetic. :func:`takes_kernel` is the dispatch
``models/swin.py`` applies, the rule of ``ops/attention.py``: the kernel
takes CUDA f32 with autocast off and no autograd graph wanted; training,
autocast and the CPU keep the eager ``F.linear`` path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from imageretrievalresearch_tpu_torch.ops import _cuda
from imageretrievalresearch_tpu_torch.ops.retrieval import split_3xtf32

# weight -> (its storage pointer, its _version, W_hi, W_lo)
_SPLITS: WeakIdKeyDictionary = WeakIdKeyDictionary()


def takes_kernel(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None) -> bool:
    """Whether a layer of this ``weight`` (N, K) and ``bias`` on ``x``
    goes to the kernel: CUDA f32 operands, rows of whole 16-byte chunks (K
    % 4 == 0 and N % 4 == 0), autocast off, and no autograd graph wanted."""
    params = (weight,) if bias is None else (weight, bias)
    return (x.is_cuda and x.dtype == torch.float32
            and all(p.dtype == torch.float32 for p in params)
            and weight.shape[1] % 4 == 0 and weight.shape[0] % 4 == 0
            and not torch.is_autocast_enabled(x.device.type)
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in (x, *params))))


def linear_reference(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor | None,
                     gelu: bool = False) -> torch.Tensor:
    """The plain version: the kernel's arithmetic in f32 (the 3xTF32
    product, + bias, torch's exact GELU), any device."""
    xh, xl = split_3xtf32(x)
    wh, wl = split_3xtf32(weight)
    y = (xl @ wh.T + xh @ wl.T) + xh @ wh.T
    if bias is not None:
        y = y + bias
    return F.gelu(y) if gelu else y


def _split_weight(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(W_hi, W_lo) of ``weight``, made once per weight version: a new
    storage or an in-place update (``load_state_dict``, an optimizer step)
    makes them anew. An inference tensor keeps no version, so its split is
    made at every call."""
    if weight.is_inference():
        return split_3xtf32(weight)
    key = (weight.data_ptr(), weight._version)
    got = _SPLITS.get(weight)
    if got is None or got[:2] != key:
        with torch.no_grad():
            got = (*key, *split_3xtf32(weight.detach()))
        _SPLITS[weight] = got
    return got[2], got[3]


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
           gelu: bool = False) -> torch.Tensor:
    """``act(x · weightᵀ + bias)`` for x (..., K) f32, weight (N, K) f32,
    bias (N,) f32 or None -> (..., N) f32, act the exact GELU where
    ``gelu``. The kernel on a CUDA tensor (no autograd), the plain version
    on a CPU one."""
    if _cuda.on_cpu(x):
        return linear_reference(x, weight, bias, gelu)
    dev = x.device
    n, k = weight.shape
    if x.shape[-1] != k:
        raise ValueError(f"x: expected rows of {k}, got {tuple(x.shape)}")
    if k % 4 or n % 4:
        raise ValueError(f"the kernel takes K % 4 == 0 and N % 4 == 0, got "
                         f"K = {k}, N = {n}")
    if torch.is_grad_enabled() and (
            x.requires_grad or weight.requires_grad
            or (bias is not None and bias.requires_grad)):
        raise ValueError("the linear kernel has no backward: call it under "
                         "torch.no_grad()")
    rows = x.reshape(-1, k)
    _cuda.check_operand("x", rows, torch.float32, tuple(rows.shape), dev)
    _cuda.check_operand("weight", weight, torch.float32, (n, k), dev)
    if bias is not None:
        _cuda.check_operand("bias", bias, torch.float32, (n,), dev)
    if rows.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    w_hi, w_lo = _split_weight(weight)
    y = torch.empty((rows.shape[0], n), dtype=torch.float32, device=dev)
    _cuda.launch("linear_tf32x3", "linear_tf32x3_f32", dev, rows, w_hi, w_lo,
                 bias, y, rows.shape[0], n, k, int(gelu), _cuda.sm_count(dev))
    return y.reshape(*x.shape[:-1], n)

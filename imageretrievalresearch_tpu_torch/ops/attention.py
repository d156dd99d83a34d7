"""Swin's window attention core with one hand-written CUDA kernel:
``softmax(q·scale · kᵀ + table[index] (+ mask)) · v`` for f32 inference.

Counterpart of the attention inside
``imageretrievalresearch_tpu/models/swin.py`` (``WindowAttention``), which
is plain ``jnp`` there: no TPU kernel is replaced. The operands are the
``qkv`` linear layer's output as (windows, N, 3, heads, head width) for
windows of ws x ws = N tokens, the relative-position bias table ((2ws -
1)², heads) and the optional additive mask (mask windows, N, N), window w
taking mask ``w % mask windows``; the result is (windows, N, heads x head
width), the input of the ``proj`` linear layer. The table is indexed by
:func:`relative_position_index`, which the kernel computes in closed form.

:func:`window_attention` launches the kernel (``csrc/window_attention.cu``)
for a CUDA tensor, or raises; for a CPU tensor it runs the plain version,
:func:`window_attention_reference`, the eager arithmetic of the port's
Swin. :func:`takes_kernel` is the dispatch ``models/swin.py`` applies:
the kernel takes f32 inference with heads 32 wide and windows of at most
208 tokens (Swin's windows of 7 and 14); training, autocast and Grad-CAM
keep the eager path.
"""

from __future__ import annotations

import math

import torch

from imageretrievalresearch_tpu_torch.ops import _cuda

HEAD_WIDTH = 32
MAX_TOKENS = 208    # the kernel's wider lane layout: 16 lanes x 13 columns


def relative_position_index(ws: int) -> torch.Tensor:
    """(N²,) int64 for N = ws²: entry (i, j) of a ws x ws window's tokens
    (row-major) indexes the bias table at (ih - jh + ws - 1)(2ws - 1) +
    (iw - jw + ws - 1), timm's ``relative_position_index`` and the closed
    form the kernel computes."""
    t = torch.arange(ws * ws)
    off = t // ws * (2 * ws - 1) + t % ws
    return (off[:, None] - off[None, :] + 2 * ws * (ws - 1)).reshape(-1)


def takes_kernel(qkv: torch.Tensor, table: torch.Tensor) -> bool:
    """Whether a call with this ``qkv`` (windows, N, 3, heads, head width)
    and bias table goes to the kernel: CUDA f32, heads 32 wide, N <= 208,
    and no autograd graph wanted."""
    return (qkv.is_cuda and qkv.dtype == torch.float32
            and table.dtype == torch.float32
            and qkv.shape[-1] == HEAD_WIDTH and qkv.shape[1] <= MAX_TOKENS
            and not (torch.is_grad_enabled()
                     and (qkv.requires_grad or table.requires_grad)))


def window_attention_reference(qkv: torch.Tensor, table: torch.Tensor,
                               index: torch.Tensor,
                               mask: torch.Tensor | None,
                               heads: int) -> torch.Tensor:
    """The plain version: the eager arithmetic of the port's Swin (as JAX
    writes it), any dtype and device, differentiable."""
    bn, n = qkv.shape[:2]
    hd = qkv.shape[-1]
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
    bias = table[index]
    attn = attn + bias.reshape(n, n, -1).permute(2, 0, 1)[None].to(
        attn.dtype)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.reshape(bn // nw, nw, heads, n, n)
        attn = attn + mask[None, :, None].to(attn.dtype)
        attn = attn.reshape(bn, heads, n, n)
    # float32 softmax, also under bf16 autocast; back to qkv's type
    attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
    return (attn @ v).transpose(1, 2).reshape(bn, n, heads * hd)


def window_attention(qkv: torch.Tensor, table: torch.Tensor,
                     mask: torch.Tensor | None,
                     heads: int) -> torch.Tensor:
    """The attention core of ``heads`` heads over windows of ws x ws = N
    tokens: qkv (windows, N, 3, heads, 32) f32, table ((2ws - 1)², heads)
    f32, mask (mask windows, N, N) f32 or None -> (windows, N, heads x 32)
    f32, the table indexed by :func:`relative_position_index`. The kernel
    on a CUDA tensor (no autograd), the plain version on a CPU one."""
    bn, n = qkv.shape[:2]
    ws = math.isqrt(n)
    if ws * ws != n:
        raise ValueError(f"qkv: a window of {n} tokens is not square")
    if _cuda.on_cpu(qkv):
        return window_attention_reference(
            qkv, table, relative_position_index(ws), mask, heads)
    dev = qkv.device
    if n > MAX_TOKENS:
        raise ValueError(f"window attention takes at most {MAX_TOKENS} "
                         f"tokens a window, got {n}")
    _cuda.check_operand("qkv", qkv, torch.float32,
                        (bn, n, 3, heads, HEAD_WIDTH), dev)
    _cuda.check_operand("table", table, torch.float32,
                        ((2 * ws - 1) ** 2, heads), dev)
    nw = 0
    if mask is not None:
        nw = mask.shape[0]
        _cuda.check_operand("mask", mask, torch.float32, (nw, n, n), dev)
        if nw < 1 or bn % nw:
            raise ValueError(f"{bn} windows are not a whole number of the "
                             f"mask's {nw}")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned")
    if torch.is_grad_enabled() and (qkv.requires_grad
                                    or table.requires_grad):
        raise ValueError("the window attention kernel has no backward: "
                         "call it under torch.no_grad()")
    out = torch.empty((bn, n, heads * HEAD_WIDTH), dtype=torch.float32,
                      device=dev)
    _cuda.launch("window_attention", "window_attention_f32", dev, qkv,
                 table, mask, out, bn, ws, heads, nw, HEAD_WIDTH ** -0.5)
    return out

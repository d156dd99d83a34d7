"""Swin Transformer — the reference's ViT-family backbone
(``swin_s3_base_224``, trained embedding-only in T4).

Counterpart of ``imageretrievalresearch_tpu/models/swin.py``, with timm's
module names (``patch_embed.proj`` / ``.norm``, ``layers.{s}.blocks.{b}``
with ``norm1``, ``attn.qkv`` / ``.proj`` / ``.relative_position_bias_table``,
``norm2``, ``mlp.fc1`` / ``.fc2``; ``layers.{s}.downsample.norm`` /
``.reduction``; ``norm``; ``head``), so a timm state dict loads with
``load_state_dict(strict=True)`` once timm's recomputable buffers are
dropped (``Backbone.load_timm_state_dict``). The S3 variants take a window
size per stage.

Blocks: LN -> shifted-window MHSA (relative position bias) -> residual;
LN -> MLP(4x, erf GELU) -> residual; PatchMerging (concat 2x2 -> LN ->
Linear) between stages. A window never exceeds its stage's resolution (and
then does not shift); a grid that is not a multiple of the window is
padded, each padded cell a mask region of its own; an odd grid is padded
before merging. Attention is written as JAX writes it: scaled q kᵀ + bias
(+ the -100 mask), softmax in float32, then @ v (``ops/attention.py``: on
the card one kernel for f32 inference); the MLP's two linear layers run
on the card as 3xTF32 tensor-core products (``ops/linear.py``), the GELU
in fc1's epilogue, for f32 inference.

The relative-position index and the masks at ``img_size`` are
non-persistent buffers built at construction (as timm 0.4.12 builds them).
Other input sizes run too, as in JAX: each block takes its window and
shift from the resolution it is given and builds the mask for that (H, W)
once, cached per size and device. A window's bias table is sized at
construction, so a size that clamps a window to another width than
``img_size`` did raises (JAX refuses it as a parameter of another shape).
``forward_features`` returns the normed token grid (B, L, C);
``ops.pooling.get_fm`` pools it.

While a profiler records (``utils/profiling.py``), the blocks mark spans
``swin.attention`` (qkv through proj), ``swin.window`` (pad, roll and
partition before the attention; reverse, roll back and crop after it),
``swin.mlp`` and ``swin.merge`` (patch merging), and count, from shapes
alone, for each block call: ``swin.windows`` (B x windows),
``swin.masked_windows`` (the same, where the block adds a shift or pad
mask) and ``swin.attn_scores`` (B x windows x heads x N^2); and for each
attention call, which path it took: ``swin.attn_fused`` (the window
attention kernel, ``ops/attention.py``: f32 inference on the card) or
``swin.attn_eager`` (the eager arithmetic: the CPU, autograd, autocast);
and for each MLP call its multiply-adds, ``swin.mlp_macs`` (2 x rows x dim
x hidden), and its path: ``swin.mlp_fused`` (fc1 with the GELU and fc2 on
the linear kernel, ``ops/linear.py``: f32 inference on the card) or
``swin.mlp_eager`` (``fc2(gelu(fc1(x)))``: the CPU, autograd, autocast).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from imageretrievalresearch_tpu_torch.models.layers import DropPath
from imageretrievalresearch_tpu_torch.ops import attention, linear
from imageretrievalresearch_tpu_torch.ops.pooling import get_fm
from imageretrievalresearch_tpu_torch.utils.profiling import count, span


def _shift_attn_mask(h: int, w: int, hp: int, wp: int, ws: int,
                     shift: int) -> np.ndarray | None:
    """Static attention mask on the padded (hp, wp) grid: (nW, N, N)
    additive. Region ids follow the shifted-window partition; padded cells
    (row >= h or col >= w) get a region of their own, so real tokens never
    attend padding. None when no mask is needed (no shift, no padding)."""
    if shift == 0 and hp == h and wp == w:
        return None
    img = np.zeros((hp, wp), dtype=np.int32)
    if shift > 0:
        cnt = 0
        for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            for wsl in (slice(0, -ws), slice(-ws, -shift),
                        slice(-shift, None)):
                img[hs, wsl] = cnt
                cnt += 1
    pad_id = 100 + np.arange(hp * wp).reshape(hp, wp)
    padded = np.zeros((hp, wp), dtype=bool)
    padded[h:, :] = True
    padded[:, w:] = True
    if shift > 0:
        padded = np.roll(padded, (-shift, -shift), axis=(0, 1))
    img = np.where(padded, pad_id, img)
    win = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)                          # (nW, N)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _window(h: int, w: int, ws: int, shift: int) -> tuple[int, int]:
    """A block's window and shift at an (h, w) grid: a window never larger
    than the resolution, and then no shift (global attention)."""
    if min(h, w) <= ws:
        return min(h, w), 0
    return ws, shift


def _padded(h: int, w: int, ws: int) -> tuple[int, int]:
    """The grid padded at the bottom and right to window multiples."""
    return -(-h // ws) * ws, -(-w // ws) * ws


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            attention.relative_position_index(window_size),
            persistent=False)

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        with span("swin.attention"):
            bn, n, c = x.shape
            qkv = self.qkv(x).reshape(bn, n, 3, self.num_heads,
                                      c // self.num_heads)
            table = self.relative_position_bias_table
            if attention.takes_kernel(qkv, table):
                count("swin.attn_fused")
                out = attention.window_attention(qkv, table, mask,
                                                 self.num_heads)
            else:
                count("swin.attn_eager")
                out = attention.window_attention_reference(
                    qkv, table, self.relative_position_index, mask,
                    self.num_heads)
            return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("swin.mlp"):
            fc1, fc2 = self.fc1, self.fc2
            count("swin.mlp_macs", 2 * x.numel() * fc1.out_features)
            if (linear.takes_kernel(x, fc1.weight, fc1.bias)
                    and linear.takes_kernel(x, fc2.weight, fc2.bias)):
                count("swin.mlp_fused")
                h = linear.linear(x, fc1.weight, fc1.bias, gelu=True)
                return linear.linear(h, fc2.weight, fc2.bias)
            count("swin.mlp_eager")
            return fc2(self.act(fc1(x)))


class SwinBlock(nn.Module):
    """``window_size`` and ``shift_size`` are the configured ones; the
    block clamps them per input resolution (:func:`_window`). The bias
    table and the ``attn_mask`` buffer are those of ``input_resolution``
    (the grid at ``img_size``)."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int, input_resolution: tuple[int, int],
                 mlp_ratio: float = 4.0, drop_path: float = 0.0):
        super().__init__()
        h, w = self.input_resolution = tuple(input_resolution)
        self.window_size, self.shift_size = window_size, shift_size
        ws, shift = _window(h, w, window_size, shift_size)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, ws)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path2 = DropPath(drop_path)
        mask = _shift_attn_mask(h, w, *_padded(h, w, ws), ws, shift)
        self.register_buffer(
            "attn_mask", None if mask is None else torch.from_numpy(mask),
            persistent=False)
        # masks of other resolutions: (h, w, device) -> mask or None
        self._masks: dict = {}

    def _mask(self, h: int, w: int, ws: int, shift: int,
              device: torch.device) -> torch.Tensor | None:
        if (h, w) == self.input_resolution:
            return self.attn_mask
        key = (h, w, device)
        if key not in self._masks:
            mask = _shift_attn_mask(h, w, *_padded(h, w, ws), ws, shift)
            self._masks[key] = (None if mask is None
                                else torch.from_numpy(mask).to(device))
        return self._masks[key]

    def forward(self, x: torch.Tensor,
                resolution: tuple[int, int]) -> torch.Tensor:
        h, w = resolution
        ws, shift = _window(h, w, self.window_size, self.shift_size)
        if ws != self.attn.window_size:
            raise ValueError(
                f"a {h} x {w} token grid needs a window of {ws} here, but "
                f"this block's bias table is for {self.attn.window_size} "
                f"(built at {self.input_resolution[0]} x "
                f"{self.input_resolution[1]} tokens)")
        hp, wp = _padded(h, w, ws)
        b, l, c = x.shape
        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        with span("swin.window"):
            if (hp, wp) != (h, w):
                x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
            if shift > 0:
                x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            wins = window_partition(x, ws)
        mask = self._mask(h, w, ws, shift, x.device)
        windows = wins.shape[0]
        count("swin.windows", windows)
        if mask is not None:
            count("swin.masked_windows", windows)
        count("swin.attn_scores",
              windows * self.attn.num_heads * wins.shape[1] ** 2)
        wins = self.attn(wins, mask)
        with span("swin.window"):
            x = window_reverse(wins, ws, hp, wp)
            if shift > 0:
                x = torch.roll(x, (shift, shift), dims=(1, 2))
            x = x[:, :h, :w].reshape(b, l, c)
        x = shortcut + self.drop_path1(x)
        return x + self.drop_path2(self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor,
                resolution: tuple[int, int]) -> torch.Tensor:
        with span("swin.merge"):
            h, w = resolution
            b, _, c = x.shape
            x = x.reshape(b, h, w, c)
            if h % 2 or w % 2:    # odd grid: pad bottom / right
                x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                           x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
            return self.reduction(self.norm(x.reshape(b, -1, 4 * c)))


class SwinStage(nn.Module):
    """timm's BasicLayer: ``blocks``, then ``downsample`` (but the last)."""

    def __init__(self, blocks: list, downsample: nn.Module | None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample

    def forward(self, x: torch.Tensor, resolution: tuple[int, int]
                ) -> tuple[torch.Tensor, tuple[int, int]]:
        """Tokens of an (h, w) grid -> the stage's tokens and grid."""
        for blk in self.blocks:
            x = blk(x, resolution)
        if self.downsample is None:
            return x, resolution
        h, w = resolution
        return self.downsample(x, resolution), (-(-h // 2), -(-w // 2))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor
                ) -> tuple[torch.Tensor, tuple[int, int]]:
        """(B, 3, H, W) -> (B, h*w, C) tokens, row-major, and (h, w)."""
        x = self.proj(x).permute(0, 2, 3, 1)
        b, h, w, c = x.shape
        return self.norm(x.reshape(b, h * w, c)), (h, w)


class SwinTransformer(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 4,
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_sizes: Sequence[int] = (7, 7, 7, 7),
                 num_classes: int = 1000, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.1):
        super().__init__()
        self.depths, self.num_heads = tuple(depths), tuple(num_heads)
        self.img_size = img_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        res = self.grid = (img_size // patch_size,) * 2
        total = sum(depths)
        dpr = [drop_path_rate * i / max(1, total - 1) for i in range(total)]
        stages, dim, bidx = [], embed_dim, 0
        for sidx, depth in enumerate(depths):
            ws = window_sizes[sidx]
            blocks = [SwinBlock(dim, num_heads[sidx], ws,
                                0 if i % 2 == 0 else ws // 2, res,
                                mlp_ratio, dpr[bidx + i])
                      for i in range(depth)]
            bidx += depth
            down = None
            if sidx < len(depths) - 1:
                down = PatchMerging(dim)
                res = (-(-res[0] // 2), -(-res[1] // 2))
                dim *= 2
            stages.append(SwinStage(blocks, down))
        self.layers = nn.ModuleList(stages)
        self.num_features = dim
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.head = (nn.Linear(dim, num_classes) if num_classes > 0
                     else nn.Identity())

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC -> (B, L, C) normed tokens."""
        x, res = self.patch_embed(x.permute(0, 3, 1, 2))
        for stage in self.layers:
            x, res = stage(x, res)
        return self.norm(x)

    def forward_head(self, fm: torch.Tensor) -> torch.Tensor:
        """Token mean + Linear; accepts (B, L, C) tokens or pooled (B, C)."""
        return self.head(get_fm(fm))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_head(self.forward_features(x))


SWIN_CONFIGS = {
    "swin_tiny_patch4_window7_224": dict(
        embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
        window_sizes=(7, 7, 7, 7)),
    "swin_small_patch4_window7_224": dict(
        embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24),
        window_sizes=(7, 7, 7, 7)),
    "swin_base_patch4_window7_224": dict(
        embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
        window_sizes=(7, 7, 7, 7)),
    # S3 (AutoFormerV2-searched) variants: per-stage window sizes
    "swin_s3_tiny_224": dict(
        embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
        window_sizes=(7, 7, 14, 7)),
    "swin_s3_small_224": dict(
        embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24),
        window_sizes=(14, 14, 14, 7)),
    "swin_s3_base_224": dict(
        embed_dim=96, depths=(2, 2, 30, 2), num_heads=(3, 6, 12, 24),
        window_sizes=(7, 14, 14, 7)),
}

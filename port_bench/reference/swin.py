"""Plain PyTorch Swin Transformer in timm's layout: ``swin_s3_base_224``.

timm ``swin_transformer.py`` with the S3 search space's per-stage windows
(AutoFormerV2, arXiv:2111.14725): patch embedding (a 4 x 4 convolution of
stride 4, then LayerNorm), stages of blocks, patch merging between
stages, a final LayerNorm, and the classifier on the token mean. Module
names are timm's (``patch_embed.proj`` / ``.norm``,
``layers.{s}.blocks.{b}.norm1``, ``attn.qkv``, ``attn.proj``,
``attn.relative_position_bias_table``, ``norm2``, ``mlp.fc1`` / ``.fc2``,
``layers.{s}.downsample.norm`` / ``.reduction``, ``norm``, ``head``), so
one timm-keyed state dict loads here and into the program alike. Nothing
here imports the program.

A block: LayerNorm (eps 1e-5) -> window attention -> residual; LayerNorm
-> MLP (ratio 4, erf GELU) -> residual. Window attention splits qkv into
heads, takes ``(q * head_dim^-0.5) k^T``, adds the relative-position bias
gathered from the table by ``relative_position_index``, adds the shift
mask (0 within a region, -100 across regions) where the block has one,
takes the softmax over the last axis, multiplies by v and projects.
Alternate blocks of a stage shift the grid cyclically by half a window
(``torch.roll``) before partitioning and back after. Where a stage's grid
is no larger than its window, the window is the grid and the block does
not shift (global attention), as timm clamps it.

Departures from timm, none of which changes the arithmetic of an
inference pass: ``downsample`` closes a stage (timm 0.4.12's layout, the
reference's, which the program's keys follow; later timm opens the next
stage with it); no stochastic depth, dropout or absolute position
embedding (identity in evaluation; S3 has none); a grid that is not a
multiple of its window raises instead of being padded (no stage of the
configuration needs padding at 224 px). ``relative_position_index`` and
the masks are non-persistent buffers, rebuilt at construction, so a state
dict holds parameters only. ``forward_features`` takes an NCHW image and
returns the final normed tokens as an NCHW map (B, C, h, w), whose
spatial mean is the token mean.

Every linear layer and the patch convolution are ``QLinear`` /
``QConv2d``, so that ``work/counts.forward_flops`` counts them; the
attention's two batched products are not layers and are not counted.
"""

from __future__ import annotations

import torch
from torch import nn

from port_bench.reference.models import QConv2d, QLinear

HEAD_BIAS = "head.bias"


def relative_position_index(ws: int) -> torch.Tensor:
    """(ws², ws²) index into the (2ws - 1)² rows of a bias table: for
    tokens i and j of a window, (dy + ws - 1) (2ws - 1) + dx + ws - 1 of
    their offset (dy, dx) = pos_i - pos_j. Built on the host, as the
    masks are (on the meta device the first ``arange`` and ``stack`` cost
    seconds)."""
    r = torch.arange(ws, device="cpu")
    coords = torch.stack(torch.meshgrid(r, r, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * windows, ws², C), windows in row-major
    order."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def reverse(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B * windows, ws², C) -> (B, H, W, C)."""
    c = x.shape[-1]
    x = x.view(-1, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h, w, c)


def shift_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    """(windows, ws², ws²) additive mask of a grid rolled by ``-shift``:
    the grid's 3 x 3 regions (split at -ws and -shift on each axis) get
    ids, and a pair of tokens of one window from different regions gets
    -100."""
    ids = torch.zeros((1, h, w, 1), device="cpu")
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    n = 0
    for rows in cuts:
        for cols in cuts:
            ids[:, rows, cols, :] = n
            n += 1
    win = partition(ids, ws).squeeze(-1)
    diff = win[:, None, :] - win[:, :, None]
    return diff.masked_fill(diff != 0, -100.0)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int):
        super().__init__()
        self.heads, self.scale = heads, (dim // heads) ** -0.5
        self.qkv = QLinear(dim, 3 * dim)
        self.proj = QLinear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, heads))
        self.register_buffer(
            "relative_position_index", relative_position_index(ws).to(
                self.relative_position_bias_table.device), persistent=False)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None):
        bw, n, c = x.shape
        qkv = self.qkv(x).view(bw, n, 3, self.heads, c // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[
            self.relative_position_index.view(-1)].view(n, n, -1)
        attn = attn + bias.permute(2, 0, 1).unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.view(bw // nw, nw, self.heads, n, n)
                    + mask.unsqueeze(1).unsqueeze(0))
            attn = attn.view(bw, self.heads, n, n)
        attn = attn.softmax(dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(bw, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = QLinear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = QLinear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, grid: int, ws: int,
                 shift: int, mlp_ratio: float):
        super().__init__()
        if grid <= ws:
            ws, shift = grid, 0
        if grid % ws:
            raise ValueError(f"a {grid} x {grid} grid is no multiple of "
                             f"the window {ws}")
        self.grid, self.ws, self.shift = grid, ws, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, heads, ws)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        mask = (shift_mask(grid, grid, ws, shift).to(self.norm1.weight.device)
                if shift else None)
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x):
        b, n, c = x.shape
        g, ws, s = self.grid, self.ws, self.shift
        y = self.norm1(x).view(b, g, g, c)
        if s:
            y = torch.roll(y, shifts=(-s, -s), dims=(1, 2))
        y = reverse(self.attn(partition(y, ws), self.attn_mask), ws, g, g)
        if s:
            y = torch.roll(y, shifts=(s, s), dims=(1, 2))
        x = x + y.reshape(b, n, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2 x 2 neighbours concatenated (timm's order: (0, 0), (1, 0),
    (0, 1), (1, 1) as (row, column)), LayerNorm, then a linear layer
    without bias to twice the width."""

    def __init__(self, dim: int, grid: int):
        super().__init__()
        self.grid = grid
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = QLinear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        b, _, c = x.shape
        x = x.view(b, self.grid, self.grid, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.view(b, -1, 4 * c)))


class Stage(nn.Module):
    """timm 0.4.12's ``BasicLayer``: ``blocks``, then ``downsample``."""

    def __init__(self, dim: int, depth: int, heads: int, grid: int,
                 ws: int, mlp_ratio: float, merge: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            Block(dim, heads, grid, ws, 0 if i % 2 == 0 else ws // 2,
                  mlp_ratio) for i in range(depth))
        self.downsample = PatchMerging(dim, grid) if merge else None

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x if self.downsample is None else self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = QConv2d(3, dim, patch, stride=patch)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        return self.norm(self.proj(x).flatten(2).transpose(1, 2))


class SwinTransformer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        dim, grid = cfg["embed_dim"], cfg["image_size"] // cfg["patch_size"]
        self.patch_embed = PatchEmbed(cfg["patch_size"], dim)
        stages = []
        last = len(cfg["depths"]) - 1
        for i, (depth, heads, ws) in enumerate(zip(
                cfg["depths"], cfg["num_heads"], cfg["window_sizes"])):
            stages.append(Stage(dim, depth, heads, grid, ws,
                                cfg["mlp_ratio"], merge=i < last))
            if i < last:
                dim, grid = 2 * dim, grid // 2
        self.layers = nn.ModuleList(stages)
        self.grid, self.num_features = grid, dim
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.head = QLinear(dim, cfg["num_classes"])

    def forward_features(self, x):
        """(B, 3, H, W) -> (B, C, h, w): the final normed tokens."""
        x = self.patch_embed(x)
        for stage in self.layers:
            x = stage(x)
        x = self.norm(x)
        return x.transpose(1, 2).reshape(x.shape[0], self.num_features,
                                         self.grid, self.grid)

    def logits(self, emb):
        return self.head(emb)


def build_net(cfg: dict) -> SwinTransformer:
    return SwinTransformer(cfg)

"""MaxViT / MaxxViT backbone, the MERIT and MIST encoder.

Port of ``pranet2_tpu/models/backbones/maxvit.py`` with timm's names
(``stem.{conv1,norm1,conv2}``, ``stages.{s}.blocks.{b}.{conv,attn_block,
attn_grid}.*``, the final ``norm``; the inverse of ``maxvit_key_map``,
``pranet2_tpu/utils/torch_convert.py:305``).  Only the ``('M',) * 4``
block type the used variants run is ported: every block is a conv block,
then window attention, then grid attention.

* Stem: 3x3/2 conv (no bias) -> BatchNorm + SiLU ("bn_silu") or a
  LayerNorm over C (eps 1e-6) + GELU ("ln_gelu") -> 3x3 conv (no bias).
* ``MbConv`` ('rw'): pre-BatchNorm (no activation) -> 1x1 expand to 4x the
  *input* channels + BN + SiLU -> depthwise 3x3 (the stride) + BN + SiLU ->
  SE (``int(mid / 16)`` channels, SiLU) -> 1x1 project (no bias); the
  shortcut avg-pools by 2 and expands by a bias-free 1x1 at a stride.
* ``ConvNeXtBlock`` ('_next'): depthwise 7x7 (the stride, bias) mapping
  ``in_ch -> out_ch`` with ``groups=in_ch`` (a channel multiplier of 2 at a
  stage start) -> LayerNorm over C (eps 1e-6) -> 1x1 conv MLP (4x, GELU)
  -> LayerScale; the shortcut avg-pools and expands by a biased 1x1.
* ``PartitionAttention``: LN -> window or grid partition -> ``AttentionCl``
  (head dim 32, q/k/v split per head as timm lays out ``qkv``, a relative
  position bias) -> reverse -> LayerScale -> +res; LN -> MLP (4x, GELU) ->
  LayerScale -> +res.  Tokens are channels-last inside the attention
  blocks, NCHW everywhere else.
* The relative position bias: ``RelPosMlp`` ('cr' log coordinates ->
  2 -> 512 -> heads MLP, ReLU, dropout 0.125 in training) for every
  variant but ``maxvit_tiny_rw_224``, whose ``RelPosBias`` holds a learned
  ((2 win - 1)^2, heads) table.
* The window and the grid are ``input side // 32``.  ``RelPosMlp`` does not
  depend on it: its coordinates and index are built from the input and
  cached per window.  The bias table does, and a PyTorch parameter exists
  before any input, so ``MaxxVit(img_size=...)`` sizes it from the side
  the forward will see (the JAX package takes it from the input at init);
  another side raises.
* A final LayerNorm over C on the last stage only; returns the four stage
  features, finest first.

GELU is exact erf (flax ``approximate=False``, torch's default), LayerNorms
are the port's ``nn.LayerNorm`` (flax's arithmetic), BatchNorms torch's.
The attention is plain PyTorch: the JAX package computes it with
``jax.nn.dot_product_attention`` (XLA, no Pallas kernel); its logits and
softmax are float32 for bf16 inputs here too.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pranet2_tpu_torch.nn import DropPath, Dropout, LayerNorm

DIM_HEAD = 32

MAXVIT_CONFIGS = {
    "maxvit_tiny_rw_224": dict(
        embed_dim=(64, 128, 256, 512), depths=(2, 2, 5, 2),
        stem_width=(32, 64), conv_type="mbconv", init_values=None,
        stem_norm="bn_silu", rel_pos_type="bias",
    ),
    "maxvit_rmlp_tiny_rw_256": dict(
        embed_dim=(64, 128, 256, 512), depths=(2, 2, 5, 2),
        stem_width=(32, 64), conv_type="mbconv", init_values=None,
        stem_norm="bn_silu",
    ),
    "maxvit_rmlp_small_rw_224": dict(
        embed_dim=(96, 192, 384, 768), depths=(2, 2, 5, 2),
        stem_width=(32, 64), conv_type="mbconv", init_values=1e-6,
        stem_norm="bn_silu",
    ),
    "maxvit_rmlp_small_rw_256": dict(
        embed_dim=(96, 192, 384, 768), depths=(2, 2, 5, 2),
        stem_width=(32, 64), conv_type="mbconv", init_values=1e-6,
        stem_norm="bn_silu",
    ),
    "maxxvit_rmlp_small_rw_256": dict(
        embed_dim=(96, 192, 384, 768), depths=(2, 2, 5, 2),
        stem_width=(48, 96), conv_type="convnext", init_values=1e-6,
        stem_norm="ln_gelu",
    ),
    # the JAX package's minimal configuration for compile-bound tests: one
    # block a stage, every op class of the real variants; no checkpoint
    "maxvit_dryrun": dict(
        embed_dim=(32, 32, 64, 128), depths=(1, 1, 1, 1),
        stem_width=(8, 16), conv_type="mbconv", init_values=None,
        stem_norm="bn_silu",
    ),
}


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class LayerNorm2d(LayerNorm):
    """The port's LayerNorm over the channels of an NCHW tensor."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class LayerScale(nn.Module):
    """``x * gamma`` over the last axis (channels-last) or, with
    ``channels_first``, over dim 1; gamma in float32, cast to x's type."""

    def __init__(self, dim: int, init_values: float,
                 channels_first: bool = False):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))
        self.channels_first = channels_first

    def forward(self, x):
        g = self.gamma.to(x.dtype)
        return x * (g[:, None, None] if self.channels_first else g)


# ---------------------------------------------------------------------------
# conv blocks (NCHW)
# ---------------------------------------------------------------------------


class _SE(nn.Module):
    def __init__(self, channels: int, rd_channels: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, rd_channels, 1)
        self.fc2 = nn.Conv2d(rd_channels, channels, 1)

    def forward(self, x):
        s = F.silu(self.fc1(x.mean(dim=(2, 3), keepdim=True)))
        return x * torch.sigmoid(self.fc2(s))


class _Downsample(nn.Module):
    """avg-pool 2 (floor: an odd tail dropped) + a 1x1 expand where the
    channels change (timm ``Downsample2d``, pool type 'avg2')."""

    def __init__(self, in_ch: int, out_ch: int, bias: bool):
        super().__init__()
        if in_ch != out_ch:
            self.expand = nn.Conv2d(in_ch, out_ch, 1, bias=bias)

    def forward(self, x):
        x = F.avg_pool2d(x, 2, 2)
        return self.expand(x) if hasattr(self, "expand") else x


class MbConv(nn.Module):
    """'rw' MBConv: expand from the input channels, SE 1/16, no output
    bias."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 drop_path: float = 0.0):
        super().__init__()
        mid = in_ch * 4
        if stride == 2:
            self.shortcut = _Downsample(in_ch, out_ch, bias=False)
        self.pre_norm = _bn(in_ch)
        self.conv1_1x1 = nn.Conv2d(in_ch, mid, 1, bias=False)
        self.norm1 = _bn(mid)
        self.conv2_kxk = nn.Conv2d(mid, mid, 3, stride, 1, groups=mid,
                                   bias=False)
        self.norm2 = _bn(mid)
        self.se = _SE(mid, int(mid / 16))
        self.conv3_1x1 = nn.Conv2d(mid, out_ch, 1, bias=False)
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        shortcut = self.shortcut(x) if hasattr(self, "shortcut") else x
        y = self.conv1_1x1(self.pre_norm(x))
        y = F.silu(self.norm2(self.conv2_kxk(F.silu(self.norm1(y)))))
        y = self.conv3_1x1(self.se(y))
        return self.drop_path(y) + shortcut


class _Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2: Linears on channels-last tokens, or 1x1
    convs on NCHW maps (``conv=True``, ConvNeXt's)."""

    def __init__(self, dim: int, hidden: int, conv: bool = False):
        super().__init__()
        layer = (lambda i, o: nn.Conv2d(i, o, 1)) if conv else nn.Linear
        self.fc1 = layer(dim, hidden)
        self.fc2 = layer(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ConvNeXtBlock(nn.Module):
    """'_next' ConvNeXt: depthwise 7x7 -> LN -> 1x1 MLP -> LayerScale."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 init_values: float = 1e-6, drop_path: float = 0.0):
        super().__init__()
        if stride == 2:
            self.shortcut = _Downsample(in_ch, out_ch, bias=True)
        elif in_ch != out_ch:
            self.shortcut = nn.Conv2d(in_ch, out_ch, 1)
        self.conv_dw = nn.Conv2d(in_ch, out_ch, 7, stride, 3, groups=in_ch)
        self.norm = LayerNorm2d(out_ch, eps=1e-6)
        self.mlp = _Mlp(out_ch, 4 * out_ch, conv=True)
        self.ls = LayerScale(out_ch, init_values, channels_first=True)
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        shortcut = self.shortcut(x) if hasattr(self, "shortcut") else x
        y = self.ls(self.mlp(self.norm(self.conv_dw(x))))
        return self.drop_path(y) + shortcut


# ---------------------------------------------------------------------------
# attention (channels-last)
# ---------------------------------------------------------------------------


def _rel_log_coords(win: int) -> np.ndarray:
    """'cr'-mode log coordinates sign(d) * ln(1 + |d|), (2W-1, 2W-1, 2)
    float32."""
    r = np.arange(-(win - 1), win, dtype=np.float64)
    h, w = np.meshgrid(r, r, indexing="ij")
    table = np.stack([h, w], axis=-1)
    return (np.sign(table) * np.log1p(np.abs(table))).astype(np.float32)


def _rel_index(win: int) -> np.ndarray:
    """(N, N) index into the flattened (2W-1)^2 table (swin's formula)."""
    coords = np.stack(np.meshgrid(np.arange(win), np.arange(win),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    return ((rel[0] + win - 1) * (2 * win - 1)
            + (rel[1] + win - 1)).astype(np.int64)


@functools.cache
def _rel_tables(win: int, device: torch.device):
    """The window's log coordinates (flattened to ((2W-1)^2, 2)) and
    flattened index on ``device``, built once a window and device (as
    normal tensors even under ``torch.inference_mode``: a later training
    forward saves the index for its backward)."""
    with torch.inference_mode(False):
        coords = torch.from_numpy(_rel_log_coords(win).reshape(-1, 2))
        index = torch.from_numpy(_rel_index(win).reshape(-1))
        return coords.to(device), index.to(device)


class _RelMlp(nn.Module):
    """fc1 -> ReLU -> dropout 0.125 -> fc2 (timm's ``Mlp`` of RelPosMlp).
    The dropout masks the coordinate table, which has no batch rows."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.fc1 = nn.Linear(2, hidden)
        self.drop = Dropout(0.125, batch=False)
        self.fc2 = nn.Linear(hidden, heads)

    def forward(self, x):
        return self.fc2(self.drop(F.relu(self.fc1(x))))


class RelPosMlp(nn.Module):
    """'cr'-mode relative position bias from an MLP of the log
    coordinates; ``forward(window)`` -> (heads, N, N)."""

    def __init__(self, num_heads: int, hidden_dim: int = 512):
        super().__init__()
        self.num_heads = num_heads
        self.mlp = _RelMlp(hidden_dim, num_heads)

    def forward(self, window: int):
        coords, index = _rel_tables(window, self.mlp.fc1.weight.device)
        table = self.mlp(coords.to(self.mlp.fc1.weight.dtype))
        n = window * window
        return table[index].view(n, n, self.num_heads).permute(2, 0, 1)


class RelPosBias(nn.Module):
    """A learned ((2 win - 1)^2, heads) table (swin style) for one window;
    ``forward(window)`` -> (heads, N, N) and raises for another window."""

    def __init__(self, window: int, num_heads: int):
        super().__init__()
        self.window, self.num_heads = window, num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(((2 * window - 1) ** 2, num_heads)))

    def init_(self, generator: torch.Generator):
        """The JAX package's init: a normal of std 0.02 cut at 2 std."""
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02,
                              a=-0.04, b=0.04, generator=generator)

    def forward(self, window: int):
        if window != self.window:
            raise ValueError(
                f"the bias table was built for window {self.window} (input "
                f"side {32 * self.window}); this input gives window {window}:"
                f" build the model with the input size it serves")
        table = self.relative_position_bias_table
        _, index = _rel_tables(window, table.device)
        n = window * window
        return table[index].view(n, n, self.num_heads).permute(2, 0, 1)


class AttentionCl(nn.Module):
    """Channels-last multi-head self-attention (head dim 32, qkv bias) with
    a relative position bias, over (B*, w, w, C) partitions."""

    def __init__(self, dim: int, rel_pos_type: str = "mlp",
                 window: int | None = None):
        super().__init__()
        self.dim, self.num_heads = dim, dim // DIM_HEAD
        self.qkv = nn.Linear(dim, 3 * dim)
        self.rel_pos = (RelPosMlp(self.num_heads) if rel_pos_type == "mlp"
                        else RelPosBias(window, self.num_heads))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, window: int):
        shape = x.shape
        n = shape[-3] * shape[-2]
        # timm's layout: per token, each head's q, k and v side by side
        qkv = self.qkv(x.reshape(-1, n, self.dim)).view(
            -1, n, self.num_heads, 3 * DIM_HEAD).transpose(1, 2)
        q, k, v = qkv.split(DIM_HEAD, dim=-1)
        ct = torch.promote_types(q.dtype, torch.float32)
        logits = (q @ k.transpose(-1, -2)).to(ct) / math.sqrt(DIM_HEAD)
        probs = torch.softmax(logits + self.rel_pos(window).to(ct), dim=-1)
        o = (probs.to(v.dtype) @ v).transpose(1, 2).reshape(-1, n, self.dim)
        return self.proj(o).view(shape)


def window_partition(x, win: int):
    """(N, H, W, C) -> (N * H/win * W/win, win, win, C) contiguous windows."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // win, win, w // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win, win, c)


def window_reverse(x, win: int, hw):
    h, w = hw
    c = x.shape[-1]
    x = x.reshape(-1, h // win, w // win, win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


def grid_partition(x, grid: int):
    """(N, H, W, C) -> (N * H/grid * W/grid, grid, grid, C): each partition
    the pixels strided H/grid apart."""
    n, h, w, c = x.shape
    x = x.reshape(n, grid, h // grid, grid, w // grid, c)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(-1, grid, grid, c)


def grid_reverse(x, grid: int, hw):
    h, w = hw
    c = x.shape[-1]
    x = x.reshape(-1, h // grid, w // grid, grid, grid, c)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(-1, h, w, c)


class PartitionAttention(nn.Module):
    """LN -> partition -> attention -> reverse -> LS -> +res; LN -> MLP ->
    LS -> +res, on channels-last (N, H, W, C) maps."""

    def __init__(self, dim: int, partition_type: str = "block",
                 init_values: float | None = None, rel_pos_type: str = "mlp",
                 window: int | None = None, drop_path: float = 0.0):
        super().__init__()
        self.partition_type = partition_type
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = AttentionCl(dim, rel_pos_type, window)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, 4 * dim)
        for name in ("ls1", "ls2"):
            setattr(self, name, nn.Identity() if init_values is None
                    else LayerScale(dim, init_values))
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x, window: int):
        hw = tuple(x.shape[1:3])
        y = self.norm1(x)
        if self.partition_type == "block":
            y = window_reverse(self.attn(window_partition(y, window), window),
                               window, hw)
        else:
            y = grid_reverse(self.attn(grid_partition(y, window), window),
                             window, hw)
        x = x + self.drop_path1(self.ls1(y))
        return x + self.drop_path2(self.ls2(self.mlp(self.norm2(x))))


# ---------------------------------------------------------------------------
# the backbone
# ---------------------------------------------------------------------------


class MaxxVitBlock(nn.Module):
    """Conv block (NCHW), then window and grid attention (channels-last)."""

    def __init__(self, in_ch: int, dim: int, stride: int, conv_type: str,
                 init_values: float | None, rel_pos_type: str = "mlp",
                 window: int | None = None, drop_path: float = 0.0):
        super().__init__()
        if conv_type == "mbconv":
            self.conv = MbConv(in_ch, dim, stride, drop_path)
        else:
            self.conv = ConvNeXtBlock(in_ch, dim, stride, 1e-6, drop_path)
        self.attn_block = PartitionAttention(dim, "block", init_values,
                                             rel_pos_type, window, drop_path)
        self.attn_grid = PartitionAttention(dim, "grid", init_values,
                                            rel_pos_type, window, drop_path)

    def forward(self, x, window: int):
        x = self.conv(x).permute(0, 2, 3, 1)
        x = self.attn_grid(self.attn_block(x, window), window)
        return x.permute(0, 3, 1, 2)


class _Stem(nn.Module):
    def __init__(self, in_chans: int, widths, norm: str):
        super().__init__()
        self.conv1 = nn.Conv2d(in_chans, widths[0], 3, 2, 1, bias=False)
        if norm == "bn_silu":
            self.norm1, self.act = _bn(widths[0]), nn.SiLU()
        else:
            self.norm1, self.act = LayerNorm2d(widths[0], eps=1e-6), nn.GELU()
        self.conv2 = nn.Conv2d(widths[0], widths[1], 3, 1, 1, bias=False)

    def forward(self, x):
        return self.conv2(self.act(self.norm1(self.conv1(x))))


class _Stage(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class MaxxVit(nn.Module):
    """The 4-stage feature backbone; window and grid ``input side // 32``.

    ``img_size``: the input side the forward will see, needed only by the
    'bias' relative position (``maxvit_tiny_rw_224``) to size its table.
    """

    def __init__(self, embed_dim=(96, 192, 384, 768), depths=(2, 2, 5, 2),
                 stem_width=(32, 64), conv_type: str = "mbconv",
                 init_values: float | None = 1e-6, stem_norm: str = "bn_silu",
                 rel_pos_type: str = "mlp", drop_path_rate: float = 0.0,
                 img_size: int | None = None, in_chans: int = 3):
        super().__init__()
        if rel_pos_type == "bias" and img_size is None:
            raise ValueError("the 'bias' relative position needs img_size, "
                             "the input side, to size its table")
        window = None if img_size is None else img_size // 32
        self.stem = _Stem(in_chans, stem_width, stem_norm)
        # stochastic-depth ramp over all blocks (timm's linspace)
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        stages, cur, in_ch = [], 0, stem_width[1]
        for dim, depth in zip(embed_dim, depths):
            blocks = []
            for b in range(depth):
                blocks.append(MaxxVitBlock(
                    in_ch, dim, 2 if b == 0 else 1, conv_type, init_values,
                    rel_pos_type, window, dpr[cur + b]))
                in_ch = dim
            cur += depth
            stages.append(_Stage(blocks))
        self.stages = nn.ModuleList(stages)
        self.norm = LayerNorm2d(embed_dim[-1], eps=1e-6)

    def forward(self, x):
        window = x.shape[2] // 32
        x = self.stem(x)
        feats = []
        for stage in self.stages:
            for block in stage.blocks:
                x = block(x, window)
            feats.append(x)
        feats[-1] = self.norm(feats[-1])
        return tuple(feats)


def maxvit(variant: str, drop_path_rate: float = 0.0,
           img_size: int | None = None) -> MaxxVit:
    return MaxxVit(**MAXVIT_CONFIGS[variant], drop_path_rate=drop_path_rate,
                   img_size=img_size)

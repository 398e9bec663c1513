"""MIST: a MaxxViT encoder and the convolutional-transformer CAM decoder,
with PraNet-V2's DSRA dual heads.

Port of ``pranet2_tpu/models/mist.py`` with the reference checkpoint's
names (``multiclass_seg/MIST/lib/MIST.py``, ``lib/networks.py``; the
inverse of ``mist_key_map``, ``pranet2_tpu/utils/torch_convert.py:470``):
``backbone1.*``, ``decoder.block_{5-9}.*``, ``decoder.out_head{1-4}_{fg,bg}``,
the single mode's ``out_head{1-4}`` and the grayscale stem ``conv.{0,1}``.

* Encoder: one ``maxxvit_rmlp_small_rw_256`` on the input resized to
  ``img_size_s1`` (256).
* CAM decoder: a bottleneck on stage 4 (LN -> two 3x3 convs to 1536 ->
  dropout 0.3 -> 2x2 max pool -> conv transformer), then four decoder
  blocks (LN -> nearest x2 -> 3x3 conv -> concatenate [skip, y] -> 3x3 conv
  -> dropout 0.3 -> conv transformer) to 768, 384, 192 and 96 channels,
  with 16, 12, 8, 4 and 2 heads.
* Conv transformer: q, k and v each a depthwise 3x3 conv + ReLU + LN over
  the channels, into ``nn.MultiheadAttention`` (the reference's packed
  ``in_proj_weight`` (3C, C) and ``out_proj``), a 3x3 conv on its output
  added to the input, then LN and the "wide focus" (3x3 convs at dilations
  1, 2 and 3, each padded by its dilation, GELU and dropout 0.1, summed,
  a 3x3 conv, GELU, dropout) as a residual.
* Dual: fg and bg 1x1 heads after blocks 6-9; from block 7 on the fg map
  is gated by ``ops.dsra_gate`` (the autograd Function: the gate kernel on
  every CUDA tensor, in eval and in training) with the previous level's
  maps resized bilinearly; the 8 maps come out at input size.  Single:
  the four features through ``out_head{1-4}``.

LayerNorms are the port's ``nn.LayerNorm`` (eps 1e-5); GELU is exact erf.
The bottleneck's pool is ``F.max_pool2d`` in every mode, which sends a
tied window's whole gradient to the first maximum as JAX's
``reduce_window`` does (never ``ops.max_pool``: fault F6).  Dropout is the
port's seeded ``nn.Dropout``, active in training only: the reference
applies it at eval too (``MIST.py:232-242,264``); the port, like the JAX
package, serves a deterministic eval.

The reference's standalone attention utilities ``ChannelAttentionCBAM``,
``SEBlock``, ``SpatialAttentionCBAM`` and ``CBAM`` (``MIST.py:102-167``)
are ported too; no model uses them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pranet2_tpu_torch.models.backbones.maxvit import (MAXVIT_CONFIGS,
                                                       LayerNorm2d, MaxxVit)
from pranet2_tpu_torch.models.registry import register_model
from pranet2_tpu_torch.nn import Dropout, LayerNorm
from pranet2_tpu_torch.ops import dsra_gate, resize_bilinear, upsample_nearest

HEADS = (16, 12, 8, 4, 2)


def _conv3(cin: int, cout: int, dilation: int = 1,
           groups: int = 1) -> nn.Conv2d:
    """3x3 conv with bias, "same" padding at its dilation."""
    return nn.Conv2d(cin, cout, 3, 1, dilation, dilation, groups)


class _ConvAttention(nn.Module):
    """Depthwise-conv q/k/v projections into a multi-head attention."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        for n in "qkv":
            setattr(self, f"conv_{n}", _conv3(channels, channels,
                                              groups=channels))
            setattr(self, f"layernorm_{n}", LayerNorm(channels, eps=1e-5))
        self.attention = nn.MultiheadAttention(channels, num_heads,
                                               batch_first=True)

    def _proj(self, name: str, x):
        t = torch.relu(getattr(self, f"conv_{name}")(x))
        t = t.flatten(2).transpose(1, 2)  # (N, H*W, C) tokens
        return getattr(self, f"layernorm_{name}")(t)

    def forward(self, x):
        n, c, h, w = x.shape
        o, _ = self.attention(self._proj("q", x), self._proj("k", x),
                              self._proj("v", x), need_weights=False)
        return o.transpose(1, 2).reshape(n, c, h, w)


class _WideFocus(nn.Module):
    """The dilated "wide focus" stack."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = _conv3(channels, channels)
        self.conv2 = _conv3(channels, channels, 2)
        self.conv3 = _conv3(channels, channels, 3)
        self.conv4 = _conv3(channels, channels)
        self.drop = Dropout(0.1)

    def forward(self, x):
        branch = lambda conv: self.drop(F.gelu(conv(x)))
        y = branch(self.conv1) + branch(self.conv2) + branch(self.conv3)
        return self.drop(F.gelu(self.conv4(y)))


class _Transformer(nn.Module):
    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.attention_output = _ConvAttention(channels, num_heads)
        self.conv1 = _conv3(channels, channels)
        self.layernorm = LayerNorm2d(channels, eps=1e-5)
        self.wide_focus = _WideFocus(channels)

    def forward(self, x):
        x2 = self.conv1(self.attention_output(x)) + x
        return x2 + self.wide_focus(self.layernorm(x2))


class _Bottleneck(nn.Module):
    """LN -> 2 convs -> dropout -> 2x2 max pool -> conv transformer."""

    def __init__(self, cin: int, cout: int, num_heads: int):
        super().__init__()
        self.layernorm = LayerNorm2d(cin, eps=1e-5)
        self.conv1 = _conv3(cin, cout)
        self.conv2 = _conv3(cout, cout)
        self.drop = Dropout(0.3)
        self.trans = _Transformer(cout, num_heads)

    def forward(self, x):
        y = torch.relu(self.conv1(self.layernorm(x)))
        y = self.drop(torch.relu(self.conv2(y)))
        return self.trans(F.max_pool2d(y, 2, 2))


class _DecoderBlock(nn.Module):
    """LN -> nearest x2 -> conv -> concatenate [skip, y] -> conv -> dropout
    -> conv transformer."""

    def __init__(self, cin: int, skip: int, cout: int, num_heads: int):
        super().__init__()
        self.layernorm = LayerNorm2d(cin, eps=1e-5)
        self.conv1 = _conv3(cin, cout)
        self.conv2 = _conv3(skip + cout, cout)
        self.drop = Dropout(0.3)
        self.trans = _Transformer(cout, num_heads)

    def forward(self, x, skip):
        y = torch.relu(self.conv1(upsample_nearest(self.layernorm(x), 2)))
        y = torch.relu(self.conv2(torch.cat([skip, y], 1)))
        return self.trans(self.drop(y))


class CAMDecoder(nn.Module):
    """The CAM decoder over the four stage features (finest first); dual
    when ``num_class`` is given (8 maps), else the 4 level features."""

    def __init__(self, channels=(768, 384, 192, 96), num_class=None,
                 use_softmax: bool = True):
        super().__init__()
        self.num_class, self.use_softmax = num_class, use_softmax
        f = (channels[0] * 2,) + tuple(channels)  # (1536, 768, 384, 192, 96)
        self.block_5 = _Bottleneck(channels[0], f[0], HEADS[0])
        for i in range(1, 5):
            setattr(self, f"block_{5 + i}", _DecoderBlock(
                f[i - 1], channels[i - 1], f[i], HEADS[i]))
        if num_class is not None:
            for i in range(1, 5):
                for side in ("fg", "bg"):
                    setattr(self, f"out_head{i}_{side}",
                            nn.Conv2d(f[i], num_class, 1))

    def _heads(self, i: int, d):
        return (getattr(self, f"out_head{i}_fg")(d),
                getattr(self, f"out_head{i}_bg")(d))

    def forward(self, skip1, skip2, skip3, skip4):
        d = self.block_6(self.block_5(skip4), skip4)
        if self.num_class is None:
            feats = [d]
            for blk, skip in ((self.block_7, skip3), (self.block_8, skip2),
                              (self.block_9, skip1)):
                d = blk(d, skip)
                feats.append(d)
            return feats
        prev_fg, prev_bg = self._heads(1, d)
        fg, bg = [prev_fg], [prev_bg]
        for i, (blk, skip) in enumerate(((self.block_7, skip3),
                                         (self.block_8, skip2),
                                         (self.block_9, skip1)), start=2):
            d = blk(d, skip)
            size = tuple(d.shape[-2:])
            d_fg, d_bg = self._heads(i, d)
            d_fg = dsra_gate(d_fg, resize_bilinear(prev_fg, size),
                             resize_bilinear(prev_bg, size), self.use_softmax)
            fg.append(d_fg)
            bg.append(d_bg)
            prev_fg, prev_bg = d_fg, d_bg
        return fg + bg


class MISTCAM(nn.Module):
    """The full MIST network (``networks.py:39-132``)."""

    def __init__(self, num_classes: int = 9, img_size_s1=(256, 256),
                 model_scale: str = "small", dual: bool = True,
                 use_softmax: bool = True):
        super().__init__()
        self.dual, self.img_size_s1 = dual, tuple(img_size_s1)
        self.conv = nn.Sequential(nn.Conv2d(1, 3, 1),
                                  nn.BatchNorm2d(3, eps=1e-5, momentum=0.1),
                                  nn.ReLU())
        self.backbone1 = MaxxVit(**MAXVIT_CONFIGS["maxxvit_rmlp_small_rw_256"])
        channels = (768, 384, 192, 96)
        self.decoder = CAMDecoder(channels, num_classes if dual else None,
                                  use_softmax)
        if not dual:
            for i, c in enumerate(channels, start=1):
                setattr(self, f"out_head{i}", nn.Conv2d(c, num_classes, 1))

    def forward(self, x):
        x = x.to(self.conv[0].weight.dtype)  # every conv has the compute type
        if x.shape[1] == 1:
            x = self.conv(x)
        size = tuple(x.shape[-2:])
        f = self.backbone1(resize_bilinear(x, self.img_size_s1))
        outs = self.decoder(*f)
        if not self.dual:
            outs = [getattr(self, f"out_head{i}")(d)
                    for i, d in enumerate(outs, start=1)]
        return tuple(resize_bilinear(m, size) for m in outs)


@register_model("mist_cam")
def _mist_cam(**kw):
    return MISTCAM(**kw)


# ---------------------------------------------------------------------------
# the reference MIST module's standalone attention utilities
# ---------------------------------------------------------------------------


class ChannelAttentionCBAM(nn.Module):
    """The sigmoid channel gate of a bias-free MLP over the average and
    max pools (``MIST.py:102-118``)."""

    def __init__(self, channels: int, reduction_ratio: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction_ratio, 1,
                             bias=False)
        self.fc2 = nn.Conv2d(channels // reduction_ratio, channels, 1,
                             bias=False)

    def forward(self, x):
        mlp = lambda t: self.fc2(torch.relu(self.fc1(t)))
        return torch.sigmoid(mlp(x.mean(dim=(2, 3), keepdim=True))
                             + mlp(x.amax(dim=(2, 3), keepdim=True)))


class SEBlock(nn.Module):
    """Squeeze and excitation (``MIST.py:121-136``); returns the gated x."""

    def __init__(self, channels: int, reduction_ratio: int = 16):
        super().__init__()
        self.excitation = nn.Sequential(
            nn.Linear(channels, channels // reduction_ratio), nn.ReLU(),
            nn.Linear(channels // reduction_ratio, channels))

    def forward(self, x):
        y = self.excitation(x.mean(dim=(2, 3)))
        return x * torch.sigmoid(y)[:, :, None, None]


class SpatialAttentionCBAM(nn.Module):
    """The sigmoid gate of a k x k conv over the channels' [mean, max]
    (``MIST.py:139-154``); k is 3 or 7."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        if kernel_size not in (3, 7):
            raise ValueError(f"kernel_size must be 3 or 7, got {kernel_size}")
        self.conv = nn.Conv2d(2, 1, kernel_size, 1, kernel_size // 2,
                              bias=False)

    def forward(self, x):
        s = torch.cat([x.mean(dim=1, keepdim=True),
                       x.amax(dim=1, keepdim=True)], 1)
        return torch.sigmoid(self.conv(s))


class CBAM(nn.Module):
    """``x * channel_gate + x * spatial_gate`` (``MIST.py:157-167``).  The
    reference also builds an SE member its forward never uses; the port
    leaves it out, as the JAX package does."""

    def __init__(self, channels: int, reduction_ratio: int = 16,
                 kernel_size: int = 7):
        super().__init__()
        self.channel_attention = ChannelAttentionCBAM(channels,
                                                      reduction_ratio)
        self.spatial_attention = SpatialAttentionCBAM(kernel_size)

    def forward(self, x):
        return (x * self.channel_attention(x)
                + x * self.spatial_attention(x))

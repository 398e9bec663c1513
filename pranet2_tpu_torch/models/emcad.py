"""EMCAD: the efficient multi-scale convolutional attention decoder, with
PraNet-V2's DSRA dual heads, the multiclass model of Synapse and ACDC.

Port of ``pranet2_tpu/models/emcad.py`` with the reference checkpoint's
attribute names (``multiclass_seg/EMCAD/lib/decoders.py``,
``lib/networks.py``; the inverse of ``emcad_key_map``,
``pranet2_tpu/utils/torch_convert.py:222``): ``backbone.*``,
``decoder.{mscb{i}.0,eucb{i},lgag{i},cab{i},sab,ConvBlock{i}_{fg,bg}}``,
the grayscale stem ``conv.{0,1}`` and the single-output ``out_head{i}``.

* MSCB: pointwise expand (x expansion) -> depthwise convs of each kernel
  size (``groups`` = channels), in parallel or each on the running sum
  (``dw_parallel``), summed (``add``) or concatenated -> channel shuffle by
  gcd(combined, out) -> pointwise project; a 1x1-projected skip on a channel
  change.
* EUCB: nearest x2 upsample -> depthwise 3x3 + BN + ReLU -> pointwise conv
  (the reference's shuffle by the channel count is the identity).
* LGAG: ``x * sigmoid(psi(relu(W_g g + W_x x)))``, ``W_g`` and ``W_x``
  grouped convs of ``channels // 2`` groups (one group for a 1x1 kernel).
* CAB: one shared bias-free MLP (``fc1``, ``fc2``, ratio ``min(16, c)``)
  over the global average and max pools.  SAB: a 7x7 conv on the
  channels' [mean, max]; one SAB is shared by the four levels.
* Decoder: per level CAB * SAB -> MSCB, EUCB up, LGAG-gated skip add.
  Dual (``num_class`` given): fg and bg ``ConvBN`` heads at each level; from
  level 3 on, the fg map is gated by ``ops.dsra_gate`` with the previous
  level's fg and bg maps resized bilinearly to its size
  (``decoders.py:407-526``).  The gate is the autograd Function: the hand
  kernel forward on the card in eval and in training alike, a backward
  through its plain math.
* EMCADNet: the 1 -> 3 channel stem on 1-channel input, the encoder, the
  decoder; dual returns 8 maps at input size (fg of levels 4..1, coarse to
  fine, then bg), single 4 ``out_head{4-i}`` maps (biased 1x1).

Encoders: PVTv2 b0-b5 and ResNet 18-152.  Their kernel sites follow F1,
F5 and F6: PVTv2's ``stage_route`` takes the module chain in training or
wherever autograd records, ResNet's ``stem_tail`` likewise, so the PVT
kernels and ``stem_pool`` run only in eval with autograd off.

Each forward is one ``model.forward`` span (``utils.profiling.span``,
recorded only while recording is on).

``activation="gelu"`` is flax's ``nn.gelu``, the tanh approximation, as the
JAX package computes it (the reference's ``nn.GELU()`` is exact erf).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from pranet2_tpu_torch.models.backbones.pvtv2 import pvt_v2
from pranet2_tpu_torch.models.backbones.resnet import resnet
from pranet2_tpu_torch.models.registry import register_model
from pranet2_tpu_torch.nn import ConvBN
from pranet2_tpu_torch.ops import dsra_gate, resize_bilinear, upsample_nearest
from pranet2_tpu_torch.utils.profiling import span

# encoder -> stage channels, deepest first (``emcad.py:284-298``)
PVT_CHANNELS = {"pvt_v2_b0": (256, 160, 64, 32),
                **{f"pvt_v2_b{i}": (512, 320, 128, 64) for i in range(1, 6)}}
RESNET_CHANNELS = {"resnet18": (512, 256, 128, 64),
                   "resnet34": (512, 256, 128, 64),
                   **{f"resnet{d}": (2048, 1024, 512, 256)
                      for d in (50, 101, 152)}}


def act_layer(name: str) -> nn.Module:
    """The activation ``name`` as the JAX package computes it."""
    layers = {"relu": nn.ReLU, "relu6": nn.ReLU6,
              "gelu": lambda: nn.GELU(approximate="tanh"),
              "leakyrelu": lambda: nn.LeakyReLU(0.2),
              "hswish": nn.Hardswish}
    if name not in layers:
        raise ValueError(f"unknown activation {name!r}; available: "
                         f"{sorted(layers)}")
    return layers[name]()


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Interleave ``groups`` channel groups of an NCHW tensor: output
    channel ``a * groups + g`` is input channel ``g * (C // groups) + a``,
    the JAX package's NHWC reshape and swap."""
    n, c, h, w = x.shape
    return (x.view(n, groups, c // groups, h, w).transpose(1, 2)
            .reshape(n, c, h, w))


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def _conv_bn(cin: int, cout: int, k: int = 1, groups: int = 1,
             bias: bool = False, act: str | None = None) -> nn.Sequential:
    """conv (``k // 2`` padding) + BN (+ the activation): the reference's
    ``Sequential(Conv2d, BatchNorm2d[, act])``."""
    layers = [nn.Conv2d(cin, cout, k, 1, k // 2, groups=groups, bias=bias),
              _bn(cout)]
    return nn.Sequential(*layers, *([act_layer(act)] if act else []))


class MSDC(nn.Module):
    """The depthwise convolutions of MSCB, one per kernel size."""

    def __init__(self, channels: int, kernel_sizes, stride: int,
                 activation: str, dw_parallel: bool):
        super().__init__()
        self.dw_parallel = dw_parallel
        self.dwconvs = nn.ModuleList(
            nn.Sequential(nn.Conv2d(channels, channels, k, stride, k // 2,
                                    groups=channels, bias=False),
                          _bn(channels), act_layer(activation))
            for k in kernel_sizes)

    def forward(self, x):
        outs = []
        for dwconv in self.dwconvs:
            out = dwconv(x)
            outs.append(out)
            if not self.dw_parallel:
                x = x + out
        return outs


class MSCB(nn.Module):
    """Multi-scale (inverted residual) convolution block."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 kernel_sizes=(1, 3, 5), expansion_factor: int = 2,
                 dw_parallel: bool = True, add: bool = True,
                 activation: str = "relu6"):
        super().__init__()
        self.stride, self.add = stride, add
        ex = in_channels * expansion_factor
        self.pconv1 = _conv_bn(in_channels, ex, act=activation)
        self.msdc = MSDC(ex, kernel_sizes, stride, activation, dw_parallel)
        combined = ex if add else ex * len(kernel_sizes)
        self.shuffle_groups = math.gcd(combined, out_channels)
        self.pconv2 = _conv_bn(combined, out_channels)
        if stride == 1 and in_channels != out_channels:
            self.conv1x1 = nn.Conv2d(in_channels, out_channels, 1, bias=False)

    def forward(self, x):
        outs = self.msdc(self.pconv1(x))
        d = sum(outs) if self.add else torch.cat(outs, 1)
        out = self.pconv2(channel_shuffle(d, self.shuffle_groups))
        if self.stride != 1:
            return out
        skip = self.conv1x1(x) if hasattr(self, "conv1x1") else x
        return skip + out


class UpsampleNearest(nn.Module):
    """``ops.upsample_nearest`` as a module (EUCB's ``up_dwc.0``)."""

    def __init__(self, scale: int = 2):
        super().__init__()
        self.scale = scale

    def forward(self, x):
        return upsample_nearest(x, self.scale)


class EUCB(nn.Module):
    """Efficient up-convolution: nearest x2 -> depthwise k x k + BN +
    activation -> pointwise conv (biased)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, activation: str = "relu"):
        super().__init__()
        k = kernel_size
        self.up_dwc = nn.Sequential(
            UpsampleNearest(2),
            nn.Conv2d(in_channels, in_channels, k, 1, k // 2,
                      groups=in_channels, bias=False),
            _bn(in_channels), act_layer(activation))
        self.pwc = nn.Sequential(nn.Conv2d(in_channels, out_channels, 1))

    def forward(self, x):
        return self.pwc(self.up_dwc(x))


class LGAG(nn.Module):
    """Large-kernel grouped attention gate ``x * sigmoid(psi(act(W_g g +
    W_x x)))``; ``g`` has ``f_g`` channels, ``x`` ``f_l``."""

    def __init__(self, f_g: int, f_l: int, f_int: int, kernel_size: int = 3,
                 groups: int = 1, activation: str = "relu"):
        super().__init__()
        k = kernel_size
        groups = 1 if k == 1 else groups
        self.W_g = _conv_bn(f_g, f_int, k, groups, bias=True)
        self.W_x = _conv_bn(f_l, f_int, k, groups, bias=True)
        self.psi = _conv_bn(f_int, 1, 1, bias=True)
        self.act = act_layer(activation)

    def forward(self, g, x):
        return x * torch.sigmoid(self.psi(self.act(self.W_g(g) + self.W_x(x))))


class CAB(nn.Module):
    """Channel attention: a shared MLP over the global average and max
    pools; returns the (N, C, 1, 1) gate."""

    def __init__(self, channels: int, ratio: int = 16,
                 activation: str = "relu"):
        super().__init__()
        red = channels // min(ratio, channels)
        self.fc1 = nn.Conv2d(channels, red, 1, bias=False)
        self.fc2 = nn.Conv2d(red, channels, 1, bias=False)
        self.act = act_layer(activation)

    def forward(self, x):
        mlp = lambda t: self.fc2(self.act(self.fc1(t)))
        avg = x.mean(dim=(2, 3), keepdim=True)
        mx = x.amax(dim=(2, 3), keepdim=True)
        return torch.sigmoid(mlp(avg) + mlp(mx))


class SAB(nn.Module):
    """Spatial attention: a k x k conv on the channels' [mean, max];
    returns the (N, 1, H, W) gate."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        k = kernel_size
        self.conv = nn.Conv2d(2, 1, k, 1, k // 2, bias=False)

    def forward(self, x):
        s = torch.cat([x.mean(dim=1, keepdim=True),
                       x.amax(dim=1, keepdim=True)], 1)
        return torch.sigmoid(self.conv(s))


class EMCADDecoder(nn.Module):
    """The 4-level decoder over deepest-first ``channels``; with
    ``num_class`` the dual DSRA heads (8 maps), else the 4 level
    features."""

    def __init__(self, channels, kernel_sizes=(1, 3, 5),
                 expansion_factor: int = 2, dw_parallel: bool = True,
                 add: bool = True, lgag_ks: int = 3,
                 activation: str = "relu6", num_class: int | None = None,
                 use_softmax: bool = True):
        super().__init__()
        ch = tuple(channels)
        self.num_class, self.use_softmax = num_class, use_softmax
        for lvl in (4, 3, 2, 1):
            c = ch[4 - lvl]
            setattr(self, f"mscb{lvl}", nn.Sequential(MSCB(
                c, c, 1, kernel_sizes, expansion_factor, dw_parallel, add,
                activation)))
            setattr(self, f"cab{lvl}", CAB(c))
            if lvl < 4:
                setattr(self, f"eucb{lvl}", EUCB(ch[3 - lvl], c, 3, "relu"))
                setattr(self, f"lgag{lvl}", LGAG(c, c, c // 2, lgag_ks,
                                                 c // 2, "relu"))
            if num_class is not None:
                ks = 1 if lvl == 4 else 3
                for side in ("fg", "bg"):
                    setattr(self, f"ConvBlock{lvl}_{side}",
                            ConvBN(c, num_class, ks, padding=ks // 2))
        self.sab = SAB()

    def _attend(self, lvl: int, d):
        d = getattr(self, f"cab{lvl}")(d) * d
        d = self.sab(d) * d
        return getattr(self, f"mscb{lvl}")(d)

    def _heads(self, lvl: int, d):
        return (getattr(self, f"ConvBlock{lvl}_fg")(d),
                getattr(self, f"ConvBlock{lvl}_bg")(d))

    def forward(self, x, skips):
        """``x`` the deepest stage, ``skips`` the next three, deepest
        first.  Returns [d4, d3, d2, d1], or with heads the fg maps of
        levels 4..1 then their bg maps."""
        d = self._attend(4, x)
        feats = [d]
        if self.num_class is not None:
            prev_fg, prev_bg = self._heads(4, d)
            fg_maps, bg_maps = [prev_fg], [prev_bg]
        for lvl, skip in zip((3, 2, 1), skips):
            d_up = getattr(self, f"eucb{lvl}")(d)
            d = d_up + getattr(self, f"lgag{lvl}")(d_up, skip)
            d = self._attend(lvl, d)
            feats.append(d)
            if self.num_class is not None:
                size = tuple(d_up.shape[-2:])
                d_fg, d_bg = self._heads(lvl, d)
                d_fg = dsra_gate(d_fg, resize_bilinear(prev_fg, size),
                                 resize_bilinear(prev_bg, size),
                                 self.use_softmax)
                fg_maps.append(d_fg)
                bg_maps.append(d_bg)
                prev_fg, prev_bg = d_fg, d_bg
        if self.num_class is None:
            return feats
        return fg_maps + bg_maps


def _encoder(encoder: str):
    if encoder in PVT_CHANNELS:
        return pvt_v2(encoder[-2:]), PVT_CHANNELS[encoder]
    if encoder in RESNET_CHANNELS:
        return resnet(encoder), RESNET_CHANNELS[encoder]
    raise ValueError(f"unknown encoder {encoder!r}; available: "
                     f"{sorted(PVT_CHANNELS) + sorted(RESNET_CHANNELS)}")


class EMCADNet(nn.Module):
    """The full EMCAD network (``networks.py:10-142``).  A PVTv2 encoder
    keeps its defaults, drop path 0.1 in training included, as the JAX
    package builds it (``pvtv2.py:424``)."""

    def __init__(self, num_classes: int = 9, encoder: str = "pvt_v2_b2",
                 kernel_sizes=(1, 3, 5), expansion_factor: int = 2,
                 dw_parallel: bool = True, add: bool = True,
                 lgag_ks: int = 3, activation: str = "relu6",
                 dual: bool = True, use_softmax: bool = True):
        super().__init__()
        self.dual = dual
        # grayscale stem, applied to 1-channel input only
        self.conv = nn.Sequential(nn.Conv2d(1, 3, 1), _bn(3), nn.ReLU())
        self.backbone, channels = _encoder(encoder)
        self.decoder = EMCADDecoder(
            channels, tuple(kernel_sizes), expansion_factor, dw_parallel,
            add, lgag_ks, activation, num_classes if dual else None,
            use_softmax)
        if not dual:
            for i, c in enumerate(channels):
                setattr(self, f"out_head{4 - i}",
                        nn.Conv2d(c, num_classes, 1))

    def forward(self, x):
        with span("model.forward"):
            x = x.to(self.conv[0].weight.dtype)  # every conv: compute type
            if x.shape[1] == 1:
                x = self.conv(x)
            size = tuple(x.shape[-2:])
            x1, x2, x3, x4 = self.backbone(x)
            outs = self.decoder(x4, [x3, x2, x1])
            if not self.dual:
                outs = [getattr(self, f"out_head{4 - i}")(d)
                        for i, d in enumerate(outs)]
            return tuple(resize_bilinear(m, size) for m in outs)


@register_model("emcad")
def _emcad(**kw):
    return EMCADNet(**kw)

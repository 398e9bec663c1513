"""PraNet-V1 (reverse attention) and PraNet-V2 (DSRA), the binary polyp
models, on Res2Net-50-v1b, PVTv2-b2 or ResNet-50.

Port of ``pranet2_tpu/models/pranet.py::PraNetV1`` and ``::PraNetV2`` with
the reference's attribute names: the encoder, ``rfb{2,3,4}_1``, ``agg1``,
``ra{4,3,2}_conv{N}[_fg|_bg]`` and V2's grayscale stem ``conv.{0,1}``.  The
encoder is ``backbone.*``, except in V1 on Res2Net and ResNet, where the
reference calls it ``resnet.*`` (the JAX package: ``backbone`` everywhere).
``pranet_v2`` and ``pranet_v1`` take the Res2Net-50-v1b encoder,
``pvt_pranet_v2`` and ``pvt_pranet_v1`` PVTv2-b2, ``pranet_v1_resnet``
ResNet-50.

V1: the partial decoder's single head gives the coarse map; each branch,
deepest first, multiplies its stage by ``1 - sigmoid(crop)``
(``ops.reverse_attention``, crop the previous map resized to the stage's
size), runs its conv trunk to a 1-channel residual and adds it to the
crop.  Returns 4 maps at input resolution, coarse-first: (map5, map4,
map3, map2).

V2: encoder stages 2-4 -> three RFBs (32 ch) -> dual-head partial decoder ->
coarse fg/bg maps at 1/8 scale.  Each DSRA branch runs its conv trunk on the
raw stage, emits fg/bg heads and gates fg with
``fg + fg * softmax_c(crop_fg - crop_bg)``, crop_* the previous level's maps
resized to the branch's size.  Returns 8 maps at input resolution,
fine-first: (map2_fg, map3_fg, map4_fg, map5_fg, map2_bg, map3_bg, map4_bg,
map5_bg).  In eval with autograd off each level (crops, gate and its maps
at input resolution; level 4 also map5's) is one call of ``ops.dsra_level``,
the kernel on a CUDA tensor; otherwise ``ops.dsra_level_plain``, the chain
of ``resize_bilinear`` and ``ops.dsra_gate``, which has a gradient.
"""

from __future__ import annotations

import torch
from torch import nn

from pranet2_tpu_torch.models.backbones.pvtv2 import pvt_v2
from pranet2_tpu_torch.models.backbones.res2net import Res2Net
from pranet2_tpu_torch.models.backbones.resnet import ResNet
from pranet2_tpu_torch.models.registry import register_model
from pranet2_tpu_torch.nn import RFB, ConvBN, PartialDecoder
from pranet2_tpu_torch.ops import (dsra_gate, dsra_level, dsra_level_plain,
                                   resize_bilinear, reverse_attention)

# level -> (trunk width, trunk convs, trunk kernel, head kernel,
#           head index in the torch names): V2's DSRA branches and V1's
#           reverse-attention branches alike
_DSRA = {4: (256, 3, 5, 1, 5), 3: (64, 2, 3, 3, 4), 2: (64, 2, 3, 3, 4)}
# backbone -> (constructor taking the backbone's keyword arguments,
#              channels of stages 2, 3 and 4)
_BACKBONES = {"res2net50": (lambda **kw: Res2Net(**{"layers": (3, 4, 6, 3),
                                                    **kw}),
                            (512, 1024, 2048)),
              "pvt_v2_b2": (lambda **kw: pvt_v2("b2", **kw),
                            (128, 320, 512)),
              "resnet50": (lambda **kw: ResNet(**{"kind": "bottleneck",
                                                  "layers": (3, 4, 6, 3),
                                                  **kw}),
                           (512, 1024, 2048))}


def _encoder(backbone: str, backbone_kw: dict):
    if backbone not in _BACKBONES:
        raise ValueError(f"unknown backbone {backbone!r}; available: "
                         f"{sorted(_BACKBONES)}")
    make, widths = _BACKBONES[backbone]
    return make(**backbone_kw), dict(zip((2, 3, 4), widths))


def _trunk(model: nn.Module, lvl: int, x):
    """A branch's trunk convs: ``ra{lvl}_conv1``, then the k x k convs,
    each with a ReLU."""
    x = getattr(model, f"ra{lvl}_conv1")(x)
    for i in range(2, 2 + _DSRA[lvl][1]):
        x = torch.relu(getattr(model, f"ra{lvl}_conv{i}")(x))
    return x


def _add_trunk(model: nn.Module, lvl: int, cin: int):
    mid, n_convs, k, _, _ = _DSRA[lvl]
    setattr(model, f"ra{lvl}_conv1", ConvBN(cin, mid, 1))
    for i in range(2, 2 + n_convs):
        setattr(model, f"ra{lvl}_conv{i}", ConvBN(mid, mid, k, padding=k // 2))


class PraNetV1(nn.Module):
    """PraNet-V1.  ``backbone_kw`` go to the backbone's constructor, as in
    ``PraNetV2`` (e.g. ``fused=True, tailfuse=True`` on Res2Net,
    ``attn_impl=`` or ``blockfuse=`` on PVTv2); one it does not take is an
    error.  ``encoder_name`` is the encoder's attribute: ``resnet`` on
    Res2Net and ResNet, ``backbone`` on PVTv2, the reference's names."""

    def __init__(self, backbone: str = "res2net50", channel: int = 32,
                 **backbone_kw):
        super().__init__()
        encoder, widths = _encoder(backbone, backbone_kw)
        self.encoder_name = ("backbone" if backbone.startswith("pvt")
                             else "resnet")
        setattr(self, self.encoder_name, encoder)
        for lvl, cin in widths.items():
            setattr(self, f"rfb{lvl}_1", RFB(cin, channel))
        self.agg1 = PartialDecoder(channel, None)
        for lvl, (mid, n_convs, _, hk, _) in _DSRA.items():
            _add_trunk(self, lvl, widths[lvl])
            setattr(self, f"ra{lvl}_conv{2 + n_convs}",
                    ConvBN(mid, 1, hk, padding=hk // 2))

    def _ra_branch(self, lvl: int, crop, stage):
        """Reverse attention on the stage, the trunk, the 1-channel head;
        returns the head's residual added to the crop."""
        x = _trunk(self, lvl, reverse_attention(crop, stage))
        return getattr(self, f"ra{lvl}_conv{2 + _DSRA[lvl][1]}")(x) + crop

    def forward(self, x):
        x = x.to(self.agg1.conv5.weight.dtype)  # the compute type
        h, w = x.shape[-2:]
        _, x2, x3, x4 = getattr(self, self.encoder_name)(x)
        prev = self.agg1(self.rfb4_1(x4), self.rfb3_1(x3), self.rfb2_1(x2))
        maps = [resize_bilinear(prev, (h, w))]
        for lvl, stage in ((4, x4), (3, x3), (2, x2)):
            prev = self._ra_branch(
                lvl, resize_bilinear(prev, tuple(stage.shape[-2:])), stage)
            maps.append(resize_bilinear(prev, (h, w)))
        return tuple(maps)


class PraNetV2(nn.Module):
    """``backbone_kw`` go to the backbone's constructor, e.g. ``fused=True,
    tailfuse=True`` for Res2Net's kernel branches; one it does not take is
    an error."""

    def __init__(self, backbone: str = "res2net50", channel: int = 32,
                 num_class: int = 1, use_softmax: bool = True,
                 **backbone_kw):
        super().__init__()
        encoder, widths = _encoder(backbone, backbone_kw)
        self.use_softmax = use_softmax
        # grayscale stem, applied to 1-channel input only
        self.conv = nn.Sequential(nn.Conv2d(1, 3, 1),
                                  nn.BatchNorm2d(3, eps=1e-5, momentum=0.1),
                                  nn.ReLU())
        self.backbone = encoder
        for lvl, cin in widths.items():
            setattr(self, f"rfb{lvl}_1", RFB(cin, channel))
        self.agg1 = PartialDecoder(channel, num_class)
        for lvl, (mid, _, _, hk, hi) in _DSRA.items():
            _add_trunk(self, lvl, widths[lvl])
            for side in ("fg", "bg"):
                setattr(self, f"ra{lvl}_conv{hi}_{side}",
                        ConvBN(mid, num_class, hk, padding=hk // 2))

    def _dsra_branch(self, lvl: int, x):
        """Trunk convs on the raw stage, then the fg/bg heads."""
        hi = _DSRA[lvl][4]
        x = _trunk(self, lvl, x)
        return (getattr(self, f"ra{lvl}_conv{hi}_fg")(x),
                getattr(self, f"ra{lvl}_conv{hi}_bg")(x))

    def forward(self, x):
        x = x.to(self.conv[0].weight.dtype)  # every conv has the compute type
        if x.shape[1] == 1:
            x = self.conv(x)
        h, w = x.shape[-2:]
        _, x2, x3, x4 = self.backbone(x)
        ra5_fg, ra5_bg = self.agg1(self.rfb4_1(x4), self.rfb3_1(x3),
                                   self.rfb2_1(x2))
        # the kernel is forward only: the chain, with the gate's Function,
        # wherever autograd records
        kernels = not (self.training or torch.is_grad_enabled())
        fg_maps, bg_maps = [], []
        prev_fg, prev_bg = ra5_fg, ra5_bg
        for lvl, stage in ((4, x4), (3, x3), (2, x2)):
            ra_fg, ra_bg = self._dsra_branch(lvl, stage)
            args = (prev_fg, prev_bg, ra_fg, ra_bg, (h, w), self.use_softmax,
                    lvl == 4)
            gated, map_fg, map_bg, *map5 = (
                dsra_level(*args) if kernels
                else dsra_level_plain(*args, gate=dsra_gate))
            fg_maps.insert(0, map_fg)
            bg_maps.insert(0, map_bg)
            if map5:
                fg_maps.append(map5[0])
                bg_maps.append(map5[1])
            prev_fg, prev_bg = gated, ra_bg
        return (*fg_maps, *bg_maps)


@register_model("pranet_v1")
def _pranet_v1(**kw):
    return PraNetV1(backbone="res2net50", **kw)


@register_model("pvt_pranet_v1")
def _pvt_pranet_v1(**kw):
    return PraNetV1(backbone="pvt_v2_b2", **kw)


@register_model("pranet_v1_resnet")
def _pranet_v1_resnet(**kw):
    """PraNet-V1 on a torchvision-style ResNet-50 (the reference's legacy
    ``PraNet_ResNet.py``): the same heads, another encoder."""
    return PraNetV1(backbone="resnet50", **kw)


@register_model("pranet_v2")
def _pranet_v2(**kw):
    return PraNetV2(backbone="res2net50", **kw)


@register_model("pvt_pranet_v2")
def _pvt_pranet_v2(**kw):
    return PraNetV2(backbone="pvt_v2_b2", **kw)

"""MERIT (multi-scale MaxViT, two backbones, a cascaded decoder, with
PraNet-V2's DSRA dual heads) and the single-backbone MaxViT zoo.

Port of ``pranet2_tpu/models/merit.py`` with the reference checkpoint's
names (``multiclass_seg/MERIT/lib/networks.py``; the inverses of
``merit_key_map`` and ``maxvit_single_key_map``,
``pranet2_tpu/utils/torch_convert.py:399,423``): ``backbone1``,
``backbone2`` (or the zoo's ``backbone``), ``decoder.*``,
``out_head{1-4}``, ``out_head4_in`` and the grayscale stem ``conv.{0,1}``.

* Two MaxViT backbones, one fed the input resized to ``img_size_s1``
  (256), one to ``img_size_s2`` (224): 'small' is
  ``maxxvit_rmlp_small_rw_256`` + ``maxvit_rmlp_small_rw_224``, 'tiny'
  ``maxvit_rmlp_tiny_rw_256`` + ``maxvit_tiny_rw_224`` (the latter with a
  learned bias table), 'dryrun' the JAX package's compile-test backbone
  twice.
* Cascaded: the first backbone -> the decoder -> maps; the finest decoder
  feature through ``out_head4_in`` and a sigmoid gates the input image;
  the second backbone on the gated input, pass one's stage features
  resized and added; the decoder again; each level's maps of both passes
  at input size, summed.  When the input's height is a multiple of 14
  the backbones swap scales (``pranet2_tpu/models/merit.py:98-99``).  The
  decoder and the single mode's ``out_head``s are shared by both passes,
  so a training step updates their BatchNorm statistics twice.
* Parallel: both backbones on the raw input at their scales, one shared
  decoder, the maps summed.
* Dual (the default) decoders emit 8 fg/bg maps (``CascadeAddDual``, 3
  ``dsra_gate`` launches a pass); single ones 4 features, each through a
  shared 1x1 ``out_head``.
* The zoo (``MERIT/lib/networks.py:62-350``): ``maxvit_seg`` (the last
  stage's 1x1 head upsampled, one map), ``maxvit4out`` (a 1x1 head on each
  stage, coarse first) and ``maxvit_cascade`` (a CASCADE decoder and 4
  heads); each on the raw input, the backbone picked by ``img_size``.

``img_size`` (cascaded and zoo): the input side the model serves.  The
'tiny' 224 backbone's bias table is sized for the window it will see
(``backbones/maxvit.py``), which the flip decides from the input; the
CLIs pass ``--img_size`` or the dataset's default.  Nothing else depends
on it.
"""

from __future__ import annotations

from torch import nn

from pranet2_tpu_torch.models.backbones.maxvit import MAXVIT_CONFIGS, MaxxVit
from pranet2_tpu_torch.models.decoders import (CascadeAdd, CascadeAddDual,
                                               CascadeCat)
from pranet2_tpu_torch.models.registry import register_model
from pranet2_tpu_torch.ops import resize_bilinear

# decoder channels, deepest first
_SCALE_CHANNELS = {
    "tiny": (512, 256, 128, 64),
    "small": (768, 384, 192, 96),
    "dryrun": (128, 64, 32, 32),
}
# (the backbone for 256, the backbone for 224)
_SCALE_BACKBONES = {
    "tiny": ("maxvit_rmlp_tiny_rw_256", "maxvit_tiny_rw_224"),
    "small": ("maxxvit_rmlp_small_rw_256", "maxvit_rmlp_small_rw_224"),
    "dryrun": ("maxvit_dryrun", "maxvit_dryrun"),
}


def _gray_stem() -> nn.Sequential:
    """The 1 -> 3 channel stem, applied to 1-channel input only."""
    return nn.Sequential(nn.Conv2d(1, 3, 1),
                         nn.BatchNorm2d(3, eps=1e-5, momentum=0.1), nn.ReLU())


def _backbone(variant: str, side: int) -> MaxxVit:
    return MaxxVit(**MAXVIT_CONFIGS[variant], img_size=side)


def _heads(module: nn.Module, channels, num_classes: int) -> None:
    """``out_head{1-4}``, 1x1 convs on the features deepest first."""
    for i, c in enumerate(channels, start=1):
        setattr(module, f"out_head{i}", nn.Conv2d(c, num_classes, 1))


def _decoder(channels, dual: bool, num_classes: int, use_softmax: bool,
             aggregation: str = "additive") -> nn.Module:
    if dual:
        return CascadeAddDual(channels, num_classes, use_softmax)
    return CascadeAdd(channels) if aggregation == "additive" else (
        CascadeCat(channels))


class _Merit(nn.Module):
    """What both MERIT forms share: the stem, the backbones, the decoder,
    the single mode's heads."""

    def __init__(self, num_classes, model_scale, img_size_s1, img_size_s2,
                 dual, use_softmax, aggregation, sides):
        super().__init__()
        self.dual = dual
        self.img_size_s1, self.img_size_s2 = tuple(img_size_s1), tuple(
            img_size_s2)
        self.conv = _gray_stem()
        bb256, bb224 = _SCALE_BACKBONES[model_scale]
        self.backbone1 = _backbone(bb256, sides[0])
        self.backbone2 = _backbone(bb224, sides[1])
        channels = _SCALE_CHANNELS[model_scale]
        self.decoder = _decoder(channels, dual, num_classes, use_softmax,
                                aggregation)
        if not dual:
            _heads(self, channels, num_classes)

    def _stem(self, x):
        x = x.to(self.conv[0].weight.dtype)  # every conv has the compute type
        return self.conv(x) if x.shape[1] == 1 else x

    def _pass(self, feats):
        """The decoder on a backbone's features; returns the level maps
        (8 dual, else 4 through the heads) and the finest feature."""
        outs = self.decoder(feats[3], [feats[2], feats[1], feats[0]])
        if self.dual:
            return outs[:8], outs[8]
        return ([getattr(self, f"out_head{i + 1}")(f)
                 for i, f in enumerate(outs)], outs[3])


class MERITCascaded(_Merit):
    """MERIT cascaded; ``dual=True`` -> 8 fg/bg maps, else 4 maps."""

    def __init__(self, num_classes: int = 4, model_scale: str = "small",
                 img_size_s1=(256, 256), img_size_s2=(224, 224),
                 decoder_aggregation: str = "additive", dual: bool = True,
                 use_softmax: bool = True, img_size: int = 224):
        flip = img_size % 14 == 0
        s1, s2 = img_size_s1[0], img_size_s2[0]
        super().__init__(num_classes, model_scale, img_size_s1, img_size_s2,
                         dual, use_softmax, decoder_aggregation,
                         (s2, s1) if flip else (s1, s2))
        self.out_head4_in = nn.Conv2d(_SCALE_CHANNELS[model_scale][3], 1, 1)

    def forward(self, x):
        x = self._stem(x)
        size = tuple(x.shape[-2:])
        # the backbones swap scales when H is a multiple of 14
        first, second = ((self.backbone2, self.backbone1)
                         if size[0] % 14 == 0
                         else (self.backbone1, self.backbone2))
        f1 = first(resize_bilinear(x, self.img_size_s1))
        maps1, x14 = self._pass(f1)
        p14 = resize_bilinear(self.out_head4_in(x14).sigmoid(), size)
        maps1 = [resize_bilinear(m, size) for m in maps1]
        f2 = second(resize_bilinear(x * p14, self.img_size_s2))
        fsum = [b + resize_bilinear(a, tuple(b.shape[-2:]))
                for a, b in zip(f1, f2)]
        maps2, _ = self._pass(fsum)
        return tuple(a + resize_bilinear(b, size)
                     for a, b in zip(maps1, maps2))


class MERITParallel(_Merit):
    """MERIT parallel: both backbones on the raw input, one shared decoder,
    the maps summed."""

    def __init__(self, num_classes: int = 4, model_scale: str = "small",
                 img_size_s1=(256, 256), img_size_s2=(224, 224),
                 dual: bool = True, use_softmax: bool = True):
        super().__init__(num_classes, model_scale, img_size_s1, img_size_s2,
                         dual, use_softmax, "additive",
                         (img_size_s1[0], img_size_s2[0]))

    def forward(self, x):
        x = self._stem(x)
        size = tuple(x.shape[-2:])
        maps1, _ = self._pass(self.backbone1(
            resize_bilinear(x, self.img_size_s1)))
        maps2, _ = self._pass(self.backbone2(
            resize_bilinear(x, self.img_size_s2)))
        return tuple(resize_bilinear(a, size) + resize_bilinear(b, size)
                     for a, b in zip(maps1, maps2))


class _Single(nn.Module):
    """The zoo's stem and backbone: the 224 backbone of ``model_scale``
    when ``img_size`` is 224, else its 256 one, on the raw input."""

    def __init__(self, img_size: int, model_scale: str):
        super().__init__()
        self.conv = _gray_stem()
        bb256, bb224 = _SCALE_BACKBONES[model_scale]
        self.backbone = _backbone(bb224 if img_size == 224 else bb256,
                                  img_size)

    def _features(self, x):
        x = x.to(self.conv[0].weight.dtype)
        return self.backbone(self.conv(x) if x.shape[1] == 1 else x)


class MaxViTSeg(_Single):
    """The last stage's 1x1 head, upsampled to the input: one map."""

    def __init__(self, num_classes: int = 1, img_size: int = 224,
                 model_scale: str = "small"):
        super().__init__(img_size, model_scale)
        self.out_head = nn.Conv2d(_SCALE_CHANNELS[model_scale][0],
                                  num_classes, 1)

    def forward(self, x):
        f = self._features(x)
        return resize_bilinear(self.out_head(f[3]), tuple(x.shape[-2:]))


class MaxViT4Out(_Single):
    """A 1x1 head on each stage, no decoder: 4 maps, coarse first."""

    def __init__(self, num_classes: int = 1, img_size: int = 224,
                 model_scale: str = "small"):
        super().__init__(img_size, model_scale)
        _heads(self, _SCALE_CHANNELS[model_scale], num_classes)

    def forward(self, x):
        f = self._features(x)
        size = tuple(x.shape[-2:])
        return tuple(resize_bilinear(getattr(self, f"out_head{i}")(t), size)
                     for i, t in enumerate(f[::-1], start=1))


class MaxViTCascade(_Single):
    """A CASCADE decoder and a 1x1 head on each of its 4 features."""

    def __init__(self, num_classes: int = 1, img_size: int = 224,
                 model_scale: str = "small",
                 decoder_aggregation: str = "additive"):
        super().__init__(img_size, model_scale)
        channels = _SCALE_CHANNELS[model_scale]
        self.decoder = _decoder(channels, False, num_classes, True,
                                decoder_aggregation)
        _heads(self, channels, num_classes)

    def forward(self, x):
        f = self._features(x)
        size = tuple(x.shape[-2:])
        feats = self.decoder(f[3], [f[2], f[1], f[0]])
        return tuple(resize_bilinear(getattr(self, f"out_head{i}")(t), size)
                     for i, t in enumerate(feats, start=1))


@register_model("maxvit_seg")
def _maxvit_seg(**kw):
    return MaxViTSeg(**kw)


@register_model("maxvit4out")
def _maxvit4out(**kw):
    return MaxViT4Out(**kw)


@register_model("maxvit_cascade")
def _maxvit_cascade(**kw):
    return MaxViTCascade(**kw)


@register_model("merit_cascaded")
def _merit_cascaded(**kw):
    return MERITCascaded(**kw)


@register_model("merit_parallel")
def _merit_parallel(**kw):
    return MERITParallel(**kw)

"""torchvision-style ResNet backbone (NCHW): the encoder of
``pranet_v1_resnet`` and an EMCAD encoder option.

Port of ``pranet2_tpu/models/backbones/resnet.py`` with torchvision's
attribute names (``conv1``, ``bn1``, ``layerL.B.conv{1,2,3}``,
``layerL.B.bn{1,2,3}``, ``layerL.B.downsample.{0,1}``), so a torchvision
or reference ``.pth`` loads with ``load_state_dict``.

* Stem: 7x7/2 conv (3 -> 64), bn1, ReLU, 3x3/2 pad-1 maxpool.  In eval
  with autograd off bn1, its ReLU and the pool are one ``ops.stem_pool``
  launch, as in ``Res2Net.stem_tail``: the same op at the same shape (64
  channels, 176 -> 88 at 352x352).  Otherwise bn1, ReLU and
  ``F.max_pool2d``, which has a gradient and sends a tied window's whole
  gradient to its first maximum, as JAX's ``reduce_window`` max does (the
  plain ``ops.max_pool`` would split it: fault F6).
* BasicBlock (resnet18/34): two 3x3 convs, the stride on the first.
  Bottleneck (resnet50/101/152): 1x1, 3x3 (with the stride), 1x1 to
  4x planes.  The first block of a stage whose stride or width changes
  has a ``downsample`` shortcut of a strided 1x1 conv and a BatchNorm.
* Under the trainers' ``remat`` (``nn.remat``) each block runs through
  ``nn.checkpointed``: the same values, its activations rebuilt in the
  backward.  The ``layerL`` Sequentials stay, so the names do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pranet2_tpu_torch.nn import checkpointed
from pranet2_tpu_torch.ops import stem_pool

# variant -> (block kind, blocks per stage)
LAYERS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)


class Block(nn.Module):
    """BasicBlock (``kind="basic"``) or Bottleneck (``"bottleneck"``)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, kind: str = "basic"):
        super().__init__()
        if kind not in ("basic", "bottleneck"):
            raise ValueError(f"unknown block kind {kind!r}")
        self.kind = kind
        if kind == "basic":
            cout = planes
            self.conv1 = _conv(inplanes, planes, 3, stride)
            self.bn1 = _bn(planes)
            self.conv2 = _conv(planes, planes, 3)
            self.bn2 = _bn(planes)
        else:
            cout = planes * 4
            self.conv1 = _conv(inplanes, planes, 1)
            self.bn1 = _bn(planes)
            self.conv2 = _conv(planes, planes, 3, stride)
            self.bn2 = _bn(planes)
            self.conv3 = _conv(planes, cout, 1)
            self.bn3 = _bn(cout)
        self.downsample = (nn.Sequential(_conv(inplanes, cout, 1, stride),
                                         _bn(cout))
                           if has_downsample else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.kind == "bottleneck":
            out = self.bn3(self.conv3(torch.relu(out)))
        short = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + short)


class ResNet(nn.Module):
    """ResNet feature pyramid: ``forward`` returns the four stages
    (strides 4/8/16/32; 64/128/256/512 channels for BasicBlock, 4x that
    for Bottleneck)."""

    def __init__(self, kind: str = "bottleneck", layers=(3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        expansion = 1 if kind == "basic" else 4
        inplanes = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers),
                                              start=1):
            stride = 1 if li == 1 else 2
            seq = [Block(inplanes, planes, stride,
                         stride != 1 or inplanes != planes * expansion, kind)]
            inplanes = planes * expansion
            seq += [Block(inplanes, planes, 1, False, kind)
                    for _ in range(blocks - 1)]
            setattr(self, f"layer{li}", nn.Sequential(*seq))

    def stem_tail(self, z):
        """bn1, ReLU and the 3x3/2 maxpool of the 7x7 conv's output: one
        ``stem_pool`` launch in eval with autograd off, else the module
        chain with ``F.max_pool2d``."""
        if self.training or torch.is_grad_enabled():
            return F.max_pool2d(torch.relu(self.bn1(z)), 3, 2, 1)
        bn = self.bn1
        return stem_pool(z, bn.weight, bn.bias, bn.running_mean,
                         bn.running_var, bn.eps)

    def forward(self, x):
        """(x1, x2, x3, x4); under ``nn.remat`` in training each block is
        ``checkpointed`` (the same values, less memory)."""
        x = self.stem_tail(self.conv1(x))
        feats = []
        for li in range(1, 5):
            for block in getattr(self, f"layer{li}"):
                x = checkpointed(block, x)
            feats.append(x)
        return tuple(feats)


def resnet(variant: str = "resnet50") -> ResNet:
    """``resnet18`` ... ``resnet152`` with random weights (``LAYERS``)."""
    if variant not in LAYERS:
        raise ValueError(f"unknown ResNet variant {variant!r}; available: "
                         f"{sorted(LAYERS)}")
    kind, layers = LAYERS[variant]
    return ResNet(kind=kind, layers=layers)

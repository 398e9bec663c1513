"""Res2Net-v1b backbone (NCHW), the PraNet encoder.

Port of the plain module path of ``pranet2_tpu/models/backbones/res2net.py``,
with the reference's attribute names (``conv1.0``, ``layer1.0.convs.0``,
``layer2.0.downsample.1``, ...), and of its two opt-in kernel branches
(eval with autograd off only, BatchNorms folded from their running
statistics at each forward):

* ``fused``: a whole stride-1 'normal' Bottle2neck in one call of
  ``ops.res2_block.fused_bottle2neck`` (the JAX ``res2block`` component, or
  ``Res2Net(fused=True)``), in float32 or bfloat16;
* ``tailfuse``: the conv3 + BN3 + residual + ReLU tail of every other block
  in one call of ``ops.res2_tail.fused_tail`` (the JAX ``tailfuse``
  component), in bfloat16 only, as JAX enables it.

The JAX package's ``s2d_stem``, ``l1_packed``, ``gstage`` and ``splitmm``
branches are TPU restructures of the same arithmetic and are left out.

* Bottle2neck: 1x1 expand to ``width*scale`` channels, split into ``scale``
  groups; groups 0..scale-2 go through 3x3 conv+BN+ReLU, fed by a running
  sum in 'normal' blocks and independently in 'stage' blocks; the last group
  passes through ('normal') or is 3x3/stride avg-pooled ('stage'); concat,
  1x1 project, residual add, ReLU.  width = floor(planes*26/64), scale = 4.
* Deep stem: three 3x3 convs (3->32->32->64, the first stride 2) with
  BN+ReLU, then the 3x3/2 maxpool: in eval with autograd off bn1, its
  ReLU and the pool in one kernel (``ops.stem.stem_pool``, as the JAX
  package folds bn1 into its bf16 stem), otherwise ``bn1``, ReLU and
  ``F.max_pool2d``, which have a gradient: JAX's module path pools with
  ``reduce_window`` outside any Pallas kernel
  (``pranet2_tpu/models/backbones/res2net.py:350``), and both send the
  whole gradient of a window to its first maximum where values tie (the
  plain ``ops.max_pool``, the kernel's yardstick, would split it).
* Downsample shortcut: stride x stride avg-pool (ceil mode,
  ``count_include_pad=False``), then 1x1 conv + BN.

Under the trainers' ``remat`` (``nn.remat``) the forward runs each block of
``layer1..4`` through ``nn.checkpointed``: the same values, its activations
rebuilt in the backward.  The Sequentials stay, so the names do.

Every kernel is forward only, so each kernel site takes its module chain
whenever ``self.training or torch.is_grad_enabled()``: an eval forward
with autograd on (fine-tuning with frozen BatchNorm, saliency maps) gets
its gradients, and serving (``torch.inference_mode``) the kernels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pranet2_tpu_torch.nn import checkpointed
from pranet2_tpu_torch.ops import avg_pool, res2_block, res2_tail, stem_pool


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def _fold(bn: nn.BatchNorm2d):
    return res2_tail.fold_bn(bn.weight, bn.bias, bn.running_mean,
                             bn.running_var, bn.eps)


class _ShortcutPool(nn.Module):
    """``downsample.0``: AvgPool2d(stride, stride, ceil_mode, no pad count)."""

    def __init__(self, stride: int):
        super().__init__()
        self.stride = stride

    def forward(self, x):
        if self.stride == 1:
            return x
        return avg_pool(x, self.stride, self.stride, 0,
                        count_include_pad=False, ceil_mode=True)


class Bottle2neck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, stype: str = "normal",
                 base_width: int = 26, scale: int = 4, fused: bool = False,
                 tailfuse: bool = False):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64.0)))
        self.width, self.scale, self.stride, self.stype = (
            width, scale, stride, stype)
        self.fused, self.tailfuse = fused, tailfuse
        self.conv1 = nn.Conv2d(inplanes, width * scale, 1, bias=False)
        self.bn1 = _bn(width * scale)
        nums = 1 if scale == 1 else scale - 1
        self.convs = nn.ModuleList(
            nn.Conv2d(width, width, 3, stride, 1, bias=False)
            for _ in range(nums))
        self.bns = nn.ModuleList(_bn(width) for _ in range(nums))
        cout = planes * self.expansion
        self.conv3 = nn.Conv2d(width * scale, cout, 1, bias=False)
        self.bn3 = _bn(cout)
        self.downsample = (nn.Sequential(
            _ShortcutPool(stride),
            nn.Conv2d(inplanes, cout, 1, bias=False),
            _bn(cout),
        ) if has_downsample else None)

    def fused_args(self):
        """``fused_bottle2neck``'s weights (views of the conv weights, the
        three 3x3 kernels stacked) and BatchNorms folded now."""
        cout, c4 = self.conv3.weight.shape[:2]
        s1, t1 = _fold(self.bn1)
        sd, td = (torch.stack(v) for v in zip(*map(_fold, self.bns)))
        return (self.conv1.weight.view(c4, -1), s1, t1,
                torch.stack([c.weight for c in self.convs]), sd, td,
                self.conv3.weight.view(cout, c4), *_fold(self.bn3))

    def forward(self, x):
        kernels = not (self.training or torch.is_grad_enabled())
        if (self.fused and kernels and self.stype == "normal"
                and self.stride == 1 and self.downsample is None
                and self.scale == res2_block.SCALE):
            return res2_block.fused_bottle2neck(x, *self.fused_args())
        out = torch.relu(self.bn1(self.conv1(x)))
        spx = torch.split(out, self.width, 1)
        parts = []
        sp = None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = spx[i] if (i == 0 or self.stype == "stage") else sp + spx[i]
            sp = torch.relu(bn(conv(sp)))
            parts.append(sp)
        if self.scale != 1:
            if self.stype == "normal":
                parts.append(spx[-1])
            else:
                parts.append(avg_pool(spx[-1], 3, self.stride, 1))
        out = torch.cat(parts, 1)
        short = x if self.downsample is None else self.downsample(x)
        w3 = self.conv3.weight
        if self.tailfuse and kernels and w3.dtype == torch.bfloat16:
            return res2_tail.fused_tail(out, short, w3.view(w3.shape[0], -1),
                                        *_fold(self.bn3))
        return torch.relu(self.bn3(self.conv3(out)) + short)


class Res2Net(nn.Module):
    """Res2Net-v1b feature pyramid.

    ``forward`` returns (x1, x2, x3, x4) at strides 4/8/16/32 with 256/512/
    1024/2048 channels, the stages PraNet reads.  ``fused`` and
    ``tailfuse`` choose the kernel branches of every Bottle2neck (see the
    module docstring); they change no parameter or buffer.
    """

    def __init__(self, layers=(3, 4, 6, 3), base_width: int = 26,
                 scale: int = 4, fused: bool = False, tailfuse: bool = False):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.Conv2d(3, 32, 3, 2, 1, bias=False), _bn(32),
            nn.ReLU(),
            nn.Conv2d(32, 32, 3, 1, 1, bias=False), _bn(32), nn.ReLU(),
            nn.Conv2d(32, 64, 3, 1, 1, bias=False),
        )
        self.bn1 = _bn(64)
        inplanes = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers),
                                              start=1):
            stride = 1 if li == 1 else 2
            seq = []
            for bi in range(blocks):
                if bi == 0:
                    seq.append(Bottle2neck(
                        inplanes, planes, stride,
                        stride != 1 or inplanes != planes * 4, "stage",
                        base_width, scale, fused, tailfuse))
                    inplanes = planes * 4
                else:
                    seq.append(Bottle2neck(inplanes, planes, 1, False,
                                           "normal", base_width, scale,
                                           fused, tailfuse))
            setattr(self, f"layer{li}", nn.Sequential(*seq))

    def stem_tail(self, z):
        """bn1, ReLU and the 3x3/2 maxpool of the deep stem's output: one
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


def res2net50_v1b(**kw) -> Res2Net:
    """Res2Net-50-v1b (layers 3, 4, 6, 3), PraNet's encoder; ``kw`` are
    ``Res2Net``'s kernel options (``fused``, ``tailfuse``)."""
    return Res2Net(layers=(3, 4, 6, 3), **kw)


def res2net101_v1b(**kw) -> Res2Net:
    """Res2Net-101-v1b (layers 3, 4, 23, 3), as JAX's
    ``res2net101_v1b``; no model of either package builds it."""
    return Res2Net(layers=(3, 4, 23, 3), **kw)

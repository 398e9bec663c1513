"""Shared building blocks (NCHW), named after the reference's torch modules.

Port of ``pranet2_tpu/nn.py``: ``ConvBN`` (the reference's ``BasicConv2d``),
``RFB``, the dual-head ``PartialDecoder`` and ``DropPath`` (stochastic
depth).  BatchNorm is
``nn.BatchNorm2d(eps=1e-5, momentum=0.1)``.  The JAX package's ``decdot``
and ``splitconv`` paths are TPU layout rewrites of the same convolutions and
are not carried over.

``LayerNorm`` is flax's ``LayerNorm(dtype=...)``: float32 statistics in the
E[x^2] - mu^2 form, float32 parameters, the result in the input's type.

Reduced precision: ``set_compute_dtype`` casts the convolutions and Linears
and keeps every BatchNorm and LayerNorm in float32, as the JAX package keeps
its parameters and statistics in float32 while computing in bfloat16.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from pranet2_tpu_torch.ops import resize_bilinear


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis with flax's arithmetic.

    Statistics in float32 (float64 for a float64 input, as flax computes
    under x64) with var = E[x^2] - mu^2 (clipped at 0), then
    ``(x - mu) * (rsqrt(var + eps) * weight) + bias`` and a cast back to the
    input's type.  The parameters stay float32 whatever the input's type.
    """

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mu = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(x.dtype)


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """Per-sample stochastic depth (timm ``DropPath``, scale_by_keep=True),
    as ``pranet2_tpu/nn.py:82-95``.

    Identity at rate 0 or outside training; otherwise zeroes whole samples
    with probability ``rate`` and rescales the others by 1/keep.  The
    draws come from ``generator`` (torch's default generator when None),
    on the generator's device.
    """
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    dev = x.device if generator is None else generator.device
    mask = torch.rand(shape, generator=generator, device=dev) < keep
    return torch.where(mask.to(x.device), x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    """``drop_path`` at a fixed rate, drawing from ``self.generator``, which
    the trainer sets (the JAX package folds its dropout key by the step).
    It holds no parameter or buffer: a model's ``state_dict`` is the same
    with it."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: torch.Generator | None = None

    def forward(self, x):
        return drop_path(x, self.rate, self.training, self.generator)


class ConvBN(nn.Module):
    """conv (no bias) + BN, no activation (torch ``BasicConv2d``)."""

    def __init__(self, cin: int, cout: int, kernel_size=3, stride: int = 1,
                 padding=0, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, padding,
                              dilation, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)

    def forward(self, x):
        return self.bn(self.conv(x))


class RFB(nn.Module):
    """Receptive-field block: four multi-scale branches, concat-fuse + residual."""

    def __init__(self, cin: int, c: int):
        super().__init__()
        self.branch0 = nn.Sequential(ConvBN(cin, c, 1))
        for i, k in enumerate((3, 5, 7), start=1):
            p = k // 2
            setattr(self, f"branch{i}", nn.Sequential(
                ConvBN(cin, c, 1),
                ConvBN(c, c, (1, k), padding=(0, p)),
                ConvBN(c, c, (k, 1), padding=(p, 0)),
                ConvBN(c, c, 3, padding=k, dilation=k),
            ))
        self.conv_cat = ConvBN(4 * c, c, 3, padding=1)
        self.conv_res = ConvBN(cin, c, 1)

    def forward(self, x):
        xs = [self.branch0(x), self.branch1(x), self.branch2(x),
              self.branch3(x)]
        return torch.relu(self.conv_cat(torch.cat(xs, 1)) + self.conv_res(x))


class PartialDecoder(nn.Module):
    """Cascaded partial decoder with dual fg/bg heads (PraNet-V2).

    Takes the three RFB maps deepest-first (1/32, 1/16, 1/8 scale).  The
    internal x2 upsamples are bilinear with ``align_corners=True``.
    """

    def __init__(self, c: int, num_class: int):
        super().__init__()
        for i in range(1, 5):
            setattr(self, f"conv_upsample{i}", ConvBN(c, c, 3, padding=1))
        self.conv_upsample5 = ConvBN(2 * c, 2 * c, 3, padding=1)
        self.conv_concat2 = ConvBN(2 * c, 2 * c, 3, padding=1)
        self.conv_concat3 = ConvBN(3 * c, 3 * c, 3, padding=1)
        self.conv4 = ConvBN(3 * c, 3 * c, 3, padding=1)
        self.conv5_fg = nn.Conv2d(3 * c, num_class, 1)
        self.conv5_bg = nn.Conv2d(3 * c, num_class, 1)

    def forward(self, x1, x2, x3):
        def up2(t):
            h, w = t.shape[-2:]
            return resize_bilinear(t, (2 * h, 2 * w), align_corners=True)

        x2_1 = self.conv_upsample1(up2(x1)) * x2
        x3_1 = (self.conv_upsample2(up2(up2(x1)))
                * self.conv_upsample3(up2(x2)) * x3)
        x2_2 = self.conv_concat2(
            torch.cat([x2_1, self.conv_upsample4(up2(x1))], 1))
        x3_2 = self.conv_concat3(
            torch.cat([x3_1, self.conv_upsample5(up2(x2_2))], 1))
        x = self.conv4(x3_2)
        return self.conv5_fg(x), self.conv5_bg(x)


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init: LeCun-normal conv and Linear kernels (the JAX
    package's initializer, untruncated), zero biases, identity BatchNorm and
    LayerNorm."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator,
                                           dtype=torch.float32)
                               / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.reset_parameters()
    return model


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every convolution and Linear to ``dtype``; BatchNorm and
    LayerNorm stay float32."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.to(dtype)
    return model

"""Shared building blocks (NCHW), named after the reference's torch modules.

Port of ``pranet2_tpu/nn.py``: ``ConvBN`` (the reference's ``BasicConv2d``),
``RFB``, the ``PartialDecoder`` (dual-head, or V1's single head),
``DropPath`` (stochastic depth) and a seeded ``Dropout``.  BatchNorm is
``nn.BatchNorm2d(eps=1e-5, momentum=0.1)``.  The JAX package's ``decdot``
and ``splitconv`` paths are TPU layout rewrites of the same convolutions and
are not carried over.

``LayerNorm`` is flax's ``LayerNorm(dtype=...)``: float32 statistics in the
E[x^2] - mu^2 form, float32 parameters, the result in the input's type.

GELU: MaxViT and MIST use flax's exact-erf ``nn.gelu(approximate=False)``,
which is torch's default ``nn.GELU()``; EMCAD's "gelu" is the tanh
approximation (``models/emcad.py::act_layer``).

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
              generator: torch.Generator | None = None,
              shard: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Per-sample stochastic depth (timm ``DropPath``, scale_by_keep=True),
    as ``pranet2_tpu/nn.py:82-95``.

    Identity at rate 0 or outside training; otherwise zeroes whole samples
    with probability ``rate`` and rescales the others by 1/keep.  The
    draws come from ``generator`` (torch's default generator when None),
    on the generator's device, for the global batch (``shard``, ``_drop``).
    """
    if not training or rate == 0.0:
        return x
    return _drop(x, rate, (x.shape[0],) + (1,) * (x.dim() - 1), generator,
                 shard)


def _drop(x, rate: float, shape, generator: torch.Generator | None,
          shard: tuple[int, int] = (0, 1)):
    """``x`` with a mask of ``shape`` (broadcast over x) drawn from
    ``generator`` on its device: kept with probability 1 - rate and scaled
    by 1/keep, else zeroed.

    ``shard = (rank, world)``: dim 0 of ``x`` is the batch and ``x`` holds
    rows ``[rank*b, (rank+1)*b)`` of a global batch split over ``world``
    ranks.  The mask is drawn for the global batch (``world * b`` rows)
    and this rank's rows kept, as JAX draws each mask over the global
    batch: every world size trains with the same masks.  A tensor with no
    batch rows keeps ``(0, 1)``: every rank draws the one mask.
    """
    keep = 1.0 - rate
    dev = x.device if generator is None else generator.device
    rank, world = shard
    b = shape[0]
    mask = torch.rand((world * b, *shape[1:]), generator=generator,
                      device=dev)[rank * b:(rank + 1) * b] < keep
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
        self.shard = (0, 1)

    def forward(self, x):
        return drop_path(x, self.rate, self.training, self.generator,
                         self.shard)


class Dropout(nn.Module):
    """Element-wise dropout at a fixed rate (flax's ``nn.Dropout``: keep
    each element with probability 1 - rate, scaled by 1/keep), in training
    only, drawing from ``self.generator`` as ``DropPath`` does (``F.dropout``
    takes no generator).  No parameter or buffer.

    ``batch=False``: the input has no batch rows (MaxViT's relative
    position table), so every rank of a group draws the same mask."""

    def __init__(self, rate: float = 0.0, batch: bool = True):
        super().__init__()
        self.rate = rate
        self.batch = batch
        self.generator: torch.Generator | None = None
        self.shard = (0, 1)

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        return _drop(x, self.rate, x.shape, self.generator, self.shard)


def drop_path_seeder(model: nn.Module, seed: int,
                     shard: tuple[int, int] = (0, 1)):
    """``reseed(step)``: points every ``DropPath`` and ``Dropout`` of
    ``model`` with a rate at one generator on the model's device and seeds
    it from ``seed`` and ``step``, as the JAX package folds its dropout key
    by the step (a no-op for a model without one).  ``shard`` is the
    process group's ``(rank, world)``: each mask over a batch is drawn for
    the global batch (``_drop``); a ``Dropout(batch=False)`` draws the one
    mask on every rank."""
    drops = [m for m in model.modules()
             if isinstance(m, (DropPath, Dropout)) and m.rate > 0]
    gen = (torch.Generator(device=next(model.parameters()).device)
           if drops else None)

    def reseed(step: int) -> None:
        if gen is not None:
            gen.manual_seed(seed * 2 ** 32 + step)
            for m in drops:
                m.generator = gen
                m.shard = (shard if isinstance(m, DropPath) or m.batch
                           else (0, 1))

    return reseed


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
    """Cascaded partial decoder: dual fg/bg heads (PraNet-V2), or with
    ``num_class=None`` the single 1-channel head ``conv5`` of PraNet-V1
    (``pranet2_tpu/nn.py:293-295``).

    Takes the three RFB maps deepest-first (1/32, 1/16, 1/8 scale).  The
    internal x2 upsamples are bilinear with ``align_corners=True``.
    """

    def __init__(self, c: int, num_class: int | None):
        super().__init__()
        self.single = num_class is None
        for i in range(1, 5):
            setattr(self, f"conv_upsample{i}", ConvBN(c, c, 3, padding=1))
        self.conv_upsample5 = ConvBN(2 * c, 2 * c, 3, padding=1)
        self.conv_concat2 = ConvBN(2 * c, 2 * c, 3, padding=1)
        self.conv_concat3 = ConvBN(3 * c, 3 * c, 3, padding=1)
        self.conv4 = ConvBN(3 * c, 3 * c, 3, padding=1)
        if self.single:
            self.conv5 = nn.Conv2d(3 * c, 1, 1)
        else:
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
        if self.single:
            return self.conv5(x)
        return self.conv5_fg(x), self.conv5_bg(x)


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init: LeCun-normal conv and Linear kernels (the JAX
    package's initializer, untruncated; a packed attention in-projection
    as its three (C, C) kernels), zero biases, identity BatchNorm and
    LayerNorm; a module with an ``init_(generator)`` of its own (MaxViT's
    bias table) draws its parameters there."""
    def lecun(weight):
        weight.copy_(torch.randn(weight.shape, generator=generator,
                                 dtype=torch.float32)
                     / math.sqrt(weight[0].numel()))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun(m.weight)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.MultiheadAttention):
                lecun(m.in_proj_weight)
                m.in_proj_bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.reset_parameters()
            elif hasattr(m, "init_"):
                m.init_(generator)
    return model


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every convolution, Linear and packed attention to ``dtype``;
    BatchNorm and LayerNorm stay float32."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.MultiheadAttention)):
            m.to(dtype)
    return model

"""Holding a kernel's output to its plain version's, and random inputs for
the Res2Net kernels' checks.

A PVT block returns ``x + f(x)`` (or a LayerNorm of it), and the residual x
is often ten times larger than what the kernel computes.  A tolerance taken
relative to the output would let a fault in f(x) as large as a bf16 step of
x pass, so ``excess`` scales it by the kernel's own part instead: the
difference between the output and ``base``, the same block's output with
that part taken away (x itself for a residual block).
"""

from __future__ import annotations

import torch

from pranet2_tpu_torch.ops.resize import resize_bilinear


def step(t: torch.Tensor) -> torch.Tensor:
    """Float32 gap between each element of ``t`` and the next value of
    ``t``'s floating type away from zero."""
    _, e = torch.frexp(t.float())
    return torch.exp2(e.float() - 1) * torch.finfo(t.dtype).eps


def excess(got: torch.Tensor, want: torch.Tensor,
           base: torch.Tensor | None, tol: float) -> float:
    """max over elements of |got - want| / allowed, where

        allowed = tol * max|want - base| + (step(want) + step(got)) / 2

    ``tol`` bounds the error of the kernel's part relative to its largest
    value (with ``base`` None the whole output is the kernel's); the half
    steps let each side's last rounding, that of the output itself, fall
    either way.  At most 1 means held.
    """
    g, w = got.float(), want.float()
    scale = (w if base is None else w - base.float()).abs().max()
    allowed = tol * scale + (step(want) + step(got)) / 2
    return ((g - w).abs() / allowed).max().item()


# dsra_level's full-size maps: a one-ulp move of a float32 source
# coordinate can take a tap's weight from one neighbour to the next at
# ratios that are not powers of two, so a map may move by that much of its
# largest |value| beyond its own rounding
LEVEL_MAP_TOL = 1e-5


def level_excess(got, want, out_size, gate_tol: float) -> float:
    """``dsra_level``'s outputs (gated, then the full-size maps) against
    ``dsra_level_plain``'s on the same inputs; at most 1 means held.

    gated is held as the gate is, |got - want| <= gate_tol * (1 + |want|)
    (the softmax's exp and sum may move a rounding).  Each map is held by
    ``excess`` with ``LEVEL_MAP_TOL`` (its own rounding either way, and the
    coordinate's); the map of gated against the resize of the kernel's own
    gated, so that a step the gate took is not counted twice."""
    g0, w0 = got[0].float(), want[0].float()
    over = ((g0 - w0).abs() / (gate_tol * (1 + w0.abs()))).max().item()
    refs = (resize_bilinear(got[0], out_size), *want[2:])
    for g, w in zip(got[1:], refs):
        over = max(over, excess(g, w, None, LEVEL_MAP_TOL))
    return over


def random_bottle2neck(inplanes: int, planes: int, seed: int, device,
                       dtype: torch.dtype, **kw):
    """A Res2Net Bottle2neck in eval mode on ``device``: seeded LeCun-normal
    convolutions in ``dtype`` and random float32 BatchNorms.  ``kw`` go to
    ``Bottle2neck``.

    Each BatchNorm's var is log-uniform in [1e-3, 1] and its weight
    ``sqrt(var) * (1 + 0.1 N)``, so the folded scale stays near 1 while the
    eps matters; bias and mean are ``0.1 N``.
    """
    from pranet2_tpu_torch.models.backbones.res2net import Bottle2neck
    from pranet2_tpu_torch.nn import init_weights_, set_compute_dtype

    g = torch.Generator().manual_seed(seed)
    block = init_weights_(Bottle2neck(inplanes, planes, **kw), g)
    with torch.no_grad():
        for bn in block.modules():
            if isinstance(bn, torch.nn.BatchNorm2d):
                c = bn.num_features
                var = 10.0 ** (-3.0 * torch.rand(c, generator=g))
                bn.running_var.copy_(var)
                bn.weight.copy_(var.sqrt()
                                * (1.0 + 0.1 * torch.randn(c, generator=g)))
                bn.bias.copy_(0.1 * torch.randn(c, generator=g))
                bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
    return set_compute_dtype(block.to(device), dtype).eval()

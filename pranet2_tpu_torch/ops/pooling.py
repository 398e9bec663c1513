"""Pooling with PyTorch semantics on NCHW tensors.

Port of ``pranet2_tpu/ops/pooling.py``.  The JAX package re-creates
``F.avg_pool2d``'s ceil-mode and ``count_include_pad`` rules; here they are
PyTorch's own.  ``max_pool`` is written as shifted maxes over a -inf-padded
map: it is the plain version the stem maxpool kernel is held against (in
the tests and ``chip_smoke.py``), so it does not call ``F.max_pool2d``.  No
model differentiates it: ``torch.maximum`` splits the gradient between tied
inputs, where JAX's ``reduce_window`` max and ``F.max_pool2d`` send all of
it to the first maximum, so the Res2Net stem trains on ``F.max_pool2d``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def avg_pool(x: torch.Tensor, kernel_size, stride=None, padding=0,
             count_include_pad: bool = True, ceil_mode: bool = False
             ) -> torch.Tensor:
    """``F.avg_pool2d`` (sums in float32 for reduced-precision inputs)."""
    return F.avg_pool2d(x, kernel_size, stride, padding, ceil_mode=ceil_mode,
                        count_include_pad=count_include_pad)


def avg_pool_same(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Stride-1, 'same'-size average pool (``F.avg_pool2d(x, k, 1, k//2)``,
    padding counted), the structure loss's boundary weight."""
    return avg_pool(x, kernel_size, 1, kernel_size // 2)


def max_pool(x: torch.Tensor, kernel_size, stride=None, padding=0
             ) -> torch.Tensor:
    """``F.max_pool2d`` semantics (floor mode), as kh*kw shifted maxes."""
    kh, kw = _pair(kernel_size)
    sh, sw = (kh, kw) if stride is None else _pair(stride)
    ph, pw = _pair(padding)
    n, c, h, w = x.shape
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w + 2 * pw - kw) // sw + 1
    xp = F.pad(x, (pw, pw, ph, ph), value=float("-inf"))
    out = None
    for i in range(kh):
        for j in range(kw):
            tap = xp[:, :, i:i + sh * (oh - 1) + 1:sh, j:j + sw * (ow - 1) + 1:sw]
            out = tap if out is None else torch.maximum(out, tap)
    return out

"""Bilinear resize with ``F.interpolate`` semantics, on NCHW tensors.

Port of ``pranet2_tpu/ops/resize.py``.  The model mixes both coordinate
conventions: ``align_corners=True`` for the partial decoder's x2 upsamples,
``False`` everywhere else.  Device resizes compute in float32 at least and
cast back, as the JAX package does.  ``resize_bilinear_np`` is the host copy
for post-processing at each image's native size; it uses the same 1-D
interpolation matrices as the JAX package's host resize.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Resize an (N, C, H, W) tensor to ``size=(H, W)``, torch-bilinear."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    ct = torch.promote_types(x.dtype, torch.float32)
    y = F.interpolate(x.to(ct), size=tuple(size), mode="bilinear",
                      align_corners=align_corners)
    return y.to(x.dtype)


def upsample(x: torch.Tensor, scale: float, align_corners: bool = False
             ) -> torch.Tensor:
    """``F.interpolate(x, scale_factor=scale)``: output size floor(in * scale)."""
    h, w = x.shape[-2:]
    return resize_bilinear(x, (int(h * scale), int(w * scale)), align_corners)


@functools.lru_cache(maxsize=None)
def _interp_matrix(src: int, dst: int, align_corners: bool) -> np.ndarray:
    """Dense (dst, src) 1-D bilinear interpolation matrix, torch semantics."""
    if dst == src:
        return np.eye(dst, dtype=np.float64)
    out = np.zeros((dst, src), dtype=np.float64)
    if align_corners:
        if dst == 1:
            coords = np.zeros((1,))
        else:
            coords = np.arange(dst) * (src - 1) / (dst - 1)
    else:
        scale = src / dst
        coords = np.maximum((np.arange(dst) + 0.5) * scale - 0.5, 0.0)
    i0 = np.clip(np.floor(coords).astype(np.int64), 0, src - 1)
    i1 = np.minimum(i0 + 1, src - 1)
    frac = coords - i0
    rows = np.arange(dst)
    np.add.at(out, (rows, i0), 1.0 - frac)
    np.add.at(out, (rows, i1), frac)
    out.flags.writeable = False  # shared by every caller through the cache
    return out


def resize_bilinear_np(x: np.ndarray, size: tuple[int, int],
                       align_corners: bool = False) -> np.ndarray:
    """Host (numpy) torch-bilinear resize of the last two axes (..., H, W)."""
    h_out, w_out = size
    x = np.asarray(x)
    x = x.astype(np.promote_types(x.dtype, np.float32))
    h, w = x.shape[-2:]
    if (h, w) != (h_out, w_out):
        wh = _interp_matrix(h, h_out, align_corners).astype(x.dtype)
        ww = _interp_matrix(w, w_out, align_corners).astype(x.dtype)
        x = np.einsum("ah,...hw->...aw", wh, x)
        x = np.einsum("bw,...aw->...ab", ww, x)
    return x

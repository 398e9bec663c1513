"""Seeded CT-like volumes made on the device in bulk, as the Synapse test
set's preprocessing gives them (``preprocess_synapse_data.py:28-46``): HU
clipped to [-125, 275] and scaled to [0, 1], float32, (D, H, W).

Each volume is a body (an ellipse of soft tissue in air) holding eight
organ-like blobs, one per foreground class of Synapse, each an ellipsoid
whose surface is wobbled by a smooth random field, at the class's
contrast-enhanced HU level, over per-voxel noise, so that neighbouring
slices differ.  Only the sizes shape the work; the content keeps the
model's labels varied across every slice, so that the labels' check sees
the arithmetic.  A seed gives the same volumes on any run.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

HU_RANGE = (-125.0, 275.0)
BODY_HU, AIR_HU, NOISE_HU = 40.0, -1000.0, 15.0
# aorta, gallbladder, left kidney, right kidney, liver, pancreas, spleen,
# stomach: Synapse's classes 1-8, at portal-venous contrast
ORGAN_HU = (200.0, 10.0, 150.0, 150.0, 60.0, 45.0, 55.0, 25.0)


def _axis(n: int, device) -> torch.Tensor:
    return torch.linspace(-1.0, 1.0, n, device=device)


def ct_volume(depth: int, side: int, g: torch.Generator,
              device) -> torch.Tensor:
    """One (depth, side, side) float32 volume in [0, 1] on ``device``,
    drawn from ``g``."""
    z = _axis(depth, device).view(-1, 1, 1)
    y = _axis(side, device).view(1, -1, 1)
    x = _axis(side, device).view(1, 1, -1)
    body = (x / 0.85) ** 2 + (y / 0.7) ** 2 < 1.0
    hu = torch.where(body, BODY_HU, AIR_HU).expand(depth, side, side).clone()
    lo = (max(2, depth // 16), 12, 12)
    for level in ORGAN_HU:
        c = (torch.rand(3, generator=g, device=device) - 0.5) * 1.1
        r = 0.12 + 0.2 * torch.rand(3, generator=g, device=device)
        wobble = F.interpolate(
            torch.randn((1, 1, *lo), generator=g, device=device),
            size=(depth, side, side), mode="trilinear",
            align_corners=False)[0, 0]
        d2 = (((z - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2
              + ((x - c[2]) / r[2]) ** 2 + 0.3 * wobble)
        hu = torch.where((d2 < 1.0) & body, level, hu)
    hu = hu + NOISE_HU * torch.randn(hu.shape, generator=g, device=device)
    lo_hu, hi_hu = HU_RANGE
    return (hu.clamp(lo_hu, hi_hu) - lo_hu) / (hi_hu - lo_hu)


def ct_volumes(depths, side: int, seed: int, device) -> list[np.ndarray]:
    """One host (D, side, side) float32 array per depth of ``depths``,
    each made on ``device`` from ``seed`` in turn."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [ct_volume(d, side, g, device).cpu().numpy() for d in depths]


def ct_batches(n: int, batch: int, side: int, seed: int,
               device) -> list[torch.Tensor]:
    """``n`` (batch, 1, side, side) batches on ``device``, each the slices
    of one seeded volume ``batch`` deep."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [ct_volume(batch, side, g, device)[:, None] for _ in range(n)]

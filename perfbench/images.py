"""Seeded inputs made on the device in bulk: RGB frames (uint8, HxWx3) at
given sizes, normalised image batches, and training images with masks.

The content is smooth random colour fields with a little grain, and the
masks are smooth blobs; only their sizes shape the work.  A field has the
same number of cells at every size, so that every frame, brought to the
model's input size, shows the same detail (finer detail made the HD
frames' logits six times larger and their masks nearly binary, which
hides the arithmetic's precision from the check).  A seed gives the same
inputs on any run.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

CELLS = 24  # a field's cells along each side, at every size
# ImageNet's mean and deviation, as the published preprocessing uses them
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _fields(g, n: int, h: int, w: int, device) -> torch.Tensor:
    """(n, 3, h, w) float32 in [0, 255]: a coarse random field of
    ``CELLS`` x ``CELLS`` upsampled, plus grain."""
    low = torch.rand((n, 3, CELLS, CELLS), generator=g, device=device)
    x = F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    x = 20.0 + 210.0 * x + 8.0 * torch.randn((n, 3, h, w), generator=g,
                                             device=device)
    return x.clamp(0.0, 255.0)


def rgb_frames(sizes, seed: int, device) -> list[np.ndarray]:
    """One HxWx3 uint8 host array per (h, w) of ``sizes``, drawn on
    ``device`` in one batch per distinct size."""
    g = torch.Generator(device=device).manual_seed(seed)
    out: list = [None] * len(sizes)
    by_size: dict = {}
    for i, hw in enumerate(sizes):
        by_size.setdefault(tuple(hw), []).append(i)
    for (h, w), idx in sorted(by_size.items()):
        x = _fields(g, len(idx), h, w, device).to(torch.uint8)
        host = x.permute(0, 2, 3, 1).contiguous().cpu().numpy()
        for j, i in enumerate(idx):
            out[i] = host[j]
    return out


def normalize(x: torch.Tensor) -> torch.Tensor:
    """uint8-range NCHW float images to the model's input scale."""
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
    return (x / 255.0 - mean) / std


def image_batches(n: int, batch: int, size: int, seed: int,
                  device) -> list[torch.Tensor]:
    """``n`` normalised float32 batches (batch, 3, size, size) on
    ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = normalize(_fields(g, n * batch, size, size, device))
    return list(x.split(batch))


def train_set(n: int, size: int, seed: int, device):
    """``n`` (image, mask) pairs as host float32 arrays, HxWx3 normalised
    and HxWx1 in [0, 1] (the layout the program's datasets give): each
    mask a smooth blob, thresholded softly."""
    g = torch.Generator(device=device).manual_seed(seed)
    img = normalize(_fields(g, n, size, size, device))
    low = torch.randn((n, 1, 6, 6), generator=g, device=device)
    m = F.interpolate(low, size=(size, size), mode="bicubic",
                      align_corners=False)
    mask = torch.sigmoid(4.0 * (m - 0.5))
    img = img.permute(0, 2, 3, 1).contiguous().cpu().numpy()
    mask = mask.permute(0, 2, 3, 1).contiguous().cpu().numpy()
    return [(img[i], mask[i]) for i in range(n)]

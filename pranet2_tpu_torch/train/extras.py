"""Auxiliary training utilities of the reference's utils.

Port of ``pranet2_tpu/train/extras.py``:

* ``poly_lr_schedule``: PolyLR (``EMCAD/utils/misc.py``; the ACDC trainer
  has the poly rule commented out, and no recipe here uses it).
* ``focal_loss``: FocalLoss2d (``EMCAD/utils/misc.py``, unused by the
  reference CLIs but part of its utils), on NCHW logits.
"""

from __future__ import annotations

from collections.abc import Callable

import torch


def poly_lr_schedule(base_lr: float, max_iters: int,
                     power: float = 0.9) -> Callable[[int], float]:
    """lr(step) = base * (1 - clip(step / max_iters, 0, 1)) ** power."""

    def fn(step: int) -> float:
        frac = min(max(step / max_iters, 0.0), 1.0)
        return base_lr * (1.0 - frac) ** power

    return fn


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0,
               weight: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-class focal loss of (N, C, H, W) logits against (N, H, W)
    integer labels, in float32 (as the JAX package's)."""
    logp = torch.log_softmax(logits.float(), dim=1)
    ll = torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    w = (1.0 - torch.exp(ll)) ** gamma
    if weight is not None:
        w = w * weight[labels.long()]
    return -(w * ll).mean()

"""Binary-segmentation losses (PraNet family), NCHW.

Port of ``pranet2_tpu/losses/binary.py``.  ``structure_loss`` is the
reference V2 loss (``binary_seg/MyTrain_med.py:19-38``): boundary-emphasised
weights from a 31x31 average pool, weighted BCE on the fg and bg streams,
weighted IoU on fg, ``wbce + wiou + 0.8 * wbce_bg`` averaged over (batch,
class).  ``structure_loss_v1`` is the classic PraNet-V1 loss (wBCE + wIoU,
no bg stream).  Every loss computes in ``promote_types(dtype, float32)``:
float32 for bf16 and float32 maps, float64 for float64 ones, as JAX under
x64.
"""

from __future__ import annotations

import torch

from pranet2_tpu_torch.ops import avg_pool_same


def _compute_type(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def bce_logits(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits (numerically stable).

    ``torch.maximum`` against zeros, not ``clamp_min``: at a zero logit it
    splits the gradient as ``jnp.maximum`` does."""
    return (torch.maximum(pred, torch.zeros_like(pred)) - pred * target
            + torch.log1p(torch.exp(-pred.abs())))


def _boundary_weight(mask: torch.Tensor) -> torch.Tensor:
    return 1.0 + 5.0 * (avg_pool_same(mask, 31) - mask).abs()


def _weighted_bce_iou(pred, mask, weit):
    """Per (image, class): weighted BCE over the weight's sum, and the
    weighted IoU loss."""
    wsum = weit.sum(dim=(2, 3))
    wbce = (weit * bce_logits(pred, mask)).sum(dim=(2, 3)) / wsum
    p = torch.sigmoid(pred)
    inter = (p * mask * weit).sum(dim=(2, 3))
    union = ((p + mask) * weit).sum(dim=(2, 3))
    return wbce, 1.0 - (inter + 1.0) / (union - inter + 1.0)


def structure_loss(pred: torch.Tensor, pred_bg: torch.Tensor,
                   mask_fg: torch.Tensor, mask_bg: torch.Tensor,
                   weit: torch.Tensor | None = None) -> torch.Tensor:
    """PraNet-V2 dual-supervised structure loss over (N, C, H, W) maps.

    ``weit`` may be precomputed (``_boundary_weight(mask_fg)``) and shared
    across the 4 lateral-map losses (see :func:`structure_loss_multi`).
    """
    ct = _compute_type(pred.dtype)
    pred, pred_bg, mask_fg, mask_bg = (t.to(ct) for t in
                                       (pred, pred_bg, mask_fg, mask_bg))
    if weit is None:
        weit = _boundary_weight(mask_fg)
    wbce, wiou = _weighted_bce_iou(pred, mask_fg, weit)
    wsum = weit.sum(dim=(2, 3))
    wbce2 = (weit * bce_logits(pred_bg, mask_bg)).sum(dim=(2, 3)) / wsum
    return (wbce + wiou + 0.8 * wbce2).mean()


def structure_loss_multi(fg_maps, bg_maps, mask_fg, mask_bg) -> torch.Tensor:
    """Sum of structure losses over the lateral-map pairs with the boundary
    weight computed once (the same math as separate calls; the reference
    recomputes the 31x31 pool per loss, ``MyTrain_med.py:78-82``)."""
    mask_fg = mask_fg.to(_compute_type(mask_fg.dtype))
    weit = _boundary_weight(mask_fg)
    return sum(structure_loss(f, b, mask_fg, mask_bg, weit=weit)
               for f, b in zip(fg_maps, bg_maps))


def structure_loss_v1(pred: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """PraNet-V1 structure loss: weighted BCE + weighted IoU."""
    ct = _compute_type(pred.dtype)
    pred, mask = pred.to(ct), mask.to(ct)
    wbce, wiou = _weighted_bce_iou(pred, mask, _boundary_weight(mask))
    return (wbce + wiou).mean()

"""Multiclass losses and MUTATION powerset supervision (EMCAD, and later
MERIT and MIST), NCHW.

Port of ``pranet2_tpu/losses/multiclass.py``.  The reference behaviour:

* ``dice_loss``: softmax probabilities, per-class dice with smooth 1e-5 as
  ``2*sum(p*t) / (sum(p*p) + sum(t*t))`` over the whole batch, averaged
  over the classes (``multiclass_seg/MERIT/utils/utils.py:106-143``).
* ``mutation_loss``: every non-empty subset of the 4 decoder stages; per
  subset the fg (and bg) logits are summed and supervised with
  ``0.5*CE + 0.7*Dice + 0.3*BCE(bg)`` (dual) or ``0.3*CE + 0.7*Dice``
  (single) (``multiclass_seg/MERIT/train_ACDC.py:243-300``); the bg target
  is ``1 - one_hot(label)``.

Logits are (N, C, H, W): the softmax and the one-hot run over dim 1.
Integer labels are (N, H, W).  Every loss computes in
``promote_types(dtype, float32)``: float32 for bf16 and float32 logits,
float64 for float64 ones, as JAX under x64.
"""

from __future__ import annotations

import itertools
from collections.abc import Sequence

import torch
import torch.nn.functional as F

from pranet2_tpu_torch.losses.binary import bce_logits

SMOOTH = 1e-5


def _compute_type(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def powerset(seq: Sequence[int]) -> list[list[int]]:
    """All non-empty subsets, in the reference's MUTATION order."""
    out = []
    for r in range(1, len(seq) + 1):
        out.extend(list(c) for c in itertools.combinations(seq, r))
    return out


def _one_hot(labels: torch.Tensor, num_classes: int,
             dtype: torch.dtype) -> torch.Tensor:
    """(N, H, W) labels -> (N, C, H, W) one-hot of ``dtype``."""
    return F.one_hot(labels.long(), num_classes).permute(0, 3, 1, 2).to(dtype)


def one_hot_bg(labels: torch.Tensor, num_classes: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-class background mask ``1 - one_hot(label)``, (N, C, H, W)."""
    return 1.0 - _one_hot(labels, num_classes, dtype)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``-log_softmax`` over the class axis (-4: dim 1 of NCHW, dim 2 of a
    stack of them) taken at the labels, broadcast over leading axes."""
    logp = torch.log_softmax(logits, dim=-3)
    idx = labels.long()[:, None].expand(*logits.shape[:-3], 1,
                                        *logits.shape[-2:])
    return -torch.gather(logp, -3, idx)


def softmax_ce_loss(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Mean softmax cross-entropy over all pixels (torch
    ``CrossEntropyLoss``)."""
    return _nll(logits.to(_compute_type(logits.dtype)), labels).mean()


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
              softmax: bool = True) -> torch.Tensor:
    """The reference DiceLoss: per class over the whole batch, squared
    denominator, averaged over the classes."""
    ct = _compute_type(logits.dtype)
    x = logits.to(ct)
    if softmax:
        x = torch.softmax(x, dim=1)
    target = _one_hot(labels, num_classes, ct)
    intersect = (x * target).sum(dim=(0, 2, 3))
    z = (x * x).sum(dim=(0, 2, 3))
    y = (target * target).sum(dim=(0, 2, 3))
    return (1.0 - (2.0 * intersect + SMOOTH) / (z + y + SMOOTH)).mean()


def bce_with_logits(pred: torch.Tensor, target: torch.Tensor
                    ) -> torch.Tensor:
    """Mean BCE with logits (torch ``BCEWithLogitsLoss``, mean reduction)."""
    ct = _compute_type(pred.dtype)
    return bce_logits(pred.to(ct), target.to(ct)).mean()


def supervision_subsets(n_maps: int, supervision: str = "mutation"):
    """Stage-index subsets by supervision mode (``EMCAD/trainer.py:109-121``):
    'mutation' every non-empty subset, 'deep_supervision' the singletons,
    'last_layer' the finest map alone."""
    if supervision == "mutation":
        return powerset(list(range(n_maps)))
    if supervision == "deep_supervision":
        return [[i] for i in range(n_maps)]
    if supervision == "last_layer":
        return [[n_maps - 1]]
    raise ValueError(f"unknown supervision {supervision!r}")


def _subset_sums(maps: Sequence[torch.Tensor], subsets, ct) -> torch.Tensor:
    """(S, N, C, H, W): each subset's maps summed.  Adds, not a product of
    the 0/1 selection matrix, which TF32 would round."""
    stack = torch.stack([m.to(ct) for m in maps])
    return torch.stack([stack[s].sum(0) for s in subsets])


def mutation_loss(fg_maps: Sequence[torch.Tensor], labels: torch.Tensor,
                  num_classes: int,
                  bg_maps: Sequence[torch.Tensor] | None = None,
                  weights: tuple[float, float, float] = (0.5, 0.7, 0.3),
                  single_weights: tuple[float, float] = (0.3, 0.7),
                  supervision: str = "mutation") -> torch.Tensor:
    """MUTATION powerset supervision over the 4 decoder-stage logit maps.

    ``fg_maps`` / ``bg_maps``: 4 NCHW logit maps at the labels' size; dual
    mode when ``bg_maps`` is given, its target derived from the labels.
    The subsets' sums are formed once, then CE, Dice and BCE run as one
    pass over the subset axis, as the JAX package batches them (the
    reference loops over the 15 subsets, ``train_ACDC.py:263-284``).
    """
    subsets = supervision_subsets(len(fg_maps), supervision)
    ct = _compute_type(fg_maps[0].dtype)
    iout = _subset_sums(fg_maps, subsets, ct)                  # (S,N,C,H,W)
    ce = _nll(iout, labels).mean(dim=(1, 2, 3, 4))

    probs = torch.softmax(iout, dim=2)
    target = _one_hot(labels, num_classes, ct)
    intersect = (probs * target).sum(dim=(1, 3, 4))            # (S, C)
    z = (probs * probs).sum(dim=(1, 3, 4))
    y = (target * target).sum(dim=(0, 2, 3))
    dice = (1.0 - (2.0 * intersect + SMOOTH) / (z + y + SMOOTH)).mean(-1)

    if bg_maps is not None:
        lc1, lc2, lc3 = weights
        ibg = _subset_sums(bg_maps, subsets, ct)
        bce = bce_logits(ibg, 1.0 - target).mean(dim=(1, 2, 3, 4))
        per_subset = lc1 * ce + lc2 * dice + lc3 * bce
    else:
        lc1, lc2 = single_weights
        per_subset = lc1 * ce + lc2 * dice
    return per_subset.sum()

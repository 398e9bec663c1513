"""Volumetric segmentation metrics: Dice, HD95, Jaccard, ASSD.

Port (a copy) of ``pranet2_tpu/evalx/volumetric.py``, which reimplements
the medpy binary metrics the reference uses
(``multiclass_seg/MERIT/utils/utils.py:146-158``) with scipy only: surface
extraction by binary erosion (connectivity-1 structuring element) and
exact Euclidean distance transforms, medpy's algorithm, so the values
agree.

Empty-mask conventions follow the reference exactly:
pred>0 & gt>0 -> compute; pred>0 & gt==0 -> (1, 0, 1, 0); else (0, 0, 0, 0).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def _surface_distances(a: np.ndarray, b: np.ndarray, spacing=None) -> np.ndarray:
    """Distances from a's surface voxels to b's surface (medpy algorithm)."""
    footprint = ndimage.generate_binary_structure(a.ndim, 1)
    a_border = a ^ ndimage.binary_erosion(a, structure=footprint, iterations=1)
    b_border = b ^ ndimage.binary_erosion(b, structure=footprint, iterations=1)
    dt = ndimage.distance_transform_edt(~b_border, sampling=spacing)
    return dt[a_border]


def dice_coefficient(pred: np.ndarray, gt: np.ndarray) -> float:
    inter = np.count_nonzero(pred & gt)
    denom = np.count_nonzero(pred) + np.count_nonzero(gt)
    return 2.0 * inter / denom if denom else 0.0


def jaccard(pred: np.ndarray, gt: np.ndarray) -> float:
    inter = np.count_nonzero(pred & gt)
    union = np.count_nonzero(pred | gt)
    return inter / union if union else 0.0


def hd95(pred: np.ndarray, gt: np.ndarray, spacing=None) -> float:
    # medpy.metric.binary.hd95 takes the 95th percentile of the *combined*
    # (hstacked) surface-distance distribution of both directions — NOT the
    # max of per-direction percentiles (that would be a different statistic).
    d1 = _surface_distances(pred, gt, spacing)
    d2 = _surface_distances(gt, pred, spacing)
    return float(np.percentile(np.hstack((d1, d2)), 95))


def assd(pred: np.ndarray, gt: np.ndarray, spacing=None) -> float:
    d1 = _surface_distances(pred, gt, spacing)
    d2 = _surface_distances(gt, pred, spacing)
    return float(np.mean((d1.mean(), d2.mean())))


def calculate_metric_percase(pred: np.ndarray, gt: np.ndarray):
    """(dice, hd95, jaccard, asd) with the reference's empty-mask rules."""
    pred = np.asarray(pred) > 0
    gt = np.asarray(gt) > 0
    if pred.sum() > 0 and gt.sum() > 0:
        return (
            dice_coefficient(pred, gt),
            hd95(pred, gt),
            jaccard(pred, gt),
            assd(pred, gt),
        )
    if pred.sum() > 0 and gt.sum() == 0:
        return 1.0, 0.0, 1.0, 0.0
    return 0.0, 0.0, 0.0, 0.0


def calculate_dice_percase(pred: np.ndarray, gt: np.ndarray) -> float:
    pred = np.asarray(pred) > 0
    gt = np.asarray(gt) > 0
    if pred.sum() > 0 and gt.sum() > 0:
        return dice_coefficient(pred, gt)
    if pred.sum() > 0 and gt.sum() == 0:
        return 1.0
    return 0.0

"""Binary segmentation metric suite (polyp benchmarks).

Copy of ``pranet2_tpu/evalx/binary_metrics.py`` (the port imports nothing
of the JAX package; numpy and scipy only, the same results).

Metric definitions follow the reference evaluation exactly
(``binary_seg/eval.py`` + ``binary_seg/utils/eval_functions.py``): per image —
S-measure, weighted-F, MAE computed once; Precision/Recall/Specificity/Dice/
F-measure/IoU and E-measure swept over 256 thresholds ``linspace(1, 0, 256)``;
per-dataset aggregation is mean-over-images then mean/max over thresholds.

**Rewritten, not translated**: the reference evaluates each threshold by
re-binarising the full image in a Python loop (256 x H x W compares per image,
``eval.py:143-148``).  Here the sweep is closed-form:

* Confusion counts for all thresholds come from two histograms (fg / all
  pixels) cumulated from the top — O(HW + T).
* The E-measure of a *binarised* prediction only depends on the confusion
  counts: with p, g in {0,1}, the enhanced-alignment matrix takes one of four
  values determined by (mu_p, mu_g), so the pixel sum is a weighted sum over
  TP/FP/FN/TN — no per-threshold image pass at all.

Numerics are float64 on host (these run per-image at eval time; the heavy
lifting already happened on the device).
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import convolve, distance_transform_edt

BINARY_METRIC_NAMES = (
    "meanDic", "meanIoU", "wFm", "Sm", "meanEm", "mae",
    "maxEm", "maxDic", "maxIoU", "meanSen", "maxSen", "meanSpe", "maxSpe",
)

_EPS = np.finfo(np.float64).eps
N_THRESHOLDS = 256


def _thresholds() -> np.ndarray:
    return np.linspace(1, 0, N_THRESHOLDS)


# ---------------------------------------------------------------------------
# threshold sweep via histograms (exact, closed form)
# ---------------------------------------------------------------------------


def _threshold_sweep(pred: np.ndarray, gt: np.ndarray) -> dict[str, np.ndarray]:
    """All 256-threshold curves at once.

    pred: float64 in [0,1]; gt: {0,1} float64. Returns arrays of length 256
    (ordered by descending threshold, matching the reference).
    """
    ts = _thresholds()  # descending 1 -> 0
    n = pred.size
    num_obj = float(gt.sum())

    # histogram edges = ascending thresholds, with a top bin catching pred >= 1
    edges = np.concatenate([ts[::-1], [np.inf]])
    h_fg, _ = np.histogram(pred[gt == 1], bins=edges)
    h_all, _ = np.histogram(pred, bins=edges)
    # NumAnd(t_j) = #\{pred >= t_j & gt\}; t_j = edges[255 - j]
    cum_fg = np.cumsum(h_fg[::-1])          # index j ascending == t descending
    cum_all = np.cumsum(h_all[::-1])
    num_and = cum_fg.astype(np.float64)
    num_rec = cum_all.astype(np.float64)

    num_norec = n - num_rec
    fn = num_obj - num_and
    fp = num_rec - num_and
    tn = num_norec - fn

    with np.errstate(divide="ignore", invalid="ignore"):
        pre = num_and / num_rec
        rec = num_and / num_obj
        spe = tn / (tn + fp)
        dic = 2 * num_and / (num_obj + num_rec)
        iou = num_and / (fn + num_rec)
        fm = 2 * pre * rec / (pre + rec)
    # reference: all-zero when NumAnd == 0 (incl. Specificity)
    zero = num_and == 0
    for arr in (pre, rec, spe, dic, iou, fm):
        arr[zero] = 0.0
        np.nan_to_num(arr, copy=False)

    em = _emeasure_binary(num_and, num_rec, num_obj, n)
    return dict(Pr=pre, Rec=rec, Spe=spe, Dic=dic, IoU=iou, Fm=fm, Em=em)


def _emeasure_binary(num_and, num_rec, num_obj, n) -> np.ndarray:
    """E-measure of the binarised prediction, closed-form over thresholds."""
    tp = num_and
    fp = num_rec - num_and
    fn = num_obj - num_and
    tn = n - num_rec - fn

    if num_obj == 0:  # gt empty: enhanced = 1 - pred
        return (n - num_rec) / (n - 1 + _EPS)
    if num_obj == n:  # gt full: enhanced = pred
        return num_rec / (n - 1 + _EPS)

    mu_p = num_rec / n
    mu_g = num_obj / n
    dg1, dg0 = 1.0 - mu_g, -mu_g

    def enhanced(dp, dg):
        align = 2.0 * dg * dp / (dg * dg + dp * dp + _EPS)
        return (align + 1.0) ** 2 / 4.0

    dp1, dp0 = 1.0 - mu_p, -mu_p
    total = (
        tp * enhanced(dp1, dg1)
        + fp * enhanced(dp1, dg0)
        + fn * enhanced(dp0, dg1)
        + tn * enhanced(dp0, dg0)
    )
    return total / (n - 1 + _EPS)


# ---------------------------------------------------------------------------
# once-per-image metrics
# ---------------------------------------------------------------------------


def s_object(pred, gt):
    def obj(p, region):
        x = p[region].mean()
        s = p[region].std()
        return 2.0 * x / (x ** 2 + 1 + s + _EPS)

    pred_fg = np.where(gt != 1, 0.0, pred)
    pred_bg = np.where(gt == 1, 0.0, 1.0 - pred)
    u = gt.mean()
    o_fg = obj(pred_fg, gt == 1) if (gt == 1).any() else 0.0
    o_bg = obj(pred_bg, gt != 1) if (gt != 1).any() else 0.0
    return u * o_fg + (1 - u) * o_bg


def _ssim_q(pred, gt):
    x, y = pred.mean(), gt.mean()
    n = pred.size
    d = n - 1 + _EPS
    sx = (((pred - x) ** 2) / d).sum()
    sy = (((gt - y) ** 2) / d).sum()
    sxy = (((pred - x) * (gt - y)) / d).sum()
    alpha = 4 * x * y * sxy
    beta = (x * x + y * y) * (sx + sy)
    if alpha != 0:
        return alpha / (beta + _EPS)
    return 1.0 if beta == 0 else 0.0


def s_region(pred, gt):
    if gt.sum() == 0:
        cx, cy = gt.shape[0] // 2, gt.shape[1] // 2
    else:
        xs, ys = np.where(gt == 1)
        cx, cy = int(round(xs.mean())), int(round(ys.mean()))
    total = gt.size
    q = 0.0
    # quadrant split copied from the reference's indexing convention
    for (ps, gs) in (
        ((slice(None, cx), slice(None, cy)),) * 2,
        ((slice(cx, None), slice(None, cy)),) * 2,
        ((slice(None, cx), slice(cy, None)),) * 2,
        ((slice(cx, None), slice(cy, None)),) * 2,
    ):
        g = gt[gs]
        p = pred[ps]
        if g.size:
            q += _ssim_q(p, g) * (g.size / total)
    return q


def structure_measure(pred, gt):
    y = gt.mean()
    if y == 0:
        return 1.0 - pred.mean()
    if y == 1:
        return pred.mean()
    q = 0.5 * s_object(pred, gt) + 0.5 * s_region(pred, gt)
    return max(q, 0.0)


def _fspecial_gauss(size, sigma):
    x, y = np.mgrid[-size // 2 + 1:size // 2 + 1, -size // 2 + 1:size // 2 + 1]
    g = np.exp(-((x * x + y * y) / (2.0 * sigma * sigma)))
    return g / g.sum()


def weighted_fmeasure(pred, gt):
    gtb = gt == 1
    e = np.abs(pred - gt)
    dst, idst = distance_transform_edt(1 - gt, return_indices=True)
    et = e.copy()
    et[~gtb] = et[idst[0][~gtb], idst[1][~gtb]]
    ea = convolve(et, _fspecial_gauss(7, 5), mode="nearest")
    min_e_ea = e.copy()
    sel = gtb & (ea < e)
    min_e_ea[sel] = ea[sel]
    b = np.ones_like(gt)
    b[~gtb] = 2.0 - np.exp(np.log(0.5) / 5.0 * dst[~gtb])
    ew = min_e_ea * b
    tpw = gt.sum() - ew[gtb].sum()
    fpw = ew[~gtb].sum()
    r = 1.0 - ew[gtb].mean() if gtb.any() else 0.0
    p = tpw / (tpw + fpw + _EPS)
    return 2 * r * p / (r + p + _EPS)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def binary_image_metrics(pred: np.ndarray, gt: np.ndarray) -> dict:
    """Per-image metrics.

    pred: uint8 (0..255) or float in [0,1]; gt: any array, binarised at 0.5
    (matching ``eval.py:126-129``).  Returns scalars Sm/wFm/mae + the 7
    length-256 threshold curves.
    """
    pred = np.asarray(pred, np.float64)
    if pred.max() > 1.0:
        pred = pred / 255.0
    gt = (np.asarray(gt, np.float64) > 0.5).astype(np.float64)
    if pred.ndim == 3:
        pred = pred[:, :, 0]
    if gt.ndim == 3:
        gt = gt[:, :, 0]
    if pred.shape != gt.shape:
        raise ValueError(f"prediction {pred.shape} and GT {gt.shape} differ")

    out = {
        "Sm": structure_measure(pred, gt),
        "wFm": weighted_fmeasure(pred, gt),
        "mae": float(np.mean(np.abs(gt - pred))),
    }
    out.update(_threshold_sweep(pred, gt))
    return out


def aggregate_dataset_metrics(per_image: list[dict]) -> dict[str, float]:
    """Reference aggregation: image-mean curves, then mean/max over thresholds."""
    curves = {k: np.mean([m[k] for m in per_image], axis=0)
              for k in ("Em", "Fm", "Rec", "Spe", "Dic", "IoU")}
    return {
        "meanDic": float(curves["Dic"].mean()),
        "meanIoU": float(curves["IoU"].mean()),
        "wFm": float(np.mean([m["wFm"] for m in per_image])),
        "Sm": float(np.mean([m["Sm"] for m in per_image])),
        "meanEm": float(curves["Em"].mean()),
        "mae": float(np.mean([m["mae"] for m in per_image])),
        "maxEm": float(curves["Em"].max()),
        "maxDic": float(curves["Dic"].max()),
        "maxIoU": float(curves["IoU"].max()),
        "meanSen": float(curves["Rec"].mean()),
        "maxSen": float(curves["Rec"].max()),
        "meanSpe": float(curves["Spe"].mean()),
        "maxSpe": float(curves["Spe"].max()),
    }

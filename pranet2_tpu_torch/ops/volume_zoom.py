"""The volumetric predictor's zooms on the volume's device: every slice of
a (D, x, y) volume to the patch at order 3 (``zoom_slices``) and the
(D, ph, pw) labels back at order 0 (``zoom_labels``), the numbers of
``scipy.ndimage.zoom`` on each slice (its default constant mode, float64
inside, float32 out).

No TPU kernel corresponds: the JAX package zooms on the host, slice by
slice (``pranet2_tpu/train/multiclass.py``).  scipy's zoom is linear and
separable, so each axis's zoom n -> m is one operator, built here once per
(n, m) from scipy itself: ``cubic_operator`` zooms an identity and keeps
each row's band (every entry above ``BAND_TOL`` of the row's largest; 64
taps from 512 or 154 to 224), ``nearest_index`` zooms the indices 1..n at
order 0 (-1, label 0, where scipy's constant mode gives cval).  A slice's
order-3 zoom is then ``(A @ s) @ B.T`` in float64, cast to float32.

Each wrapper launches the hand-written kernel (``csrc/volume_zoom.cu``) on
a CUDA tensor and runs the plain version, the same operators as dense
float64 matrices (or the same gather), on a CPU tensor.  The operators and
index tables are cached on each device.  ``zoom_slices.launches`` and
``zoom_labels.launches`` count the calls that launched the kernel: one
each a volume of the predictor.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from scipy.ndimage import zoom

from pranet2_tpu_torch.ops import _build

# an operator entry below this share of its row's largest is dropped
BAND_TOL = 2.0 ** -60
ROW_BLOCK = 16  # output rows a block of the kernel (kRows)
SLICE_CODES = {torch.float32: 0, torch.float64: 3}  # csrc/common.cuh's DType


@functools.cache
def cubic_operator(n: int, m: int) -> tuple[np.ndarray, np.ndarray]:
    """scipy's order-3 zoom of one axis from ``n`` to ``m`` points, banded:
    each output row's first input row (``(m,)`` int32) and its weights
    from there (``(m, taps)`` float64), ``taps`` the widest row's band.

    A row's band holds every entry above ``BAND_TOL`` of its largest; a
    band that would run past the axis's end starts earlier, and a row of
    zeros (scipy's constant mode past the last input point) takes its
    predecessor's start, so that a kernel block's rows read a narrow range
    of input rows."""
    a = zoom(np.eye(n), (m / n, 1), order=3, output=np.float64)
    if a.shape != (m, n):
        raise ValueError(f"cubic_operator: scipy zooms {n} to {a.shape[0]} "
                         f"points, not {m}")
    mag = np.abs(a)
    kept = mag > BAND_TOL * mag.max(axis=1, keepdims=True)
    live = kept.any(axis=1)
    lo = np.where(live, kept.argmax(axis=1), 0)
    hi = np.where(live, n - kept[:, ::-1].argmax(axis=1), 0)
    taps = max(int((hi - lo).max()), 1)
    first = np.minimum(lo, n - taps)
    for i in np.nonzero(~live)[0]:
        first[i] = first[i - 1] if i else 0
    cols = first[:, None] + np.arange(taps)
    return first.astype(np.int32), np.take_along_axis(a, cols, axis=1)


@functools.cache
def row_blocks(n: int, m: int) -> tuple[np.ndarray, np.ndarray]:
    """``cubic_operator(n, m)`` by blocks of ``ROW_BLOCK`` output rows, as
    the kernel reads it: each block's first input row
    (``(blocks,)`` int32) and its rows' weights over the ``span`` input
    rows from there, zero outside each row's band (``(blocks, span,
    ROW_BLOCK)`` float64), ``span`` the widest block's.  Rows past ``m``
    (the last block's padding) weigh nothing."""
    first, weights = cubic_operator(n, m)
    taps = weights.shape[1]
    nb = -(-m // ROW_BLOCK)
    pad = nb * ROW_BLOCK - m
    f = np.concatenate([first, np.repeat(first[-1:], pad)])
    w = np.concatenate([weights, np.zeros((pad, taps))])
    blk, row = np.divmod(np.arange(nb * ROW_BLOCK), ROW_BLOCK)
    lo = f.reshape(nb, ROW_BLOCK).min(axis=1)
    span = int((f + taps - lo[blk]).max())
    lo = np.minimum(lo, n - span)  # every block reads span rows from lo
    table = np.zeros((nb, span, ROW_BLOCK))
    at = (f - lo[blk])[:, None] + np.arange(taps)
    table[blk[:, None], at, row[:, None]] = w
    return lo.astype(np.int32), table


@functools.cache
def nearest_index(n: int, m: int) -> np.ndarray:
    """scipy's order-0 zoom of one axis from ``n`` to ``m`` points as the
    source index of each output point (``(m,)`` int32), -1 where scipy's
    constant mode gives cval."""
    idx = zoom(np.arange(1, n + 1, dtype=np.float64), m / n, order=0)
    if idx.shape != (m,):
        raise ValueError(f"nearest_index: scipy zooms {n} to {idx.shape[0]} "
                         f"points, not {m}")
    return (idx - 1).astype(np.int32)


@functools.cache
def _on(device: torch.device, build, n: int, m: int):
    """The tables ``build(n, m)`` gives (``cubic_operator``,
    ``row_blocks`` or ``nearest_index``) on ``device``: ordinary tensors,
    whatever mode the first call comes in."""
    with torch.inference_mode(False):
        tables = build(n, m)
        if isinstance(tables, tuple):
            return tuple(torch.from_numpy(t).to(device) for t in tables)
        return torch.from_numpy(tables).to(device)


def _dense(device, n: int, m: int) -> torch.Tensor:
    """``cubic_operator(n, m)`` as an (m, n) float64 matrix, zero outside
    each row's band."""
    first, weights = _on(device, cubic_operator, n, m)
    taps = weights.shape[1]
    dense = torch.zeros((m, n), dtype=torch.float64, device=device)
    cols = first.long()[:, None] + torch.arange(taps, device=device)
    return dense.scatter_(1, cols, weights)


def _size(size, what: str) -> tuple[int, int]:
    h, w = (int(s) for s in size)
    if h < 1 or w < 1:
        raise ValueError(f"{what}: empty size {tuple(size)}")
    return h, w


def _check(t: torch.Tensor, dtypes, what: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    if t.dim() != 3 or t.numel() == 0:
        raise ValueError(f"{what}: needs a non-empty (D, H, W) tensor, got "
                         f"shape {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: needs {' or '.join(map(str, dtypes))}, got "
                        f"{t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: the tensor must be contiguous, got "
                         f"strides {t.stride()}")


def zoom_slices_plain(volume: torch.Tensor, size) -> torch.Tensor:
    """Plain PyTorch version, on the volume's device: ``(A @ s) @ B.T`` in
    float64 with the banded operators as dense matrices, cast to
    float32."""
    _check(volume, SLICE_CODES, "zoom_slices")
    ph, pw = _size(size, "zoom_slices")
    _, x, y = volume.shape
    a, b = _dense(volume.device, x, ph), _dense(volume.device, y, pw)
    return (a @ volume.double() @ b.T).float()[:, None]


def zoom_labels_plain(labels: torch.Tensor, size) -> torch.Tensor:
    """Plain PyTorch version, on the labels' device: the gather by the two
    index tables, with a zero row and column appended for their -1s."""
    _check(labels, (torch.int32,), "zoom_labels")
    x, y = _size(size, "zoom_labels")
    d, h, w = labels.shape
    rows = _on(labels.device, nearest_index, h, x).long()
    cols = _on(labels.device, nearest_index, w, y).long()
    padded = labels.new_zeros((d, h + 1, w + 1))
    padded[:, :h, :w] = labels
    return padded[:, rows][:, :, cols]


@functools.cache
def _kernels():
    lib = _build.library("volume_zoom")
    slices, labels = lib.volume_zoom_slices, lib.volume_zoom_labels
    slices.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    labels.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
    slices.restype = labels.restype = ctypes.c_int
    return slices, labels


def zoom_slices(volume: torch.Tensor, size) -> torch.Tensor:
    """Each slice of ``volume`` ((D, x, y) float32 or float64) zoomed to
    ``size`` = (ph, pw) at order 3, as a (D, 1, ph, pw) float32 batch on
    the volume's device.

    CPU tensor: the plain version.  CUDA tensor: two launches of the
    kernel (the operator over x into a float64 scratch, transposed, then
    the one over y; each by ``row_blocks``), on the current stream, no
    synchronise; a contiguous tensor only, and raises on anything else, or
    where autograd records and the volume requires grad (forward only)."""
    if volume.device.type == "cpu":
        return zoom_slices_plain(volume, size)
    _check(volume, SLICE_CODES, "zoom_slices")
    ph, pw = _size(size, "zoom_slices")
    _build.refuse_grad("zoom_slices", volume)
    d, x, y = volume.shape
    dev = volume.device
    with torch.cuda.device(dev):
        kernel, _ = _kernels()
        row_lo, row_table = _on(dev, row_blocks, x, ph)
        col_lo, col_table = _on(dev, row_blocks, y, pw)
        tmp = torch.empty((d, y, ph), dtype=torch.float64, device=dev)
        out = torch.empty((d, 1, ph, pw), dtype=torch.float32, device=dev)
        err = kernel(volume.data_ptr(), SLICE_CODES[volume.dtype], d, x, y,
                     row_lo.data_ptr(), row_table.data_ptr(),
                     row_table.shape[1], col_lo.data_ptr(),
                     col_table.data_ptr(), col_table.shape[1], ROW_BLOCK, ph,
                     pw, tmp.data_ptr(), out.data_ptr(),
                     _build.stream_ptr(volume))
    _build.check(err, "zoom_slices")
    zoom_slices.launches += 1
    return out


def zoom_labels(labels: torch.Tensor, size) -> torch.Tensor:
    """``labels`` ((D, ph, pw) int32) zoomed to ``size`` = (x, y) at order
    0, as (D, x, y) int32 on the labels' device.

    CPU tensor: the plain version.  CUDA tensor: one launch of the gather
    on the current stream, no synchronise; a contiguous tensor only, and
    raises on anything else."""
    if labels.device.type == "cpu":
        return zoom_labels_plain(labels, size)
    _check(labels, (torch.int32,), "zoom_labels")
    x, y = _size(size, "zoom_labels")
    d, h, w = labels.shape
    dev = labels.device
    with torch.cuda.device(dev):
        _, kernel = _kernels()
        rows = _on(dev, nearest_index, h, x)
        cols = _on(dev, nearest_index, w, y)
        out = torch.empty((d, x, y), dtype=torch.int32, device=dev)
        err = kernel(labels.data_ptr(), d, h, w, rows.data_ptr(),
                     cols.data_ptr(), x, y, out.data_ptr(),
                     _build.stream_ptr(labels))
    _build.check(err, "zoom_labels")
    zoom_labels.launches += 1
    return out


zoom_slices.launches = 0
zoom_labels.launches = 0

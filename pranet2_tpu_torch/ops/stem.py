"""The Res2Net-v1b stem maxpool (3x3, stride 2, pad 1, -inf padding).

Port of ``pranet2_tpu/ops/stem.py::_maxpool_kernel``.  The TPU kernel works
on a 2x2 space-to-depth packing of the stem's conv3 output, a layout chosen
for the TPU's 128 lanes; here the kernel (``csrc/maxpool.cu``) reads the
plain NCHW map.  On a CPU tensor the wrapper runs the plain version, the
nine shifted maxes of ``ops.pooling.max_pool``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pranet2_tpu_torch.ops import _build
from pranet2_tpu_torch.ops.pooling import max_pool


def max_pool3x3s2_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: nine shifted maxes with -inf fill."""
    return max_pool(x, 3, 2, 1)


@functools.cache
def _kernel():
    f = _build.library("maxpool").maxpool3x3s2
    f.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def max_pool3x3s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 / stride 2 / pad 1 max pool of an NCHW map.

    CPU tensor: the plain version.  CUDA tensor: the hand-written kernel,
    which takes a contiguous NCHW float32/bfloat16/float16 map and raises on
    anything else.  ``max_pool3x3s2.launches`` counts kernel launches.
    """
    if x.device.type == "cpu":
        return max_pool3x3s2_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"max_pool3x3s2: unsupported device {x.device}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("max_pool3x3s2: needs a contiguous NCHW tensor, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"max_pool3x3s2: unsupported dtype {x.dtype}")
    n, c, h, w = x.shape
    oh, ow = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    y = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        err = _kernel()(_build.DTYPE_CODES[x.dtype], x.data_ptr(), y.data_ptr(),
                        n * c, h, w, oh, ow, _build.stream_ptr(x))
    _build.check(err, "max_pool3x3s2")
    max_pool3x3s2.launches += 1
    return y


max_pool3x3s2.launches = 0

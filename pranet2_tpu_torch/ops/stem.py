"""The Res2Net-v1b stem's tail: bn1 + ReLU + maxpool (3x3, stride 2, pad
1, -inf padding), and the bare maxpool.

Port of ``pranet2_tpu/ops/stem.py::_maxpool_kernel``, which the JAX
package runs on the stem's output after folding bn1 (``fold_bn``) and
applying it with ReLU (``s2d_stem``'s ``bnrelu``).  The TPU kernel works on
a 2x2 space-to-depth packing of the stem's conv3 output, a layout chosen
for the TPU's 128 lanes; here the kernel (``csrc/maxpool.cu``) reads the
plain NCHW map.  ``stem_pool`` takes conv3's raw output and bn1's four
vectors and does the fold, BN, ReLU and pool in one launch (the models'
eval path with autograd off); ``max_pool3x3s2`` is the same kernel without
BN and ReLU.  Both are forward only.  On a CPU tensor each wrapper runs its
plain version, built on the nine shifted maxes of ``ops.pooling.max_pool``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pranet2_tpu_torch.ops import _build
from pranet2_tpu_torch.ops.pooling import max_pool
from pranet2_tpu_torch.ops.res2_tail import fold_bn


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
    anything else, or where autograd records and x requires grad (forward
    only).  ``max_pool3x3s2.launches`` counts kernel launches.
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
    _build.refuse_grad("max_pool3x3s2", x)
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


def stem_pool_plain(z, bn_weight, bn_bias, bn_mean, bn_var,
                    eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of ``stem_pool``: ``fold_bn``, then
    ``relu(z * s + t)`` in float32 rounded once to z's type, then
    ``max_pool3x3s2_plain``."""
    s, t = fold_bn(bn_weight, bn_bias, bn_mean, bn_var, eps)
    zf = z.to(torch.promote_types(z.dtype, torch.float32))
    y = torch.relu(zf * s[:, None, None] + t[:, None, None]).to(z.dtype)
    return max_pool3x3s2_plain(y)


@functools.cache
def _stem_kernel():
    f = _build.library("maxpool").stem_pool
    f.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_float,
                                                             ctypes.c_void_p,
                                                             ctypes.c_longlong]
                  + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def stem_pool(z: torch.Tensor, bn_weight: torch.Tensor, bn_bias: torch.Tensor,
              bn_mean: torch.Tensor, bn_var: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """``max_pool3x3s2(relu(bn(z)))`` of an NCHW map ``z`` with the
    inference BatchNorm of ``bn_weight``, ``bn_bias``, ``bn_mean`` and
    ``bn_var`` (C each), folded as ``ops.res2_tail.fold_bn`` folds it.

    CPU tensors: the plain version.  CUDA tensors: one launch of the
    kernel, which takes a contiguous NCHW float32/bfloat16/float16 map and
    the four vectors in float32, contiguous, and raises on anything else,
    or where autograd records and an input requires grad (forward only).
    ``stem_pool.launches`` counts kernel launches.
    """
    vecs = (bn_weight, bn_bias, bn_mean, bn_var)
    dev = z.device
    if dev.type == "cpu" and all(v.device == dev for v in vecs):
        return stem_pool_plain(z, *vecs, eps)
    if dev.type != "cuda" or any(v.device != dev for v in vecs):
        raise ValueError("stem_pool: z and the BatchNorm vectors must lie on "
                         f"one CUDA device, got {z.device}, "
                         f"{[str(v.device) for v in vecs]}")
    if z.dim() != 4 or any(v.shape != z.shape[1:2] for v in vecs):
        raise ValueError(f"stem_pool: needs an NCHW map and four (C,) vectors,"
                         f" got {tuple(z.shape)}, "
                         f"{[tuple(v.shape) for v in vecs]}")
    code = _build.DTYPE_CODES.get(z.dtype)
    if code is None or any(v.dtype != torch.float32 for v in vecs):
        raise TypeError(f"stem_pool: needs a float map ({z.dtype}) and float32 "
                        f"BatchNorm vectors ({[v.dtype for v in vecs]})")
    if not (z.is_contiguous() and all(v.is_contiguous() for v in vecs)):
        raise ValueError("stem_pool: z (NCHW) and the vectors must be "
                         "contiguous")
    _build.refuse_grad("stem_pool", z, *vecs)
    n, c, h, w = z.shape
    oh, ow = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    y = torch.empty((n, c, oh, ow), dtype=z.dtype, device=dev)
    if y.numel() == 0:
        return y
    args = (code, z.data_ptr(), *(v.data_ptr() for v in vecs), eps,
            y.data_ptr(), n, c, h, w, oh, ow, _build.stream_ptr(z))
    if dev.index == torch.cuda.current_device():
        err = _stem_kernel()(*args)
    else:
        with torch.cuda.device(dev):
            err = _stem_kernel()(*args)
    _build.check(err, "stem_pool")
    stem_pool.launches += 1
    return y


stem_pool.launches = 0

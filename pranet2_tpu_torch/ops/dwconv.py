"""Exact depthwise 3x3 convolution over channels-last maps.

Port of ``pranet2_tpu/ops/dwconv.py::_dw_kernel`` (launcher
``depthwise_conv3x3``), which no model of the JAX package calls: it is an
exported op for paths whose depthwise convolution must be exact in float32.
``depthwise_conv3x3`` launches the hand-written kernel (``csrc/dwconv.cu``)
on a CUDA tensor and runs the plain version on a CPU tensor.  Both follow
the TPU kernel's arithmetic: zero "same" padding, stride 1, no bias; the
nine products summed in float32 from zero, tap row outer and tap column
inner, each product and sum rounded as float32; the output in x's type.

x is (N, H, W, C), channels-last; w is (3, 3, C), the JAX package's layout
(the torch depthwise weight (C, 1, 3, 3) is ``w.permute(2, 0, 1)[:, None]``).
Forward only.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from pranet2_tpu_torch.ops import _build


def depthwise_conv3x3_plain(x, w):
    """Plain PyTorch version, in the kernel's order of sums."""
    n, h, wd, c = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros((n, h, wd, c), dtype=torch.float32, device=x.device)
    for di in range(3):
        for dj in range(3):
            acc = acc + xp[:, di:di + h, dj:dj + wd] * wf[di, dj]
    return acc.to(x.dtype)


@functools.cache
def _kernel():
    f = _build.library("dwconv").depthwise_conv3x3
    f.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def depthwise_conv3x3(x, w):
    """Depthwise 3x3, stride 1, "same" zero padding, no bias, NHWC.

    CPU tensors: the plain version.  CUDA tensors: the kernel, which takes x
    and w in one type (float32 or bfloat16), contiguous, any C, and raises
    on anything else.  ``depthwise_conv3x3.launches`` counts launches.
    """
    if x.device.type == "cpu":
        return depthwise_conv3x3_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv3x3: unsupported device {x.device}")
    if w.device != x.device:
        raise ValueError("depthwise_conv3x3: x and w must lie on one CUDA "
                         f"device, got {x.device} and {w.device}")
    if x.dim() != 4 or tuple(w.shape) != (3, 3, x.shape[-1]):
        raise ValueError(f"depthwise_conv3x3: x must be (N, H, W, C) and w "
                         f"(3, 3, C), got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError("depthwise_conv3x3: x and w must be both float32 or "
                        f"both bfloat16, got {x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("depthwise_conv3x3: x and w must be contiguous (x "
                         "channels-last)")
    n, h, wd, c = x.shape
    if n * h >= 2 ** 31:
        raise ValueError("depthwise_conv3x3: N*H must be below 2^31")
    _build.refuse_grad("depthwise_conv3x3", x, w)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = _kernel()(_build.DTYPE_CODES[x.dtype], x.data_ptr(),
                        w.data_ptr(), out.data_ptr(), n, h, wd, c,
                        _build.stream_ptr(x))
    _build.check(err, "depthwise_conv3x3")
    depthwise_conv3x3.launches += 1
    return out


depthwise_conv3x3.launches = 0

"""The whole stride-1 'normal' Bottle2neck of Res2Net-v1b, eval mode.

Port of ``pranet2_tpu/ops/res2_block.py::_kernel_full`` / ``_kernel_halo``
(launcher ``fused_bottle2neck``, body ``_body``).  ``fused_bottle2neck``
launches the hand-written kernels (``csrc/res2_block.cu``) on a CUDA tensor
and runs the plain version on a CPU tensor.  Both follow the TPU kernel's
rounding points:

* ``u = relu(conv1x1(x) * s1 + t1)``, rounded to x's type;
* the input of 3x3 conv i > 0 is ``u_i + sp_{i-1}`` rounded to x's type;
* each 3x3 conv (zero padding 1) is accumulated in float32 from operands in
  x's type, then BatchNorm and ReLU in float32, rounded to x's type;
* the projection of ``cat(sp_0, sp_1, sp_2, u_3)`` is summed in float32,
  then ``* s3 + t3 + x`` in float32, ReLU and one cast (the tail).

Maps are NCHW: x (N, C, H, W).  Weights in torch layout: ``w1`` (4 width,
C), ``wd`` (3, width, width, 3, 3) the three OIHW 3x3 kernels, ``w3`` (C,
4 width); the folded BatchNorms float32: ``s1``/``t1`` (4 width),
``sd``/``td`` (3, width), ``s3``/``t3`` (C).  Forward only: training runs
the module chain.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from pranet2_tpu_torch.ops import _build
from pranet2_tpu_torch.ops.res2_tail import (bn_relu, check_args, conv1x1,
                                             res2_tail_plain)

SCALE = 4  # Res2Net-v1b's splits; the block kernel takes no other


def bottle2neck_plain(x, w1, s1, t1, wd, sd, td, w3, s3, t3):
    """Plain PyTorch version, step by step with the kernel's roundings."""
    dt = x.dtype
    width = wd.shape[1]
    u = bn_relu(conv1x1(x, w1), s1, t1).to(dt)
    parts, sp = [], None
    for i in range(SCALE - 1):
        vin = u[:, i * width:(i + 1) * width]
        if sp is not None:
            vin = vin + sp
        acc = F.conv2d(vin.float(), wd[i].float(), padding=1)
        sp = bn_relu(acc, sd[i], td[i]).to(dt)
        parts.append(sp)
    parts.append(u[:, (SCALE - 1) * width:])
    return res2_tail_plain(torch.cat(parts, 1), x, w3, s3, t3)


@functools.cache
def _kernel():
    lib = _build.library("res2_block")
    f, size = lib.res2_block, lib.res2_block_scratch
    f.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    size.argtypes = [ctypes.c_int] * 6
    size.restype = ctypes.c_longlong
    return f, size


@functools.cache
def _tile_query():
    f = _build.library("res2_block").res2_block_tile
    f.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    f.restype = None
    return f


def conv3x3_tile(n: int, c: int, width: int, h: int, w: int):
    """The bfloat16 3x3 products' pixel tile (rows, columns) and K splits
    on the current CUDA device, as ``csrc/res2_gemm.cuh::plan3x3`` picks
    them: the block stages the tile with a one-pixel halo."""
    tile = (ctypes.c_int * 3)()
    _tile_query()(n, c, width, h, w, tile)
    return tile[0], tile[1], tile[2]


def fused_bottle2neck(x, w1, s1, t1, wd, sd, td, w3, s3, t3):
    """A whole 'normal' Bottle2neck (stride 1, no downsample, 4 splits).

    CPU tensors: the plain version.  CUDA tensors: the kernels, which take
    contiguous NCHW maps and weights in one type (float32 or bfloat16; in
    bfloat16 C a multiple of 8 and every tensor 16-byte aligned), the
    folded BatchNorms in float32, and raise on anything else.  A call
    launches a chain of five products (in bfloat16 after a weight-layout
    launch; each product with a split-K reduce launch where it splits) and
    counts once in ``fused_bottle2neck.launches``.
    """
    if x.device.type == "cpu":
        return bottle2neck_plain(x, w1, s1, t1, wd, sd, td, w3, s3, t3)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottle2neck: unsupported device {x.device}")
    if x.dim() != 4 or wd.dim() != 5:
        raise ValueError(f"fused_bottle2neck: x must be NCHW and wd (3, width,"
                         f" width, 3, 3), got {tuple(x.shape)}, "
                         f"{tuple(wd.shape)}")
    n, c, h, w = x.shape
    width = wd.shape[1]
    check_args("fused_bottle2neck", x,
               {"w1": (w1, (SCALE * width, c)),
                "wd": (wd, (SCALE - 1, width, width, 3, 3)),
                "w3": (w3, (c, SCALE * width))},
               {"s1": (s1, (SCALE * width,)), "t1": (t1, (SCALE * width,)),
                "sd": (sd, (SCALE - 1, width)), "td": (td, (SCALE - 1, width)),
                "s3": (s3, (c,)), "t3": (t3, (c,))})
    if x.dtype == torch.bfloat16 and c % 8:
        raise ValueError(f"fused_bottle2neck: bfloat16 takes C ({c}) a "
                         "multiple of 8")
    _build.refuse_grad("fused_bottle2neck", x, w1, s1, t1, wd, sd, td, w3, s3,
                       t3)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    code = _build.DTYPE_CODES[x.dtype]
    kernel, size = _kernel()
    with torch.cuda.device(x.device):
        # scratch: u's groups 0-2, the concat buffer the projection reads,
        # the prepared weights and the split-K partial sums, as the kernel
        # lays them out for this device
        scratch = torch.empty(size(code, n, c, width, h, w),
                              dtype=torch.uint8, device=x.device)
        err = kernel(code, *(t.data_ptr() for t in (x, w1, s1, t1, wd, sd, td,
                                                    w3, s3, t3, out,
                                                    scratch)),
                     n, c, width, h, w, _build.stream_ptr(x))
    _build.check(err, "fused_bottle2neck")
    fused_bottle2neck.launches += 1
    return out


fused_bottle2neck.launches = 0

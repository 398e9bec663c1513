"""A whole PVTv2 transformer block, the attention half and then the MLP.

Port of ``pranet2_tpu/ops/pvt_block.py::_kernel_v3`` (launcher
``fused_pvt_block``, the JAX package's ``PRANET2_FUSED=blockfuse``):

    h   = x + proj(attention(LN1(x), kv(LN_kv(sr(LN1(x))))))
    out = h + fc2(GELU(dwconv3x3(fc1(LN2(h)))))

``pvt_block`` launches the hand-written kernels (``csrc/pvt_block.cu``: the
K/V path, the attention, and the MLP with its hidden kept on chip) on a
CUDA tensor and runs the plain version on a CPU tensor.  Both follow the TPU
kernel's arithmetic: ``_kernel_v2``'s attention half with its residual
rounded once (``ops.pvt_attn.sra_block_plain``), h rounded to x's type, then
the MLP half in the plain mode of ``ops.pvt_mlp.mlp_block_plain`` (LN2 in
float32, the float32 hidden, float32 taps, the polynomial-erf GELU,
``h + out.to(h.dtype)``).

Tokens are channels-last, x of shape (N, H, W, D); parameters in torch
layout, as ``sra_block`` and ``mlp_block`` take them.  Forward only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pranet2_tpu_torch.ops import _build
from pranet2_tpu_torch.ops.pvt_attn import (KV_EPS, check_aligned,
                                            check_args, check_sra_block_args,
                                            kv_scratch, sr_weight,
                                            sra_block_plain)
from pranet2_tpu_torch.ops.pvt_mlp import mlp_block_plain, split_scratch


def pvt_block_plain(x, norm_w, norm_b, wq, bq, sr_w, sr_b, kvn_w, kvn_b, wkv,
                    bkv, wp, bp, norm2_w, norm2_b, w1, b1, dw_w, dw_b, w2, b2,
                    num_heads: int, sr: int, eps: float = 1e-6,
                    eps2: float = 1e-6):
    """Plain PyTorch version, step by step with the kernel's roundings."""
    h = sra_block_plain(x, norm_w, norm_b, wq, bq, sr_w, sr_b, kvn_w, kvn_b,
                        wkv, bkv, wp, bp, num_heads, sr, eps)
    return mlp_block_plain(h, norm2_w, norm2_b, w1, b1, dw_w, dw_b, w2, b2,
                           eps2)


@functools.cache
def _kernel():
    f = _build.library("pvt_block").pvt_block
    p, fl = ctypes.c_void_p, ctypes.c_float
    f.argtypes = ([ctypes.c_int, p, p, p, fl, p, p, p, p, p, p, fl, p, p, p,
                   p, fl, p, p, fl] + [p] * 10 + [ctypes.c_int] * 7 + [p] * 3)
    f.restype = ctypes.c_int
    return f


def pvt_block(x, norm_w, norm_b, wq, bq, sr_w, sr_b, kvn_w, kvn_b, wkv, bkv,
              wp, bp, norm2_w, norm2_b, w1, b1, dw_w, dw_b, w2, b2,
              num_heads: int, sr: int, eps: float = 1e-6, eps2: float = 1e-6):
    """A PVTv2 block over channels-last tokens (N, H, W, D): the arguments
    of ``sra_block`` (``sr_w``, ``sr_b``, ``kvn_w``, ``kvn_b`` may be None
    at sr = 1), then LN2 and the MLP's fc1 ``w1`` (C, D), depthwise
    ``dw_w`` (C, 1, 3, 3) and fc2 ``w2`` (D, C) with their biases.

    CPU tensors: the plain version.  CUDA tensors: the kernels of
    ``csrc/pvt_block.cu`` (the K/V path, the attention, the MLP; no
    (N*H*W x C) hidden is written), in the types ``sra_block`` and
    ``mlp_block`` take, C a multiple of 32; they raise on anything else.
    ``pvt_block.launches`` counts calls that launched the kernels.
    """
    attn = (x, norm_w, norm_b, wq, bq, sr_w, sr_b, kvn_w, kvn_b, wkv, bkv,
            wp, bp)
    mlp = (norm2_w, norm2_b, w1, b1, dw_w, dw_b, w2, b2)
    if x.device.type == "cpu":
        return pvt_block_plain(*attn, *mlp, num_heads, sr, eps, eps2)
    if x.device.type != "cuda":
        raise ValueError(f"pvt_block: unsupported device {x.device}")
    check_sra_block_args("pvt_block", *attn, num_heads, sr)
    n, h, w, d = x.shape
    c = w1.shape[0]
    check_args("pvt_block", x,
               {"norm2_w": (norm2_w, (d,)), "norm2_b": (norm2_b, (d,))},
               {"w1": (w1, (c, d)), "b1": (b1, (c,)),
                "dw_w": (dw_w, (c, 1, 3, 3)), "dw_b": (dw_b, (c,)),
                "w2": (w2, (d, c)), "b2": (b2, (d,))})
    if c % 32 or n * h >= 2 ** 31:
        raise ValueError(f"pvt_block: C ({c}) must be a multiple of 32 and "
                         "N*H below 2^31")
    check_aligned("pvt_block", w1=w1, w2=w2, b1=b1, dw_w=dw_w, dw_b=dw_b)
    _build.refuse_grad("pvt_block", *attn, *mlp)
    if x.numel() == 0:
        return torch.empty_like(x)
    sr_wt = sr_weight(sr_w).contiguous() if sr > 1 else None
    # scratch: the patch product's partial sums, K/V, and the attention
    # half's output h (the MLP's input and residual)
    part = kv_scratch(x, sr)
    kv = torch.empty((n, (h // sr) * (w // sr), 2 * d), dtype=x.dtype,
                     device=x.device)
    hbuf = torch.empty_like(x)
    out = torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        # the MLP's partial sums and its tiles' counters where a row tile's
        # hidden channels are split
        mpart, mcount = split_scratch(x, c)
        err = _kernel()(
            _build.DTYPE_CODES[x.dtype], *map(ptr, (x, norm_w, norm_b)), eps,
            *map(ptr, (wq, bq, sr_wt, sr_b, kvn_w, kvn_b)), KV_EPS,
            *map(ptr, (wkv, bkv, wp, bp)), 1.0 / (d // num_heads) ** 0.5,
            *map(ptr, (norm2_w, norm2_b)), eps2,
            *map(ptr, (w1, b1, dw_w, dw_b, w2, b2, part, kv, hbuf, out)),
            n, h, w, d, num_heads, c, sr, *map(ptr, (mpart, mcount)),
            _build.stream_ptr(x))
    _build.check(err, "pvt_block")
    pvt_block.launches += 1
    return out


pvt_block.launches = 0

"""The PVTv2 MLP half, ``x + fc2(GELU(dwconv3x3(fc1(LN(x)))))``.

Port of ``pranet2_tpu/ops/pvt_mlp.py::_kernel`` (launchers
``fused_mlp_block``, ``fused_mlp_block_stats`` and
``fused_mlp_block_final_ln``).  ``mlp_block`` makes one launch of the
hand-written kernel (``csrc/pvt_mlp.cu`` on ``csrc/mlp_fused.cuh``, the
hidden kept on chip) on a CUDA tensor and runs the plain version on a CPU
tensor.  Both follow the TPU kernel's arithmetic, not the module chain's:

* LN statistics in float32 with var = E[x^2] - mu^2, then gamma and beta,
  then a cast to x's type;
* fc1 accumulates in float32 and adds its bias in float32; the hidden map
  stays float32;
* the depthwise 3x3 pads the fc1 output (bias included) with zeros, sums
  its nine taps in float32 (column of taps outer, row inner) and adds its
  bias;
* GELU with the degree-5 polynomial erf clipped at +-3.5 (not ``erf``);
* the GELU output is cast to x's type, fc2 accumulates in float32 and adds
  its bias;
* the output is ``x + out.to(x.dtype)``, rounded in x's type.

Modes: ``stats_eps`` also returns the float32 (mu, rstd) of the rounded
output over channels, for the next block's LN; ``final_ln=(weight, bias)``
applies the stage-end LayerNorm to ``f32(x) + out`` (no rounding between)
with ``final_eps`` and returns only its cast result.

Tokens are channels-last, x of shape (N, H, W, D).  Parameters come in
torch layout: ``w1`` (C, D), ``dw_w`` (C, 1, 3, 3), ``w2`` (D, C).

Forward only: training runs the module chain, and this op's gradient and
the TPU kernel's ``save_acc`` mode come with binary training.  No
(N*H*W x C) tensor is allocated: the launch keeps the hidden on chip.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from pranet2_tpu_torch.ops import _build

# odd polynomial erf(x / sqrt(2)) = x * P(x^2) on [-3.5, 3.5], the TPU
# kernel's degree-5 fit (pranet2_tpu/ops/pvt_mlp.py:96-99)
ERF_COEF = (0.79677470225491, -0.13004687058013398, 0.017675043414989475,
            -0.0015805384199393212, 8.08939954863686e-05,
            -1.7651197891844647e-06)
MODES = {"plain": 0, "stats": 1, "final_ln": 2}


def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    """GELU through the clipped polynomial erf, in x's (float32) type."""
    xc = x.clamp(-3.5, 3.5)
    u = xc * xc
    p = torch.full_like(u, ERF_COEF[-1])
    for coef in ERF_COEF[-2::-1]:
        p = p * u + coef
    return 0.5 * x * (1.0 + xc * p)


def ln_stats(xf: torch.Tensor, eps: float):
    """Float32 (mu, rstd) over the last axis, var = E[x^2] - mu^2."""
    mu = xf.mean(-1)
    var = (xf * xf).mean(-1) - mu * mu
    return mu, torch.rsqrt(var + eps)


def layer_norm_f32(xf, weight, bias, eps):
    """The kernels' LayerNorm of float32 ``xf`` over its last axis, in
    float32: ``(xf - mu) * rstd * weight + bias``."""
    mu, rstd = ln_stats(xf, eps)
    y = (xf - mu[..., None]) * rstd[..., None]
    return y * weight.float() + bias.float()


def mlp_block_plain(x, norm_w, norm_b, w1, b1, dw_w, dw_b, w2, b2,
                    eps: float = 1e-6, stats_eps: float | None = None,
                    final_ln=None, final_eps: float = 1e-6):
    """Plain PyTorch version, step by step with the kernel's roundings."""
    dt = x.dtype
    n, h, w, d = x.shape
    xf = x.float()
    yb = layer_norm_f32(xf, norm_w, norm_b, eps).to(dt)
    z = yb.float() @ w1.float().t() + b1.float()           # (N, H, W, C)
    zp = F.pad(z, (0, 0, 1, 1, 1, 1))
    taps = dw_w.float()[:, 0]                                # (C, 3, 3)
    acc = torch.zeros_like(z)
    for dj in range(3):
        for di in range(3):
            acc = acc + zp[:, di:di + h, dj:dj + w] * taps[:, di, dj]
    acc = acc + dw_b.float()
    g = gelu_poly(acc).to(dt)
    out = g.float() @ w2.float().t() + b2.float()            # (N, H, W, D)
    if final_ln is not None:
        return layer_norm_f32(xf + out, final_ln[0], final_ln[1], final_eps).to(dt)
    ob = x + out.to(dt)
    if stats_eps is None:
        return ob
    return (ob, *ln_stats(ob.float(), stats_eps))


@functools.cache
def _kernel():
    f = _build.library("pvt_mlp").pvt_mlp_block
    p = ctypes.c_void_p
    f.argtypes = ([ctypes.c_int, ctypes.c_int] + [p] * 16
                  + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [p])
    f.restype = ctypes.c_int
    return f


@functools.cache
def _tile_query():
    f = _build.library("pvt_mlp").pvt_mlp_tile
    f.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    f.restype = ctypes.c_int
    return f


def mlp_tile(n: int, h: int, w: int, d: int, c: int,
             dtype) -> tuple[int, int, int]:
    """The MLP launch's tile on the current CUDA device, as
    ``csrc/mlp_fused.cuh::mlpf::pick`` chooses it: image rows and hidden
    channels a step of a block takes, and the blocks that share a row
    tile's hidden channels.  Raises where no tile fits a block."""
    tile = (ctypes.c_int * 3)()
    err = _tile_query()(_build.DTYPE_CODES[dtype], n, h, w, d, c, tile)
    if err:
        raise ValueError(f"MLP launch: no tile of W {w}, D {d} and C {c} "
                         "fits a block")
    return tile[0], tile[1], tile[2]


def split_scratch(x: torch.Tensor, c: int):
    """The MLP launch's float32 partial sums (S, N*H*W, D) and its row
    tiles' int32 counters (the launch zeroes them) where its tile splits
    the hidden channels (S > 1); else (None, None)."""
    n, h, w, d = x.shape
    rows, _, splits = mlp_tile(n, h, w, d, c, x.dtype)
    if splits == 1:
        return None, None
    return (torch.empty((splits, n * h * w, d), dtype=torch.float32,
                        device=x.device),
            torch.empty(n * -(-h // rows), dtype=torch.int32,
                        device=x.device))


def _check(x, norm_w, norm_b, w1, b1, dw_w, dw_b, w2, b2, final_ln):
    ts = [x, norm_w, norm_b, w1, b1, dw_w, dw_b, w2, b2, *(final_ln or ())]
    if not all(t.device == x.device for t in ts):
        raise ValueError("mlp_block: inputs must all lie on one CUDA device, "
                         f"got {sorted({str(t.device) for t in ts})}")
    if x.dim() != 4:
        raise ValueError(f"mlp_block: x must be (N, H, W, D), got "
                         f"{tuple(x.shape)}")
    n, h, w, d = x.shape
    c = w1.shape[0]
    shapes = {"w1": (w1, (c, d)), "b1": (b1, (c,)), "dw_w": (dw_w, (c, 1, 3, 3)),
              "dw_b": (dw_b, (c,)), "w2": (w2, (d, c)), "b2": (b2, (d,))}
    lns = {"norm_w": norm_w, "norm_b": norm_b}
    if final_ln is not None:
        lns.update(final_w=final_ln[0], final_b=final_ln[1])
    bad = [k for k, (t, s) in shapes.items() if tuple(t.shape) != s]
    bad += [k for k, t in lns.items() if tuple(t.shape) != (d,)]
    if bad:
        raise ValueError(f"mlp_block: wrong shapes for {bad} with x "
                         f"{tuple(x.shape)} and C {c}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mlp_block: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    bad = [k for k, (t, _) in shapes.items() if t.dtype != x.dtype]
    bad += [k for k, t in lns.items() if t.dtype != torch.float32]
    if bad:
        raise TypeError(f"mlp_block: {bad} must be {x.dtype} (LayerNorm "
                        "parameters float32)")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("mlp_block: inputs must be contiguous (x channels-"
                         "last)")
    if d % 32 or c % 32 or n * h * w >= 2 ** 31:
        raise ValueError(f"mlp_block: D ({d}) and C ({c}) must be multiples "
                         "of 32 and N*H*W below 2^31")
    if any(t.data_ptr() % 32 for t in (w1, b1, dw_w, dw_b, w2)):
        raise ValueError("mlp_block: w1, b1, dw_w, dw_b and w2 must be "
                         "32-byte aligned")


def mlp_block(x, norm_w, norm_b, w1, b1, dw_w, dw_b, w2, b2,
              eps: float = 1e-6, stats_eps: float | None = None,
              final_ln=None, final_eps: float = 1e-6):
    """The MLP half of a PVTv2 block over channels-last tokens (N, H, W, D).

    Returns the block output, ``(out, mu, rstd)`` when ``stats_eps`` is
    given, or the stage-end LayerNorm of the output when ``final_ln`` is.
    CPU tensors: the plain version.  CUDA tensors: one launch of the
    kernel, which takes x and the Linear/depthwise parameters in one type
    (float32 or bfloat16), the LayerNorm parameters in float32, all
    contiguous, with a tile of ``mlp_tile`` that fits a block, and raises on
    anything else.  ``mlp_block.launches`` counts calls that launched the
    kernel, ``mlp_block.mode_launches`` the same by mode.
    """
    if stats_eps is not None and final_ln is not None:
        raise ValueError("mlp_block: stats_eps and final_ln exclude each "
                         "other")
    if x.device.type == "cpu":
        return mlp_block_plain(x, norm_w, norm_b, w1, b1, dw_w, dw_b, w2, b2,
                               eps, stats_eps, final_ln, final_eps)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_block: unsupported device {x.device}")
    _check(x, norm_w, norm_b, w1, b1, dw_w, dw_b, w2, b2, final_ln)
    _build.refuse_grad("mlp_block", x, norm_w, norm_b, w1, b1, dw_w, dw_b, w2,
                       b2, *(final_ln or ()))
    mode = ("final_ln" if final_ln is not None
            else "stats" if stats_eps is not None else "plain")
    n, h, w, d = x.shape
    c = w1.shape[0]
    out = torch.empty_like(x)
    mu = rstd = None
    if mode == "stats":
        mu = torch.empty((n, h, w), dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mu)
    if x.numel() == 0:
        return out if mode != "stats" else (out, mu, rstd)
    fw, fb = final_ln if final_ln is not None else (None, None)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        part, count = split_scratch(x, c)
        err = _kernel()(
            _build.DTYPE_CODES[x.dtype], MODES[mode],
            *map(ptr, (x, norm_w, norm_b, w1, b1, dw_w, dw_b, w2, b2, fw, fb,
                       out, mu, rstd, part, count)),
            n, h, w, d, c, eps,
            stats_eps if mode == "stats" else final_eps,
            _build.stream_ptr(x))
    _build.check(err, "mlp_block")
    mlp_block.launches += 1
    mlp_block.mode_launches[mode] += 1
    return out if mode != "stats" else (out, mu, rstd)


mlp_block.launches = 0
mlp_block.mode_launches = dict.fromkeys(MODES, 0)

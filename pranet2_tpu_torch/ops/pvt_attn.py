"""The PVTv2 SRA attention half, ``x + proj(attention(LN1(x), K, V))``.

Port of ``pranet2_tpu/ops/pvt_attn.py::_kernel`` (launcher
``fused_sra_attention``).  ``sra_attention`` launches the hand-written
kernel (``csrc/pvt_attn.cu``) on a CUDA tensor and runs the plain version on
a CPU tensor.  Both follow the TPU kernel's arithmetic:

* LN1 statistics in float32 with var = E[x^2] - mu^2, gamma and beta, a
  cast to x's type;
* per head, q = LN1(x) Wq_h + bq_h in float32, then times 1/sqrt(hd);
* scores = q cast to x's type times K^T, accumulated in float32;
* softmax: subtract the row max, exp in float32, cast p to x's type, PV in
  float32, and divide by the float32 row sum after PV;
* the heads concatenated and cast, proj in float32 plus its bias, then
  ``x + out.to(x.dtype)``.

K and V come as the ``kv`` Linear's output, (N, Tkv, 2D): K is its first D
channels, V the last D, head h at channels [h*hd, (h+1)*hd).  The K/V path
that makes them (sr conv, LN, kv Linear) stays in plain PyTorch, as the JAX
package leaves it to XLA.  Tokens are channels-last, x of shape
(N, H, W, D); ``wq`` and ``wp`` are torch Linear weights (D, D).

Forward only: the gradient comes with binary training.
"""

from __future__ import annotations

import ctypes

import torch

from pranet2_tpu_torch.ops import _build
from pranet2_tpu_torch.ops.pvt_mlp import ln_stats

def sra_attention_plain(x, norm_w, norm_b, wq, bq, kv, wp, bp,
                        num_heads: int, eps: float = 1e-6):
    """Plain PyTorch version, step by step with the kernel's roundings."""
    dt = x.dtype
    n, h, w, d = x.shape
    hd = d // num_heads
    xf = x.float().reshape(n, h * w, d)
    mu, rstd = ln_stats(xf, eps)
    y = (xf - mu[..., None]) * rstd[..., None]
    yb = (y * norm_w.float() + norm_b.float()).to(dt)
    q = (yb.float() @ wq.float().t() + bq.float()) * (1.0 / hd ** 0.5)
    heads = lambda t: t.reshape(n, -1, num_heads, hd).transpose(1, 2)
    q = heads(q.to(dt)).float()                               # (N, nh, T, hd)
    k, v = (heads(t).float() for t in kv.split(d, dim=-1))    # (N, nh, Tkv, hd)
    s = q @ k.transpose(-1, -2)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = (p.to(dt).float() @ v) / p.sum(-1, keepdim=True)
    o = o.transpose(1, 2).reshape(n, h * w, d).to(dt)
    out = o.float() @ wp.float().t() + bp.float()
    return x + out.reshape(n, h, w, d).to(dt)


def _kernel():
    f = _build.library("pvt_attn").pvt_sra_attention
    f.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                  + [ctypes.c_int] * 5
                  + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def _check(x, norm_w, norm_b, wq, bq, kv, wp, bp, num_heads):
    ts = [x, norm_w, norm_b, wq, bq, kv, wp, bp]
    if not all(t.device == x.device for t in ts):
        raise ValueError("sra_attention: inputs must all lie on one CUDA "
                         f"device, got {sorted({str(t.device) for t in ts})}")
    if x.dim() != 4 or kv.dim() != 3:
        raise ValueError("sra_attention: x must be (N, H, W, D) and kv "
                         f"(N, Tkv, 2D), got {tuple(x.shape)}, "
                         f"{tuple(kv.shape)}")
    n, h, w, d = x.shape
    shapes = {"wq": (wq, (d, d)), "bq": (bq, (d,)), "wp": (wp, (d, d)),
              "bp": (bp, (d,)), "norm_w": (norm_w, (d,)),
              "norm_b": (norm_b, (d,))}
    bad = [k for k, (t, s) in shapes.items() if tuple(t.shape) != s]
    if bad or kv.shape[0] != n or kv.shape[2] != 2 * d or kv.shape[1] < 1:
        raise ValueError(f"sra_attention: wrong shapes for {bad or ['kv']} "
                         f"with x {tuple(x.shape)}, kv {tuple(kv.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sra_attention: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    bad = [k for k, t in (("wq", wq), ("bq", bq), ("kv", kv), ("wp", wp),
                          ("bp", bp)) if t.dtype != x.dtype]
    bad += [k for k, t in (("norm_w", norm_w), ("norm_b", norm_b))
            if t.dtype != torch.float32]
    if bad:
        raise TypeError(f"sra_attention: {bad} must be {x.dtype} (LayerNorm "
                        "parameters float32)")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("sra_attention: inputs must be contiguous (x "
                         "channels-last)")
    if num_heads < 1 or d % num_heads or (d // num_heads) % 32:
        raise ValueError(f"sra_attention: D ({d}) must split into "
                         f"{num_heads} heads of a multiple of 32")
    if any(t.data_ptr() % 32 for t in (wq, wp, kv)):
        raise ValueError("sra_attention: wq, wp and kv must be 32-byte "
                         "aligned")


def sra_attention(x, norm_w, norm_b, wq, bq, kv, wp, bp, num_heads: int,
                  eps: float = 1e-6):
    """The attention half of a PVTv2 block over channels-last tokens.

    CPU tensors: the plain version.  CUDA tensors: the kernel, which takes
    x, the Linear parameters and kv in one type (float32 or bfloat16), the
    LayerNorm parameters in float32, all contiguous, and raises on anything
    else; a block holds a whole K/V head in shared memory, and the launch
    fails (RuntimeError) where Tkv is too long for that.
    ``sra_attention.launches`` counts kernel launches.
    """
    if x.device.type == "cpu":
        return sra_attention_plain(x, norm_w, norm_b, wq, bq, kv, wp, bp,
                                   num_heads, eps)
    if x.device.type != "cuda":
        raise ValueError(f"sra_attention: unsupported device {x.device}")
    _check(x, norm_w, norm_b, wq, bq, kv, wp, bp, num_heads)
    n, h, w, d = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = _kernel()(
            _build.DTYPE_CODES[x.dtype],
            *(t.data_ptr() for t in (x, norm_w, norm_b, wq, bq, kv, wp, bp,
                                     out)),
            n, h * w, d, num_heads, kv.shape[1], eps,
            1.0 / (d // num_heads) ** 0.5, _build.stream_ptr(x))
    _build.check(err, "sra_attention")
    sra_attention.launches += 1
    return out


sra_attention.launches = 0

"""The PVTv2 SRA attention half, ``x + proj(attention(LN1(x), K, V))``.

Port of two TPU kernels of ``pranet2_tpu/ops/pvt_attn.py``:

* ``sra_attention``, of ``_kernel`` (launcher ``fused_sra_attention``): K
  and V given, as the ``kv`` Linear's output; the K/V path that makes them
  stays in plain PyTorch, as the JAX package leaves it to XLA.  Kernel
  ``csrc/pvt_attn.cu``.
* ``sra_block``, of ``_kernel_v2`` (launcher ``fused_sra_block``, the JAX
  package's ``PVT_ATTN_IMPL=v2``): the whole half, the K/V path included.
  Kernels ``csrc/pvt_kv.cu`` (LN1 of the patch tokens and the sr x sr
  patch product split over blocks, then the kv LN and the kv product) and
  ``csrc/pvt_attn.cu``.

On a CUDA tensor the wrappers launch the kernels, on a CPU tensor they run
the plain versions.  Both follow the TPU kernels' arithmetic:

* LN1 statistics in float32 with var = E[x^2] - mu^2, gamma and beta, a
  cast to x's type;
* per head, q = LN1(x) Wq_h + bq_h in float32, then times 1/sqrt(hd);
* scores = q cast to x's type times K^T, accumulated in float32;
* softmax: subtract the row max, exp in float32, cast p to x's type, PV in
  float32, and divide by the float32 row sum after PV;
* the heads concatenated and cast, proj in float32 plus its bias;
* ``sra_attention``: ``x + out.to(x.dtype)``; ``sra_block``:
  ``(x + out).to(x.dtype)``, one rounding (``_attend``);
* ``sra_block``'s K/V path (sr > 1): the sr x sr patches of LN1's output
  (VALID, stride sr: H // sr by W // sr tokens) times the conv weight in
  float32 plus its bias in float32, the kv LN (eps 1e-5) in float32 cast
  to x's type, the kv product in float32 plus its bias, cast to x's type.
  At sr = 1, K/V come from LN1's output itself.  The module chain and
  ``reference_sra_block`` round the conv's output and add both biases in
  x's type instead.

K and V are (N, Tkv, 2D): K the first D channels, V the last D, head h at
channels [h*hd, (h+1)*hd).  Tokens are channels-last, x of shape
(N, H, W, D).  Parameters come in torch layout: ``wq``, ``wp`` (D, D) and
``wkv`` (2D, D) Linear weights, ``sr_w`` (D, D, sr, sr) the conv's.

Forward only: the gradient comes with binary training.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pranet2_tpu_torch.ops import _build
from pranet2_tpu_torch.ops.pvt_mlp import layer_norm_f32

KV_EPS = 1e-5  # the K/V path's LayerNorm (SRAttention.norm)


def ln1_plain(x, norm_w, norm_b, eps):
    """LN1 of x in float32, cast to x's type."""
    return layer_norm_f32(x.float(), norm_w, norm_b, eps).to(x.dtype)


def attend_plain(x, yb, wq, bq, kv, wp, bp, num_heads: int,
                 exact_residual: bool):
    """The attention after LN1 (``yb``) with K/V given, step by step with
    the kernels' roundings; ``exact_residual`` rounds ``x + out`` once."""
    dt = x.dtype
    n, h, w, d = x.shape
    hd = d // num_heads
    q = (yb.reshape(n, h * w, d).float() @ wq.float().t()
         + bq.float()) * (1.0 / hd ** 0.5)
    heads = lambda t: t.reshape(n, -1, num_heads, hd).transpose(1, 2)
    q = heads(q.to(dt)).float()                            # (N, nh, T, hd)
    k, v = (heads(t).float() for t in kv.split(d, dim=-1))  # (N, nh, Tkv, hd)
    s = q @ k.transpose(-1, -2)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = (p.to(dt).float() @ v) / p.sum(-1, keepdim=True)
    o = o.transpose(1, 2).reshape(n, h * w, d).to(dt)
    out = (o.float() @ wp.float().t() + bp.float()).reshape(n, h, w, d)
    if exact_residual:
        return (x.float() + out).to(dt)
    return x + out.to(dt)


def sra_attention_plain(x, norm_w, norm_b, wq, bq, kv, wp, bp,
                        num_heads: int, eps: float = 1e-6):
    """Plain PyTorch version, step by step with the kernel's roundings."""
    return attend_plain(x, ln1_plain(x, norm_w, norm_b, eps), wq, bq, kv, wp,
                        bp, num_heads, exact_residual=False)


def sr_patches(yb, sr: int):
    """The sr x sr patches under the VALID stride-sr convolution's tokens,
    (N, (H // sr) * (W // sr), sr * sr * D), in (row, column, channel)
    order within a patch."""
    n, h, w, d = yb.shape
    hs, ws = h // sr, w // sr
    p = yb[:, :hs * sr, :ws * sr].reshape(n, hs, sr, ws, sr, d)
    return p.permute(0, 1, 3, 2, 4, 5).reshape(n, hs * ws, sr * sr * d)


def sr_weight(sr_w):
    """The conv weight (D, D, sr, sr) as (D, sr * sr * D), input channels
    last: the rows the patches of ``sr_patches`` multiply."""
    return sr_w.permute(0, 2, 3, 1).reshape(sr_w.shape[0], -1)


def kv_plain(yb, sr: int, sr_w, sr_b, kvn_w, kvn_b, wkv, bkv):
    """The whole-half kernel's K/V path on LN1's output ``yb``:
    (N, Tkv, 2D) in yb's type."""
    dt = yb.dtype
    n, h, w, d = yb.shape
    if sr > 1:
        s = sr_patches(yb, sr).float() @ sr_weight(sr_w).float().t()
        kvi = layer_norm_f32(s + sr_b.float(), kvn_w, kvn_b, KV_EPS).to(dt)
    else:
        kvi = yb.reshape(n, h * w, d)
    return (kvi.float() @ wkv.float().t() + bkv.float()).to(dt)


def sra_block_plain(x, norm_w, norm_b, wq, bq, sr_w, sr_b, kvn_w, kvn_b,
                    wkv, bkv, wp, bp, num_heads: int, sr: int,
                    eps: float = 1e-6):
    """Plain PyTorch version of the whole half, step by step with the
    kernels' roundings."""
    yb = ln1_plain(x, norm_w, norm_b, eps)
    kv = kv_plain(yb, sr, sr_w, sr_b, kvn_w, kvn_b, wkv, bkv)
    return attend_plain(x, yb, wq, bq, kv, wp, bp, num_heads,
                        exact_residual=True)


def check_args(what: str, x, ln: dict, typed: dict):
    """Raise unless ``x`` is a contiguous (N, H, W, D) float32 or bfloat16
    tensor and every parameter lies on its device, contiguous, with its
    shape: ``ln`` (LayerNorm parameters) in float32, ``typed`` in x's type.
    Both map a name to ``(tensor, shape)``."""
    params = {**ln, **typed}
    ts = [x, *(t for t, _ in params.values())]
    if not all(t.device == x.device for t in ts):
        raise ValueError(f"{what}: inputs must all lie on one CUDA device, "
                         f"got {sorted({str(t.device) for t in ts})}")
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be (N, H, W, D), got "
                         f"{tuple(x.shape)}")
    bad = [k for k, (t, s) in params.items() if tuple(t.shape) != tuple(s)]
    if bad:
        raise ValueError(f"{what}: wrong shapes for {bad} with x "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    bad = [k for k, (t, _) in typed.items() if t.dtype != x.dtype]
    bad += [k for k, (t, _) in ln.items() if t.dtype != torch.float32]
    if bad:
        raise TypeError(f"{what}: {bad} must be {x.dtype} (LayerNorm "
                        "parameters float32)")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: inputs must be contiguous (x channels-"
                         "last)")


def check_heads(what: str, d: int, num_heads: int):
    if num_heads < 1 or d % num_heads or (d // num_heads) % 32:
        raise ValueError(f"{what}: D ({d}) must split into {num_heads} "
                         "heads of a multiple of 32")


def check_aligned(what: str, **tensors):
    bad = [k for k, t in tensors.items() if t.data_ptr() % 32]
    if bad:
        raise ValueError(f"{what}: {bad} must be 32-byte aligned")


@functools.cache
def _attention_kernel():
    f = _build.library("pvt_attn").pvt_sra_attention
    f.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
                  + [ctypes.c_int] * 5
                  + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


@functools.cache
def _kv_kernel():
    f = _build.library("pvt_kv").pvt_sra_kv
    f.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_float]
                  + [ctypes.c_void_p] * 4 + [ctypes.c_float]
                  + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def _launch_attention(x, norm_w, norm_b, wq, bq, kv, wp, bp, num_heads, eps,
                      exact_residual: bool, what: str):
    n, h, w, d = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _attention_kernel()(
            _build.DTYPE_CODES[x.dtype], int(exact_residual),
            *(t.data_ptr() for t in (x, norm_w, norm_b, wq, bq, kv, wp, bp,
                                     out)),
            n, h * w, d, num_heads, kv.shape[1], eps,
            1.0 / (d // num_heads) ** 0.5, _build.stream_ptr(x))
    _build.check(err, what)
    return out


def sra_attention(x, norm_w, norm_b, wq, bq, kv, wp, bp, num_heads: int,
                  eps: float = 1e-6):
    """The attention half of a PVTv2 block over channels-last tokens, K/V
    given.

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
    d = x.shape[-1]
    if kv.dim() != 3 or kv.shape[0] != x.shape[0] or kv.shape[1] < 1:
        raise ValueError(f"sra_attention: kv must be (N, Tkv, 2D), got "
                         f"{tuple(kv.shape)} with x {tuple(x.shape)}")
    check_args("sra_attention", x,
               {"norm_w": (norm_w, (d,)), "norm_b": (norm_b, (d,))},
               {"wq": (wq, (d, d)), "bq": (bq, (d,)), "wp": (wp, (d, d)),
                "bp": (bp, (d,)),
                "kv": (kv, (x.shape[0], kv.shape[1], 2 * d))})
    check_heads("sra_attention", d, num_heads)
    check_aligned("sra_attention", x=x, norm_w=norm_w, norm_b=norm_b, wq=wq,
                  bq=bq, kv=kv, wp=wp, bp=bp)
    _build.refuse_grad("sra_attention", x, norm_w, norm_b, wq, bq, kv, wp,
                       bp)
    if x.numel() == 0:
        return torch.empty_like(x)
    out = _launch_attention(x, norm_w, norm_b, wq, bq, kv, wp, bp, num_heads,
                            eps, False, "sra_attention")
    sra_attention.launches += 1
    return out


sra_attention.launches = 0


def check_sra_block_args(what, x, norm_w, norm_b, wq, bq, sr_w, sr_b, kvn_w,
                         kvn_b, wkv, bkv, wp, bp, num_heads, sr):
    """``check_args`` and the rest of what the whole-half kernels take."""
    if sr < 1 or x.dim() != 4 or x.shape[1] < sr or x.shape[2] < sr:
        raise ValueError(f"{what}: sr ({sr}) must be at least 1 and at most "
                         f"H and W, x {tuple(x.shape)}")
    if sr > 1 and any(t is None for t in (sr_w, sr_b, kvn_w, kvn_b)):
        raise ValueError(f"{what}: sr {sr} needs the sr convolution and the "
                         "K/V LayerNorm")
    d = x.shape[-1]
    ln = {"norm_w": (norm_w, (d,)), "norm_b": (norm_b, (d,))}
    typed = {"wq": (wq, (d, d)), "bq": (bq, (d,)), "wkv": (wkv, (2 * d, d)),
             "bkv": (bkv, (2 * d,)), "wp": (wp, (d, d)), "bp": (bp, (d,))}
    if sr > 1:
        ln.update(kvn_w=(kvn_w, (d,)), kvn_b=(kvn_b, (d,)))
        typed.update(sr_w=(sr_w, (d, d, sr, sr)), sr_b=(sr_b, (d,)))
    check_args(what, x, ln, typed)
    check_heads(what, d, num_heads)
    check_aligned(what, x=x, norm_w=norm_w, norm_b=norm_b, wq=wq, bq=bq,
                  wkv=wkv, wp=wp, bp=bp)


def kv_scratch(x, sr: int):
    """The K/V kernels' float32 scratch for the patch product's partial
    sums, one per patch row, (sr, N * Tkv, D); None at sr = 1."""
    n, h, w, d = x.shape
    if sr == 1:
        return None
    return torch.empty((sr, n * (h // sr) * (w // sr), d),
                       dtype=torch.float32, device=x.device)


def _launch_kv(x, norm_w, norm_b, sr_wt, sr_b, kvn_w, kvn_b, wkv, bkv, sr,
              eps, what):
    """The K/V path kernels: (N, Tkv, 2D) in x's type.  ``sr_wt`` is
    ``sr_weight(sr_w)`` made contiguous (None at sr = 1)."""
    n, h, w, d = x.shape
    kv = torch.empty((n, (h // sr) * (w // sr), 2 * d), dtype=x.dtype,
                     device=x.device)
    part = kv_scratch(x, sr)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        err = _kv_kernel()(
            _build.DTYPE_CODES[x.dtype], *map(ptr, (x, norm_w, norm_b)), eps,
            *map(ptr, (sr_wt, sr_b, kvn_w, kvn_b)), KV_EPS,
            *map(ptr, (wkv, bkv, part, kv)), n, h, w, d, sr,
            _build.stream_ptr(x))
    _build.check(err, what)
    return kv


def sra_block(x, norm_w, norm_b, wq, bq, sr_w, sr_b, kvn_w, kvn_b, wkv, bkv,
              wp, bp, num_heads: int, sr: int, eps: float = 1e-6):
    """The whole attention half of a PVTv2 block over channels-last tokens,
    the K/V path included (``sr_w``, ``sr_b``, ``kvn_w``, ``kvn_b`` may be
    None at sr = 1).

    CPU tensors: the plain version.  CUDA tensors: the K/V path
    (``csrc/pvt_kv.cu``, two launches where sr > 1) and the attention
    (``csrc/pvt_attn.cu``); the
    same types as ``sra_attention``, any H and W of at least sr (the
    convolution's floor), and a RuntimeError where a launch is refused.
    ``sra_block.launches`` counts calls that launched the kernels.
    """
    args = (x, norm_w, norm_b, wq, bq, sr_w, sr_b, kvn_w, kvn_b, wkv, bkv,
            wp, bp, num_heads, sr)
    if x.device.type == "cpu":
        return sra_block_plain(*args, eps)
    if x.device.type != "cuda":
        raise ValueError(f"sra_block: unsupported device {x.device}")
    check_sra_block_args("sra_block", *args)
    _build.refuse_grad("sra_block", *args[:13])
    if x.numel() == 0:
        return torch.empty_like(x)
    sr_wt = sr_weight(sr_w).contiguous() if sr > 1 else None
    kv = _launch_kv(x, norm_w, norm_b, sr_wt, sr_b, kvn_w, kvn_b, wkv, bkv,
                   sr, eps, "sra_block")
    out = _launch_attention(x, norm_w, norm_b, wq, bq, kv, wp, bp, num_heads,
                            eps, True, "sra_block")
    sra_block.launches += 1
    return out


sra_block.launches = 0

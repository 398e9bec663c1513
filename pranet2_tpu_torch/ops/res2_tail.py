"""The Bottle2neck tail, ``relu(conv1x1(cc) * s3 + t3 + short)``, and the
inference BatchNorm fold both Res2Net kernels take.

Port of ``pranet2_tpu/ops/res2_tail.py::_kernel`` (launcher ``fused_tail``)
and ``pranet2_tpu/ops/res2_block.py::fold_bn``.  ``fused_tail`` launches the
hand-written kernel (``csrc/res2_tail.cu``) on a CUDA tensor and runs the
plain version on a CPU tensor.  Both follow the TPU kernel's arithmetic, not
its XLA reference's: the projection is accumulated in float32 from operands
in the input's type and is not rounded before the BatchNorm; then
``* s3 + t3``, ``+ short`` in float32, ReLU and one cast.

Maps are NCHW: cc (N, Cin, H, W), short (N, Cout, H, W); ``w3`` is the 1x1
conv weight as a (Cout, Cin) matrix; ``s3``, ``t3`` the folded BatchNorm in
float32.  Forward only: training runs the module chain.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pranet2_tpu_torch.ops import _build


def fold_bn(weight, bias, mean, var, eps: float = 1e-5):
    """Inference BatchNorm -> per-channel float32 (scale, shift):
    ``s = weight * rsqrt(var + eps)``, ``t = bias - mean * s``."""
    s = weight.float() * torch.rsqrt(var.float() + eps)
    return s, bias.float() - mean.float() * s


def bn_relu(z: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
            res: torch.Tensor | None = None) -> torch.Tensor:
    """float32 ``relu(z * s + t [+ res])`` with per-channel s, t over dim 1."""
    z = z * s[:, None, None] + t[:, None, None]
    if res is not None:
        z = z + res.float()
    return torch.relu(z)


def conv1x1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float32 product of a (Cout, Cin) weight with an NCHW map."""
    n, _, h, wd = x.shape
    return torch.matmul(w.float(), x.float().flatten(2)).view(n, -1, h, wd)


def res2_tail_plain(cc, short, w3, s3, t3):
    """Plain PyTorch version, with the kernel's roundings."""
    return bn_relu(conv1x1(cc, w3), s3, t3, short).to(cc.dtype)


@functools.cache
def _kernel():
    lib = _build.library("res2_tail")
    f, ws = lib.res2_tail, lib.res2_tail_workspace
    f.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    ws.argtypes = [ctypes.c_int] * 6
    ws.restype = ctypes.c_longlong
    return f, ws


def check_args(what: str, x, mats: dict, vecs: dict) -> None:
    """Raise unless x is a contiguous float32/bfloat16 NCHW map on a CUDA
    device, every matrix in ``mats`` (name -> (tensor, shape)) has its shape
    and x's type, every vector in ``vecs`` is float32 of its shape, and all
    are contiguous on x's device."""
    ts = [x] + [t for t, _ in mats.values()] + [t for t, _ in vecs.values()]
    if not all(t.device == x.device for t in ts):
        raise ValueError(f"{what}: inputs must all lie on one CUDA device, "
                         f"got {sorted({str(t.device) for t in ts})}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: maps must be float32 or bfloat16, got "
                        f"{x.dtype}")
    bad = [k for k, (t, s) in {**mats, **vecs}.items() if tuple(t.shape) != s]
    if bad:
        raise ValueError(f"{what}: wrong shapes for {bad} with x "
                         f"{tuple(x.shape)}")
    bad = [k for k, (t, _) in mats.items() if t.dtype != x.dtype]
    bad += [k for k, (t, _) in vecs.items() if t.dtype != torch.float32]
    if bad:
        raise TypeError(f"{what}: {bad} must be {x.dtype} (BatchNorm scale "
                        "and shift float32)")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: inputs must be contiguous (maps NCHW)")
    if max(t.numel() for t in ts) >= 2 ** 31:
        raise ValueError(f"{what}: tensors must have fewer than 2^31 elements")
    if x.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t, _ in
                                         [(x, None), *mats.values()]):
        raise ValueError(f"{what}: bfloat16 maps and weights must be 16-byte "
                         "aligned")


def fused_tail(cc, short, w3, s3, t3):
    """``relu(conv1x1(cc) * s3 + t3 + short)`` in one pass.

    CPU tensors: the plain version.  CUDA tensors: the kernel, which takes
    contiguous NCHW maps and w3 in one type (float32 or bfloat16; in
    bfloat16 Cin a multiple of 8, Cout even, cc and w3 16-byte aligned), s3
    and t3 in float32, and raises on anything else.  ``fused_tail.launches`` counts
    kernel launches.
    """
    if cc.device.type == "cpu":
        return res2_tail_plain(cc, short, w3, s3, t3)
    if cc.device.type != "cuda":
        raise ValueError(f"fused_tail: unsupported device {cc.device}")
    if cc.dim() != 4:
        raise ValueError(f"fused_tail: cc must be NCHW, got {tuple(cc.shape)}")
    n, cin, h, w = cc.shape
    cout = w3.shape[0]
    check_args("fused_tail", cc,
               {"short": (short, (n, cout, h, w)), "w3": (w3, (cout, cin))},
               {"s3": (s3, (cout,)), "t3": (t3, (cout,))})
    if cc.dtype == torch.bfloat16 and (cin % 8 or cout % 2):
        raise ValueError(f"fused_tail: bfloat16 takes Cin ({cin}) a multiple "
                         f"of 8 and Cout ({cout}) even")
    _build.refuse_grad("fused_tail", cc, short, w3, s3, t3)
    out = torch.empty_like(short)
    if out.numel() == 0:
        return out
    code = _build.DTYPE_CODES[cc.dtype]
    kernel, elems = _kernel()
    with torch.cuda.device(cc.device):
        # float32 scratch for the split-K partial sums, where the launch
        # splits on this device
        ws = torch.empty(max(elems(code, n, cin, cout, h, w), 1),
                         dtype=torch.float32, device=cc.device)
        err = kernel(code, cc.data_ptr(), short.data_ptr(), w3.data_ptr(),
                     s3.data_ptr(), t3.data_ptr(), out.data_ptr(),
                     ws.data_ptr(), n, cin, cout, h, w, _build.stream_ptr(cc))
    _build.check(err, "fused_tail")
    fused_tail.launches += 1
    return out


fused_tail.launches = 0

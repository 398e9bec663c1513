"""DSRA gate, PraNet-V2's signature op: ``fg + fg * softmax_c(crop_fg - crop_bg)``,
and the decoder level around it.

Port of ``pranet2_tpu/ops/dsra.py::_dsra_kernel``.  ``dsra_gate`` launches
the hand-written kernel (``csrc/dsra.cu``) on a CUDA tensor and runs the
plain version on a CPU tensor.  Both follow the TPU kernel's rounding: the
difference in the input type, the channel softmax in float32, the gate cast
back to fg's type.  Tensors are NCHW; the softmax runs over C.

``dsra_level`` is a whole decoder level of PraNet-V2 in one launch of the
same source: the crops of the previous level's maps, the gate, and the
maps resized to the input's size (``dsra_level_plain`` is the chain of
``resize_bilinear`` and ``dsra_gate_plain`` it replaces).  It is forward
only: the model calls it in eval with autograd off, and keeps the chain
with ``dsra_gate`` otherwise.

``dsra_gate`` is a ``torch.autograd.Function``: its backward recomputes
the plain version's math and differentiates it, as the JAX package's
custom VJP differentiates its XLA math (``pranet2_tpu/ops/dsra.py:83-124``).
The plain version computes in ``promote_types(dtype, float32)``: float32
for bf16 and f32 inputs, float64 for float64 ones, as JAX under x64.  The
gate's kernel has a float64 instance with its softmax in double, so that a
float64 train step runs through it on the card; ``dsra_level`` takes
float32, bf16 and float16 only.

``reverse_attention`` is PraNet-V1's gate, ``(1 - sigmoid(crop)) * feat``;
in the JAX package it is XLA elementwise code, not a Pallas kernel, so here
it is plain PyTorch on every device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pranet2_tpu_torch.ops import _build
from pranet2_tpu_torch.ops.resize import resize_bilinear

# the element types of dsra_gate's kernel: the port's three and float64
GATE_CODES = {**_build.DTYPE_CODES, torch.float64: 3}


def dsra_gate_plain(fg: torch.Tensor, crop_fg: torch.Tensor,
                    crop_bg: torch.Tensor, use_softmax: bool = True
                    ) -> torch.Tensor:
    """Plain PyTorch version of the gate."""
    diff = (crop_fg - crop_bg).to(torch.promote_types(fg.dtype,
                                                      torch.float32))
    gate = torch.softmax(diff, dim=1) if use_softmax else diff
    return fg + fg * gate.to(fg.dtype)


def reverse_attention(crop: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """PraNet-V1 reverse attention, ``(1 - sigmoid(crop)) * feat``: crop
    (N, 1, H, W) logits broadcast over feat's (N, C, H, W) channels
    (``pranet2_tpu/ops/dsra.py:58``)."""
    return (1.0 - torch.sigmoid(crop)) * feat


@functools.cache
def _kernel():
    f = _build.library("dsra").dsra_gate
    f.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                  ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _forward(fg, crop_fg, crop_bg, use_softmax):
    ts = (fg, crop_fg, crop_bg)
    if all(t.device.type == "cpu" for t in ts):
        return dsra_gate_plain(fg, crop_fg, crop_bg, use_softmax)
    if not all(t.device.type == "cuda" and t.device == fg.device for t in ts):
        raise ValueError("dsra_gate: inputs must all lie on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
    if fg.dim() != 4 or any(t.shape != fg.shape for t in ts):
        raise ValueError("dsra_gate: needs three NCHW tensors of one shape, "
                         f"got {[tuple(t.shape) for t in ts]}")
    if fg.dtype not in GATE_CODES or any(t.dtype != fg.dtype for t in ts):
        raise TypeError("dsra_gate: needs one float type for all inputs, got "
                        f"{[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("dsra_gate: inputs must be contiguous")
    n, c, h, w = fg.shape
    out = torch.empty(fg.shape, dtype=fg.dtype, device=fg.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(fg.device):
        err = _kernel()(GATE_CODES[fg.dtype], fg.data_ptr(),
                        crop_fg.data_ptr(), crop_bg.data_ptr(), out.data_ptr(),
                        n, c, h * w, int(use_softmax), _build.stream_ptr(fg))
    _build.check(err, "dsra_gate")
    dsra_gate.launches += 1
    return out


class _Gate(torch.autograd.Function):
    """The kernel (or, on the CPU, the plain version) forward; the plain
    version's math recomputed and differentiated backward."""

    @staticmethod
    def forward(ctx, fg, crop_fg, crop_bg, use_softmax):
        ctx.use_softmax = use_softmax
        ctx.save_for_backward(fg, crop_fg, crop_bg)
        return _forward(fg, crop_fg, crop_bg, use_softmax)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(r)
                   for t, r in zip(ctx.saved_tensors, need)]
            out = dsra_gate_plain(*ins, ctx.use_softmax)
            got = iter(torch.autograd.grad(
                out, [t for t in ins if t.requires_grad], grad))
        return (*(next(got) if r else None for r in need), None)


def dsra_gate(fg: torch.Tensor, crop_fg: torch.Tensor, crop_bg: torch.Tensor,
              use_softmax: bool = True) -> torch.Tensor:
    """The gate over (N, C, H, W) maps; ``use_softmax=False`` is the linear form.

    CPU tensors: the plain version.  CUDA tensors: the kernel, which takes
    three contiguous tensors of one shape and one float type (float32,
    bfloat16, float16 or float64) and raises on anything else.  Differentiable in every input (backward through the
    plain math).  ``dsra_gate.launches`` counts kernel launches.
    """
    return _Gate.apply(fg, crop_fg, crop_bg, use_softmax)


dsra_gate.launches = 0


def dsra_level_plain(prev_fg, prev_bg, ra_fg, ra_bg, out_size,
                     use_softmax: bool = True, emit_prev: bool = False,
                     gate=dsra_gate_plain):
    """Plain PyTorch version of ``dsra_level``: ``resize_bilinear`` and
    ``gate``, the model's chain (which passes ``dsra_gate``, the kernel
    forward with a backward, where autograd records)."""
    size = tuple(ra_fg.shape[-2:])
    gated = gate(ra_fg, resize_bilinear(prev_fg, size),
                 resize_bilinear(prev_bg, size), use_softmax)
    full = (gated, ra_bg, prev_fg, prev_bg) if emit_prev else (gated, ra_bg)
    return (gated, *(resize_bilinear(t, out_size) for t in full))


@functools.cache
def _level_kernel():
    f = _build.library("dsra").dsra_level
    f.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def dsra_level(prev_fg: torch.Tensor, prev_bg: torch.Tensor,
               ra_fg: torch.Tensor, ra_bg: torch.Tensor, out_size,
               use_softmax: bool = True, emit_prev: bool = False):
    """One decoder level: ``gated = dsra_gate(ra_fg, crop_fg, crop_bg)``
    with ``crop_* = resize_bilinear(prev_*, ra_fg.shape[-2:])``, then
    ``resize_bilinear`` of gated and ra_bg to ``out_size``, and with
    ``emit_prev`` of prev_fg and prev_bg too.

    Returns ``(gated, map_fg, map_bg)``, or ``(gated, map_fg, map_bg,
    map_prev_fg, map_prev_bg)``.  CPU tensors: the plain version.  CUDA
    tensors: one launch of the kernel, which takes four contiguous NCHW maps
    of one float type (prev_* of one shape, ra_* of another, the same N and
    C) and raises on anything else, or where autograd records and an input
    requires grad (forward only).  The outputs are views of one buffer.
    ``dsra_level.launches`` counts kernel launches.
    """
    ts = (prev_fg, prev_bg, ra_fg, ra_bg)
    dev = ra_fg.device
    if dev.type == "cpu" and all(t.device == dev for t in ts):
        return dsra_level_plain(*ts, out_size, use_softmax, emit_prev)
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("dsra_level: inputs must all lie on one CUDA device, "
                         f"got {[str(t.device) for t in ts]}")
    shape, pshape = ra_fg.shape, prev_fg.shape
    if (len(shape) != 4 or len(pshape) != 4 or ra_bg.shape != shape
            or prev_bg.shape != pshape or pshape[:2] != shape[:2]):
        raise ValueError("dsra_level: needs NCHW prev_fg, prev_bg of one shape"
                         " and ra_fg, ra_bg of another, with one N and C; got "
                         f"{[tuple(t.shape) for t in ts]}")
    dt = ra_fg.dtype
    code = _build.DTYPE_CODES.get(dt)
    if code is None or any(t.dtype != dt for t in ts):
        raise TypeError("dsra_level: needs one float type for all inputs, got "
                        f"{[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("dsra_level: inputs must be contiguous")
    _build.refuse_grad("dsra_level", *ts)
    n, c, h, w = shape
    oh, ow = (int(v) for v in out_size)
    k = 4 if emit_prev else 2
    full = k * n * c * oh * ow
    buf = torch.empty(full + n * c * h * w, dtype=dt, device=dev)
    maps = buf[:full].view(k, n, c, oh, ow)
    out = (buf[full:].view(n, c, h, w), *maps.unbind(0))
    if buf.numel() == 0:
        return out
    args = (code, *(t.data_ptr() for t in (*ts, out[0], maps)), n, c,
            pshape[2], pshape[3], h, w, oh, ow, int(use_softmax),
            int(emit_prev), _build.stream_ptr(ra_fg))
    if dev.index == torch.cuda.current_device():
        err = _level_kernel()(*args)
    else:
        with torch.cuda.device(dev):
            err = _level_kernel()(*args)
    _build.check(err, "dsra_level")
    dsra_level.launches += 1
    return out


dsra_level.launches = 0

"""DSRA gate, PraNet-V2's signature op: ``fg + fg * softmax_c(crop_fg - crop_bg)``.

Port of ``pranet2_tpu/ops/dsra.py::_dsra_kernel``.  ``dsra_gate`` launches
the hand-written kernel (``csrc/dsra.cu``) on a CUDA tensor and runs the
plain version on a CPU tensor.  Both follow the TPU kernel's rounding: the
difference in the input type, the channel softmax in float32, the gate cast
back to fg's type.  Tensors are NCHW; the softmax runs over C.

``dsra_gate`` is a ``torch.autograd.Function``: its backward recomputes
the plain version's math and differentiates it, as the JAX package's
custom VJP differentiates its XLA math (``pranet2_tpu/ops/dsra.py:83-124``).
The plain version computes in ``promote_types(dtype, float32)``: float32
for bf16 and f32 inputs, float64 for float64 ones, as JAX under x64.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pranet2_tpu_torch.ops import _build


def dsra_gate_plain(fg: torch.Tensor, crop_fg: torch.Tensor,
                    crop_bg: torch.Tensor, use_softmax: bool = True
                    ) -> torch.Tensor:
    """Plain PyTorch version of the gate."""
    diff = (crop_fg - crop_bg).to(torch.promote_types(fg.dtype,
                                                      torch.float32))
    gate = torch.softmax(diff, dim=1) if use_softmax else diff
    return fg + fg * gate.to(fg.dtype)


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
    if fg.dtype not in _build.DTYPE_CODES or any(t.dtype != fg.dtype
                                                 for t in ts):
        raise TypeError("dsra_gate: needs one float type for all inputs, got "
                        f"{[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("dsra_gate: inputs must be contiguous")
    n, c, h, w = fg.shape
    out = torch.empty(fg.shape, dtype=fg.dtype, device=fg.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(fg.device):
        err = _kernel()(_build.DTYPE_CODES[fg.dtype], fg.data_ptr(),
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
    three contiguous tensors of one shape and one float type and raises on
    anything else.  Differentiable in every input (backward through the
    plain math).  ``dsra_gate.launches`` counts kernel launches.
    """
    return _Gate.apply(fg, crop_fg, crop_bg, use_softmax)


dsra_gate.launches = 0

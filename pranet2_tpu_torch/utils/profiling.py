"""Profiling and cost analysis for the port: the parts of
``pranet2_tpu/utils/profiling.py`` that ``cli/benchmark.py`` uses.

* ``device_peak_tflops``: the card's name and its dense bf16 peak in
  TFLOP/s from the maker's data sheet, for MFU bookkeeping (None for a
  card not in the table, and for the CPU).
* ``cost_analysis``: the FLOPs of a forward, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` over the model's module
  chain: at batch 1 with autograd on, which sends every kernel site of the
  port to its chain (the kernels are forward only), so the count is the
  same whatever implements a layer.  A kernel launched through ctypes is
  invisible to the counter.  The JAX package reads the compiled XLA
  executable instead.
* ``fence`` (``torch.cuda.synchronize``: CUDA work is asynchronous, so a
  host clock must be closed by it).

``enable_compile_cache`` has no counterpart: nothing here is compiled by
XLA, and the port's kernels are built once per checkout by ``ops._build``.
``count_params``, ``throughput``, ``trace`` and ``Timer`` are not ported:
the benchmark calls none of them.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

# dense bf16 TFLOP/s (no sparsity) by device name: the H100 SXM data sheet
PEAK_BF16_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.0}


def device_peak_tflops(device=None) -> tuple[str, float | None]:
    """(device name, dense bf16 peak TFLOP/s or None) of ``device`` (the
    current CUDA device when None and a GPU is present, else the CPU)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu", None
    name = torch.cuda.get_device_name(device)
    return name, PEAK_BF16_TFLOPS.get(name)


def cost_analysis(model: nn.Module, x: torch.Tensor) -> dict:
    """``{"flops": n}``: the FLOPs of one image's forward of ``model`` on
    ``x[:1]``, counted over its module chain (autograd on; no kernel
    launches)."""
    with torch.enable_grad(), FlopCounterMode(display=False) as counter:
        model(x[:1])
    return {"flops": counter.get_total_flops()}


def _cuda_devices(out) -> set:
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return set().union(*map(_cuda_devices, out)) if out else set()
    return set()


def fence(out):
    """Completion barrier for timing: waits for the CUDA devices that hold
    a tensor of ``out`` (any nesting of tuples, lists and dicts).  Returns
    ``out``."""
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)
    return out


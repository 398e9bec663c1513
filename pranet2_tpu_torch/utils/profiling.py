"""Profiling and cost analysis for the port, after
``pranet2_tpu/utils/profiling.py``.

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
* ``count_params``: a model's number of parameters.
* ``fence`` (``torch.cuda.synchronize``: CUDA work is asynchronous, so a
  host clock must be closed by it), and the meters that close their
  clocks with it: ``Timer`` and ``throughput``.
* ``span`` and ``recording``: the program's own spans.  ``span(name,
  key)`` marks a stretch of host time at a layer boundary; it does
  nothing unless recording is on, which ``recording(sink)`` turns on for a
  block, handing each span to ``sink`` as it ends.  Spans are kept by the
  sink, in memory; nothing here writes them out.
* ``trace``: a ``torch.profiler`` session that writes a Chrome trace
  (TensorBoard's layout), where the JAX package's writes an XProf one;
  the spans opened in it are ranges of that trace.

``enable_compile_cache`` has no counterpart: nothing here is compiled by
XLA, and the port's kernels are built once per checkout by ``ops._build``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

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



def count_params(model: nn.Module) -> int:
    """The number of parameters of ``model`` (each shared one once)."""
    return sum(p.numel() for p in model.parameters())


class Timer:
    """Wall-clock timer that closes each measurement with ``fence``: put
    the work's output in the yielded dict's ``"result"``."""

    def __init__(self):
        self.times: list[float] = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        out = {}
        yield out
        if "result" in out:
            fence(out["result"])
        self.times.append(time.perf_counter() - t0)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)


def throughput(fn, args, batch_size: int, iters: int = 50,
               warmup: int = 2) -> float:
    """Images a second of ``fn(*args)`` over ``iters`` calls after
    ``warmup`` more, each end closed by ``fence`` on the output."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    fence(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    fence(out)
    return batch_size * iters / (time.perf_counter() - t0)


# (sink, ranges) while recording, None while not: ``sink`` is called at
# each span's end (or None), ``ranges`` makes each span a profiler range
_recording = None
_OFF = contextlib.nullcontext()


class _Open(threading.local):
    """The names of the spans open in this thread, outermost first."""

    def __init__(self):
        self.names = []


_open = _Open()


class _Span:
    __slots__ = ("name", "key", "sink", "range", "parent", "t0")

    def __init__(self, name, key, sink, ranges):
        self.name, self.key, self.sink = name, key, sink
        self.range = (torch.profiler.record_function(
            name, None if key is None else str(key)) if ranges else None)

    def __enter__(self):
        names = _open.names
        self.parent = names[-1] if names else None
        names.append(self.name)
        if self.range is not None:
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.range is not None:
            self.range.__exit__(*exc)
        _open.names.pop()
        if self.sink is not None:
            self.sink(self.name, self.t0, t1, self.parent, self.key)
        return False


def span(name: str, key=None):
    """A context manager that records the block as a span of ``name``
    while recording is on: its start and end on ``time.perf_counter()``,
    the name of the span open around it in this thread (its parent, None
    at the top) and ``key`` (what ties the spans of one unit of work
    together, e.g. a served batch's number).  While recording is off it
    is one shared no-op."""
    if _recording is None:
        return _OFF
    return _Span(name, key, *_recording)


@contextlib.contextmanager
def _record(sink, ranges):
    global _recording
    before = _recording
    _recording = (sink, ranges)
    try:
        yield
    finally:
        _recording = before


@contextlib.contextmanager
def recording(sink):
    """Turns recording on for the block: ``sink(name, t0, t1, parent,
    key)`` is called, in the span's thread, at the end of each span (see
    ``span``).  The state before it comes back on exit."""
    with _record(sink, _recording is not None and _recording[1]):
        yield


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` session over the block (the host's activity,
    and the card's where there is one), written on exit as a Chrome trace
    (``<worker>.<ns>.pt.trace.json``) under ``logdir``, which TensorBoard
    and chrome://tracing read.  Recording is on in the session, each span
    a ``record_function`` range of the trace (its key in ``args``) above
    the operations it launched, and handed to the sink of an enclosing
    ``recording`` as well.  Yields the profiler."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    sink = _recording[0] if _recording is not None else None
    prof.start()
    try:
        with _record(sink, True):
            yield prof
    finally:
        prof.stop()

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pranet2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions, then builds every kernel in ``pranet2_tpu_torch/csrc`` with nvcc.
2. Holds each kernel against its plain PyTorch version at the shapes the
   serving paths give it, and times kernel, plain version and, where one
   PyTorch call computes the same function, that call (CUDA events, median);
   for the PVT and Res2Net kernels, which no single call computes, it times
   the eager chain of PyTorch calls instead (``library_chain_ms``), for
   the stem tail (``stem_pool``) and the decoder level (``dsra_level``)
   the ATen chain each replaced; the whole-half and whole-block kernels'
   launches are also timed apart, with their grids, from a device trace
   (``launch_profile``).  The depthwise 3x3, which no model calls, is
   checked at PVTv2-b2's hidden shapes; the bare maxpool, which the served
   forwards no longer call, at the shape it had; the standalone gate, the
   forward of the gate's autograd Function and so the training path's
   kernel, at the train step's shapes in float32, bf16 and float64.
3. Serves eight paths of the port (full width and depth, random weights
   from a seed), in bf16 at 352x352, batch 16: PraNet-V2 on Res2Net-50, the
   same with its fused Res2Net blocks (``fused=True, tailfuse=True``),
   PraNet-V2 on PVTv2-b2 with its default kernels, with the whole-half
   attention (``attn_impl="v2"``) and with the whole-block kernel
   (``blockfuse=True``), and PraNet-V1 on Res2Net-50, PVTv2-b2 and
   ResNet-50 (no decoder kernel: V1's reverse attention and resizes are
   ATen; the finest map served); each through ``serve.BinaryPredictor.stream``
   over seeded synthetic images, with the kernels' launch counters set to 0
   just before and read just after; times the forward alone (CUDA events),
   its device time by kernel (torch.profiler) and the host stages of one
   batch, and finds in a CPU-side trace none of the ATen ops the stem and
   decoder kernels replaced (``replaced_ops``); then checks the bf16
   logits against a float32 forward of the same weights (the module chain
   but for the stem and decoder kernels: no kernel of the fused or PVT
   paths), and the GPU's float32 forward against the CPU's (plain
   versions) on a small input.
4. Trains (``run_training``), with PyTorch's default float32 flags: one
   float64 step of PraNet-V2 at 256 x 256 on the card through the gate's
   float64 kernel against the same step on the CPU; the binary recipe
   through ``train.binary.train`` (pranet_v2 float32, batch 8 at 352,
   scales 0.75/1/1.25, 12 steps over a synthetic set written to a temp
   directory, the in-loop evaluation and a snapshot), with its launch
   counts, img/s, ms a step at each scale, peak memory and the step's
   device busy time; and 4 steps on a fixed batch of pranet_v2 in bf16
   (autocast) and of pvt_pranet_v2 with drop path 0.1.  Each part prints a
   ``train:`` JSON line beside the card's name and power limit.
5. Runs the binary inference CLIs as a user does, each in its own
   process (``run_cli``): ``cli.test_binary`` on a reference-style
   ``pranet_v1`` checkpoint over two synthetic sets, ``cli.eval_binary`` on
   its PNGs and ``cli.benchmark`` (pranet_v1 and pranet_v1_resnet, batch 1
   and 16); prints a ``cli:`` JSON line beside the card and the
   benchmark's table.
6. The multiclass phase (``serve_volume_path``, ``run_multiclass_training``,
   ``run_multiclass_cli``): EMCAD served on PVTv2-b2 and on ResNet-50
   (bf16, 9 classes, random weights from seed 0) over one synthetic
   CT-sized volume (32 slices of 512^2, labels 0-8) through
   ``train.multiclass.test_volumes`` (host zoom to 224, chunks of 16,
   ``fg_only``), with the launch counters set to 0 just before and read
   just after; the forward timed (CUDA events) with its device time by
   kernel, the host's zoom of a chunk and the volume's wall time; its bf16
   logits against float32 (TF32 off) and the card's float32 maps against
   the CPU's.  Then ``train_multiclass`` on EMCAD-B2 (float32, batch 6 at
   224, 8 steps over 12 synthetic Synapse slices, validated on an
   ACDC-layout split) with its launches, ms a step, img/s, peak memory
   and busy time; then ``cli.train_multiclass`` (``pvt_v2_b0``, one epoch)
   and ``cli.test_multiclass --dataset acdc`` (a reference-style
   ``.pth``), each in its own process.  Rows 1, 2, 5 and 6 are held
   against their plain versions at EMCAD's shapes in step 2 (the 112^2
   stem map, the gates at 9 classes, the 224^2 PVT stages).
7. The MaxViT phase: ``merit_cascaded`` (small: two MaxViT backbones at
   256 and 224, the CASCADE decoder twice) and ``mist_cam``, dual, 9
   classes, bf16, served over the same volume (``serve_volume_path`` with
   Dice only; MERIT's ``fg_minus_bg``, MIST's ``fg_only``): 6 and 3
   ``dsra_gate`` launches a forward, no other kernel; each checked as
   EMCAD's.  Then one bf16 forward each of ``merit_parallel`` (256^2, 4
   classes, 6 gates) and the zoo (``maxvit_seg``, ``maxvit4out``,
   ``maxvit_cascade`` at 224^2, no kernel) against float32; then
   ``train_multiclass`` on MERIT-small and MIST (float32, batch 6 at 224,
   the seeded dropout on, 4 steps, 6 and 3 gates a step; ``train:``
   lines); then ``cli.test_multiclass --model mist --dataset acdc`` on a
   reference-style ``.pth`` (packed ``in_proj_weight``, the dead ``conv3``)
   and ``cli.train_multiclass --model merit`` (one epoch), each a process.
   Row 2 is held against its plain version at MERIT's and MIST's gates
   (9 classes at 14/28/56 and 16/32/64 px) in step 2.
8. The parallel phase (``run_parallel``), on the one card (two ranks or
   two replicas share it) unless two are present: two spawned ranks
   (gloo, ``parallel.spawn.launch``) take the float64 PraNet-V2 step at
   256 x 256, a row each, against this process's step on both rows (``train_card_vs_cpu``'s
   bounds, and the parameters after clip + Adam), then float32 steps at
   352 x 352, global batch 8, timed, with rank 0's profile of the
   gradient all-reduce; each holds the gate kernel at its shapes and
   counts 3 ``dsra_gate`` a step.  ``torchrun --nproc_per_node 2 -m
   pranet2_tpu_torch.cli.train_binary`` (two short epochs: rank 0's log
   lines only, one snapshot set).  A world-1 NCCL group: the EMCAD-B2 step
   through ``convert_sync_batchnorm`` and ``data_parallel`` against the
   step without a group, and SyncBatchNorm's Function over NCCL against
   ``F.batch_norm``.  ``BinaryPredictor(devices=["cuda:0"] * 2)`` (bf16,
   352, batch 16) against one device's: the masks equal to one device's
   at the chunk's batch (float32: within a level of batch 16's), a
   ``stem_pool`` and 3 ``dsra_level`` a forward in each replica, each
   replica's kernels held at its chunk's shapes.  With two cards, the
   ranks and the replicas again on two cards (NCCL); else "skipped (1
   card)".  Then
   ``cli.reproduce_baseline`` as a process on a reference ``.pth`` and a
   port ``.pt`` (the table, the PNGs, the PASS verdict, exit 1 on FAIL).
   Prints one ``parallel:`` JSON line (its other lines start otherwise).
9. Prints one JSON line of kernel results (``launches`` summed over the
   served paths, the one-forward checks, the training parts and the
   parallel phase's ranks and replicas, by path in ``launches_by_path``),
   then as the last line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device, outside the
repository, or when any check fails.
"""

from __future__ import annotations

import copy
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores
BF16_MMA_PER_S = 989e12     # H100 SXM, dense bf16 on the tensor cores
BATCH, SIZE = 16, 352
N_IMAGES = 40               # batches of 16, 16 and a padded 8
GATE_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
F64_GATE_TOL = 1e-12        # the float64 gate, relative to max |out|
# the binary recipe (pranet2_tpu/train/binary.py): batch 8 at 352, scales
# 0.75, 1 and 1.25 (256, 352 and 448)
TRAIN_BATCH, TRAIN_SIZE, TRAIN_RATES = 8, 352, (0.75, 1.0, 1.25)
# PVT kernels vs their plain versions (testing.excess): within a share of
# the largest |kernel part|, the output less its residual (or, with the
# stage LN, less LN(x)), plus half a step of each side's last rounding.
# float32 differs by summation order only; bfloat16 rounds at the same
# points, and an f32 ulp of difference can move a rounding by one bf16 step
# (2^-7 relative at most), so two steps.  The stats are held to the
# definition: (mu, rstd) of the kernel's own output, within 1e-4 of their
# max.
PVT_TOL = {"float32": 1e-4, "bfloat16": 2 * 2 ** -7}
STATS_TOL = 1e-4
# Res2Net kernels vs their plain versions (testing.excess, base x or the
# shortcut, which dominate |out|): float32 differs by summation order only;
# bfloat16 rounds at the same points (u, u_i + sp_{i-1}, each sp_i, out),
# and an f32 ulp of difference can move one of those roundings by a bf16
# step, which the next products carry, so two steps.
RES2_TOL = {"float32": 1e-4, "bfloat16": 2 * 2 ** -7}
# Res2Net-50-v1b at 352x352 by layer: (planes, map side, normal blocks)
RES2_LAYERS = ((64, 88, 2), (128, 44, 3), (256, 22, 5), (512, 11, 2))
MODEL_TOL = 0.1             # bf16 vs f32 logits, relative to max |f32|
F32_TOL = 1e-3              # GPU f32 vs CPU f32, relative to max |CPU|;
                            # cuDNN may pick Winograd/FFT algorithms
# PVTv2-b2 at 352x352: (tokens per side, dim, heads, mlp ratio, sr, depth)
# by stage
PVT_STAGES = ((88, 64, 1, 8, 8, 3), (44, 128, 2, 8, 4, 4),
              (22, 320, 5, 4, 2, 6), (11, 512, 8, 4, 1, 3))
# EMCAD-B2 on Synapse (multiclass_seg/EMCAD/train_synapse.py): 9 classes,
# 224x224 slices, batch 6 in training; served as volumes in chunks of 16
EMCAD_SIZE, EMCAD_CLASSES, EMCAD_TRAIN_BATCH = 224, 9, 6
EMCAD_GATE_SIDES = (14, 28, 56)   # the decoder's three gates at 224
MAXVIT_GATE_SIDES = (16, 32, 64)  # a CASCADE or CAM decoder's on a 256 pass
# PVTv2-b2 at 224x224, EMCAD's Synapse patch: the same stages, Tkv 49 at
# each (sr 8/4/2/1 on 56/28/14/7-px maps)
EMCAD_STAGES = ((56, 64, 1, 8, 8, 3), (28, 128, 2, 8, 4, 4),
                (14, 320, 5, 4, 2, 6), (7, 512, 8, 4, 1, 3))
# the depthwise 3x3 vs its plain version: float32 within 1e-5 of max |out|
# (the same sums in the same order), bf16 one step (tol 0 in
# testing.excess: each side's output rounding)
DW_TOL = {"float32": 1e-5, "bfloat16": 0.0}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def bound_ms(nbytes: int, ops: int, mma_ops: int = 0,
             mma_per_s: float = BF16_MMA_PER_S) -> tuple[float, str]:
    """The largest of the times the work needs on each unit: bytes over the
    HBM rate, ``ops`` over the float32 rate and ``mma_ops`` (matrix
    products) over ``mma_per_s``.  The units run at once, so the busiest
    one bounds the time; products at the float32 rate share its unit."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    work = {F32_OPS_PER_S: ops}
    work[mma_per_s] = work.get(mma_per_s, 0) + mma_ops
    t_ops = max(n / rate for rate, n in work.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the hand kernels' launches by name in a device trace
LAUNCH_LABELS = {"stem_pool_kernel": "stem_pool",
                 "dsra_level_kernel": "dsra_level",
                 "patch_kernel": "kv_patch", "finish_kernel": "kv_finish",
                 "attend_kernel": "attention", "mlp_kernel": "mlp",
                 "prep_kernel": "prep", "conv1x1_kernel": "conv1x1",
                 "conv3x3_kernel": "conv3x3",
                 "split_reduce_kernel": "split_reduce",
                 "res2_conv_kernel": "conv_f32",
                 "res2_split_epilogue": "split_epilogue_f32"}


# The tracer drops the device events that it places outside a session's
# window: a short session (five calls of a 0.2-0.4 ms launch) can come back
# with some or none of them.  Each session therefore opens TRACE_PAD_S
# before the first call and closes TRACE_PAD_S after the last one has
# finished, and one that still comes back short is traced again, up to
# TRACE_TRIES sessions in all.
TRACE_TRIES = 6
TRACE_PAD_S = 0.02
# sessions traced, and those that came back short (traced again)
TRACES = {"sessions": 0, "short": 0}


def _trace(torch, fn, calls: int) -> list:
    """The kernel events of ``calls`` calls of ``fn`` in a torch.profiler
    trace (after a warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD_S)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    TRACES["sessions"] += 1
    return [e for e in events if e.get("cat") == "kernel"]


def _profile(torch, fn, expect, calls: int) -> tuple[dict, set]:
    """``launch_profile`` and the names of every kernel in its trace."""
    for _ in range(TRACE_TRIES):
        out, names = {}, set()
        for e in _trace(torch, fn, calls):
            names.add(e.get("name", "")[:60])
            for key, label in LAUNCH_LABELS.items():
                if key in e.get("name", ""):
                    row = out.setdefault(label, {"ms": 0.0, "grids": [],
                                                 "per_call": 0.0})
                    row["ms"] += e.get("dur", 0.0) / 1e3 / calls
                    row["per_call"] += 1 / calls
                    grid = e.get("args", {}).get("grid")
                    if grid not in row["grids"]:
                        row["grids"].append(grid)
        if set(expect) <= set(out) and all(None not in out[k]["grids"]
                                           for k in expect):
            return out, names
        TRACES["short"] += 1
    raise AssertionError(f"no device trace, or no grid, of {sorted(expect)} "
                         f"in {TRACE_TRIES} sessions: {out}")


def launch_profile(torch, fn, expect, calls: int = 5) -> dict:
    """Device time, launches per call and grids of each labelled kernel
    ``fn`` launches (``{label: {"ms", "per_call", "grids"}}``, every
    distinct grid of the label's events); traced again, up to
    ``TRACE_TRIES`` sessions, while a label of ``expect`` is missing or an
    event of one carries no grid."""
    return _profile(torch, fn, expect, calls)[0]


def kernel_ms(torch, fn, calls: int = 20) -> float:
    """Device time a call of every kernel ``fn`` launches (torch.profiler's
    trace): the GPU's own time, free of the host's cost of each call."""
    for _ in range(TRACE_TRIES):
        ms = sum(e.get("dur", 0.0) for e in _trace(torch, fn, calls))
        if ms > 0:
            return ms / 1e3 / calls
        TRACES["short"] += 1
    raise AssertionError(f"no kernel in {TRACE_TRIES} device traces")


def host_ms(torch, fn, calls: int = 100) -> float:
    """The host's wall time a call of ``fn`` over back-to-back calls that
    do not wait for the card (perf_counter): the wrapper's own cost where
    the card keeps up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def _blocks(grid) -> int:
    return grid[0] * grid[1] * grid[2] if grid else 0


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def check_maxpool(torch, dev) -> list:
    """Row 1: ``stem_pool`` (bn1 + ReLU + the pool, the Res2Net paths'
    launch) and the bare ``max_pool3x3s2``, at the stem's serving shape,
    each bit for bit against its plain version.  ``stem_pool``'s library
    chain is what ATen ran before it, ``bn1`` (``F.batch_norm``), ReLU and
    ``F.max_pool2d``; each of those passes is timed apart too.  Then
    ``stem_pool`` at EMCAD-ResNet's stem (112^2 -> 56^2 at 224,
    ``emcad_forward``)."""
    import torch.nn.functional as F

    from pranet2_tpu_torch.ops import stem

    g = torch.Generator(device=dev).manual_seed(0)
    shape = (BATCH, 64, SIZE // 2, SIZE // 2)
    # the stem's raw conv3 output, and bn1's four vectors (float32)
    z = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    c = shape[1]
    w, b, mean = (torch.randn(c, generator=g, device=dev) * sc + sh
                  for sc, sh in ((0.1, 1.0), (0.1, 0.0), (0.1, 0.0)))
    var = 0.5 + torch.rand(c, generator=g, device=dev)
    bn = (w, b, mean, var)
    got = stem.stem_pool(z, *bn, 1e-5)
    want = stem.stem_pool_plain(z, *bn, 1e-5)
    x = torch.relu(torch.randn(shape, generator=g, device=dev)).to(
        torch.bfloat16)
    got_pool, want_pool = stem.max_pool3x3s2(x), stem.max_pool3x3s2_plain(x)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("stem_pool kernel differs from its plain version")
    if not torch.equal(got_pool, want_pool):
        raise AssertionError("maxpool kernel differs from its plain version")
    # per input element the BN's product and sum and the ReLU; per output
    # eight compares
    b_stem, by_stem = bound_ms(nbytes(z, got, *bn),
                               3 * z.numel() + 8 * got.numel())
    b_pool, by_pool = bound_ms(nbytes(x, got_pool), 8 * got_pool.numel())
    bn_pass = lambda: F.batch_norm(z, mean, var, w, b, False, 0.0, 1e-5)
    y = torch.relu(bn_pass())
    chain = lambda: F.max_pool2d(torch.relu(bn_pass()), 3, 2, 1)
    kernel = lambda: stem.stem_pool(z, *bn, 1e-5)
    stem_row = {
        "name": "stem_pool", "route": "cuda",
        "source": "pranet2_tpu_torch/csrc/maxpool.cu",
        "replaces": "pranet2_tpu/ops/stem.py:106",
        "max_abs_err": (got.float() - want.float()).abs().max().item(),
        "ms": time_ms(kernel), "device_ms": kernel_ms(torch, kernel),
        "host_ms": host_ms(torch, kernel),
        "plain_ms": time_ms(lambda: stem.stem_pool_plain(z, *bn, 1e-5)),
        "bound_ms": b_stem, "bound_by": by_stem, "library_ms": None,
        "library_chain_ms": time_ms(chain),
        "library_chain_device_ms": kernel_ms(torch, chain),
        "bn_pass_device_ms": kernel_ms(torch, bn_pass),
        "relu_pass_device_ms": kernel_ms(torch, lambda: torch.relu(y)),
        "launches_by_kernel": _one_launch(torch, kernel, "stem_pool",
                                          "stem_pool"),
        "shapes": [{"shape": list(shape), "dtype": "bfloat16"}]}
    pool = lambda: stem.max_pool3x3s2(x)
    library = lambda: F.max_pool2d(x, 3, 2, 1)
    pool_row = {
        "name": "max_pool3x3s2", "route": "cuda",
        "source": "pranet2_tpu_torch/csrc/maxpool.cu",
        "replaces": "pranet2_tpu/ops/stem.py:106",
        "max_abs_err": (got_pool.float()
                        - want_pool.float()).abs().max().item(),
        "ms": time_ms(pool),
        "device_ms": kernel_ms(torch, pool),
        "host_ms": host_ms(torch, pool),
        "plain_ms": time_ms(lambda: stem.max_pool3x3s2_plain(x)),
        "bound_ms": b_pool, "bound_by": by_pool,
        "library_ms": time_ms(library),
        "library_device_ms": kernel_ms(torch, library),
        "shapes": [{"shape": list(x.shape), "dtype": "bfloat16"}]}
    stem_row["emcad_forward"] = _stem_pool_at(
        torch, g, (BATCH, 64, EMCAD_SIZE // 2, EMCAD_SIZE // 2))
    stem_row["shapes"].append({"shape": [BATCH, 64, EMCAD_SIZE // 2,
                                         EMCAD_SIZE // 2],
                               "dtype": "bfloat16", "path": "emcad"})
    print(f"stem_pool: ms {stem_row['ms']:.4f}, device "
          f"{stem_row['device_ms']:.4f}, host {stem_row['host_ms']:.4f}, "
          f"chain {stem_row['library_chain_ms']:.4f} (device "
          f"{stem_row['library_chain_device_ms']:.4f}: bn "
          f"{stem_row['bn_pass_device_ms']:.4f}, relu "
          f"{stem_row['relu_pass_device_ms']:.4f}), bound {b_stem:.4f}; "
          f"max_pool3x3s2 device {pool_row['device_ms']:.4f}, F.max_pool2d "
          f"device {pool_row['library_device_ms']:.4f}")
    return [stem_row, pool_row]


def check_gate(torch, dev) -> list:
    """Row 2: ``dsra_level`` at PraNet-V2's three levels (16 images, one
    channel, bf16, maps at 352 x 352; level 4 emits map5's two maps) and two
    four-channel cases, against ``dsra_level_plain``
    (``testing.level_excess``); its library chain is the chain it replaced
    (four or six ``resize_bilinear`` calls and ``dsra_gate``).  Then the
    standalone gate ``dsra_gate`` at the levels' shapes, against
    ``dsra_gate_plain``."""
    from pranet2_tpu_torch.ops import dsra
    from pranet2_tpu_torch.ops.resize import resize_bilinear
    from pranet2_tpu_torch.testing import level_excess

    g = torch.Generator(device=dev).manual_seed(1)
    out = (SIZE, SIZE)
    # (prev side, branch side, emit_prev, channels, type, on the main path)
    cases = [(44, 11, True, 1, torch.bfloat16, True),
             (11, 22, False, 1, torch.bfloat16, True),
             (22, 44, False, 1, torch.bfloat16, True),
             (22, 44, False, 4, torch.float32, False),
             (22, 44, False, 4, torch.bfloat16, False)]
    rows = []
    for prev, ra, emit, c, dt, main in cases:
        ts = [torch.randn((BATCH, c, s, s), generator=g, device=dev).to(dt)
              for s in (prev, prev, ra, ra)]
        got = dsra.dsra_level(*ts, out, True, emit)
        want = dsra.dsra_level_plain(*ts, out, True, emit)
        torch.cuda.synchronize()
        name = str(dt).removeprefix("torch.")
        over = level_excess(got, want, out, GATE_TOL[name])
        if not over <= 1:
            raise AssertionError(f"dsra_level at {prev} -> {ra} C {c} {name}:"
                                 f" {over:.3g} times the tolerance")
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
        # per output pixel the four taps' weights and sums (7 flops); per
        # gated pixel two crops (14), the difference, the softmax and the
        # gate (12)
        b, by = bound_ms(nbytes(*ts, *got),
                         7 * sum(t.numel() for t in got[1:])
                         + 26 * got[0].numel())
        kernel = lambda: dsra.dsra_level(*ts, out, True, emit)

        def chain():
            size = tuple(ts[2].shape[-2:])
            gated = dsra.dsra_gate(ts[2], resize_bilinear(ts[0], size),
                                   resize_bilinear(ts[1], size), True)
            full = (gated, ts[3], ts[0], ts[1]) if emit else (gated, ts[3])
            return [resize_bilinear(t, out) for t in full]

        row = {"prev": prev, "branch": ra, "emit_prev": emit, "channels": c,
               "dtype": name, "main_path": main, "calls_per_forward": 1,
               "max_abs_err": err, "excess": over, "ms": time_ms(kernel),
               "device_ms": kernel_ms(torch, kernel),
               "host_ms": host_ms(torch, kernel),
               "plain_ms": time_ms(lambda: dsra.dsra_level_plain(
                   *ts, out, True, emit)),
               "bound_ms": b, "bound_by": by,
               "library_chain_ms": time_ms(chain),
               "library_chain_device_ms": kernel_ms(torch, chain),
               "library_chain_host_ms": host_ms(torch, chain)}
        if main:
            row["launches_by_kernel"] = _one_launch(
                torch, kernel, "dsra_level", f"dsra_level {prev} -> {ra}")
        print(f"dsra_level {prev} -> {ra} C {c} {name}: ms {row['ms']:.4f}, "
              f"device {row['device_ms']:.4f}, host {row['host_ms']:.4f}, "
              f"chain {row['library_chain_ms']:.4f} (device "
              f"{row['library_chain_device_ms']:.4f}, host "
              f"{row['library_chain_host_ms']:.4f}), bound {b:.5f}, "
              f"excess {over:.3f}")
        rows.append(row)
    level = _summary("dsra_level", "pranet2_tpu_torch/csrc/dsra.cu",
                     "pranet2_tpu/ops/dsra.py:71", rows)
    level["host_ms"] = sum(r["host_ms"] for r in rows if r["main_path"])
    level["library_chain_host_ms"] = sum(r["library_chain_host_ms"]
                                         for r in rows if r["main_path"])
    return [level, _check_gate_alone(torch, dev, g)]


def _rate_size_of(rate: float) -> int:
    """The recipe's image side at scale ``rate``."""
    from pranet2_tpu_torch.train.binary import _rate_size

    return _rate_size(TRAIN_SIZE, rate)


def _train_sides() -> list:
    """The gate's map sides in the train step: the three decoder levels
    (S/32, S/16, S/8) at each scale's size S."""
    return [_rate_size_of(r) // d for r in TRAIN_RATES for d in (32, 16, 8)]


def _check_gate_alone(torch, dev, g) -> dict:
    """``dsra_gate``, the forward of the gate's autograd Function and so
    the training path's kernel: at the train step's shapes (batch 8, one
    channel, the three levels at each scale) in float32, the recipe's type
    (its times are one batch's worth: nine calls), and in bf16; in float64
    at the 0.75 scale's shapes (the card-vs-CPU step's); then at the
    serving levels' shapes (bf16, batch 16) and four channels; then at the
    multiclass decoders' gates at 224^2, 9 classes: EMCAD's at 14, 28 and
    56 px, MIST's at 16, 32 and 64 (its encoder at 256), MERIT's at both
    (a pass at 256, then one at 224), in bf16 at batch 16 (the served
    forward's, totalled as ``emcad_forward``, ``merit_forward`` and
    ``mist_forward``) and float32 at batch 6 (the train step's,
    ``*_train_step``), and in float32 and float64 at EMCAD's.  Each against
    ``dsra_gate_plain``: float32 and bf16 within ``GATE_TOL`` elementwise,
    float64 within ``F64_GATE_TOL`` of max |out|."""
    from pranet2_tpu_torch.ops import dsra

    sides = _train_sides()
    cases = [((TRAIN_BATCH, 1, s, s), dt, dt == torch.float32)
             for dt in (torch.float32, torch.bfloat16) for s in sides]
    cases += [((TRAIN_BATCH, 1, s, s), torch.float64, False)
              for s in sides[:3]]
    cases += [((BATCH, 1, s, s), torch.bfloat16, False) for s in (44, 22, 11)]
    cases += [((BATCH, 4, 44, 44), dt, False)
              for dt in (torch.float32, torch.bfloat16)]
    # the multiclass decoders' gates, nine classes: the bf16 serving forward
    # (batch 16) and the float32 train step (batch 6) of each model whose
    # decoder gates at those sides; float32 and float64 at EMCAD's
    paths = {EMCAD_GATE_SIDES: ("emcad", "merit"),
             MAXVIT_GATE_SIDES: ("merit", "mist")}
    multiclass = [((n, EMCAD_CLASSES, s, s), dt, tuple(
        f"{m}_{what}" for m in models))
        for sides, models in paths.items()
        for n, dt, what in ((BATCH, torch.bfloat16, "forward"),
                            (EMCAD_TRAIN_BATCH, torch.float32, "train_step"))
        for s in sides]
    multiclass += [((n, EMCAD_CLASSES, s, s), dt, ())
                   for n, dt in ((BATCH, torch.float32),
                                 (BATCH, torch.float64),
                                 (EMCAD_TRAIN_BATCH, torch.float64))
                   for s in EMCAD_GATE_SIDES]
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "device_ms": 0.0,
             "host_ms": 0.0}
    path_totals = {}
    shapes, worst, by = [], 0.0, "bytes"
    for shape, dt, main_path in cases + multiclass:
        fg, cf, cb = (torch.randn(shape, generator=g, device=dev).to(dt)
                      for _ in range(3))
        got = dsra.dsra_gate(fg, cf, cb, True)
        want = dsra.dsra_gate_plain(fg, cf, cb, True)
        torch.cuda.synchronize()
        name = str(dt).removeprefix("torch.")
        err = (got.double() - want.double()).abs()
        if dt == torch.float64:
            ok = err.max() <= F64_GATE_TOL * want.abs().max()
        else:
            tol = GATE_TOL[name]
            ok = (err <= tol + tol * want.double().abs()).all()
        if not bool(ok):
            raise AssertionError(f"gate kernel differs from its plain version "
                                 f"at {shape} {name}: max {err.max().item()}")
        # per element: the difference, max, exp, sum and divide of the
        # softmax twice over, then fg * gate + fg
        b, by_ = bound_ms(4 * fg.numel() * fg.element_size(),
                          10 * fg.numel())
        kernel = lambda: dsra.dsra_gate(fg, cf, cb, True)
        row = {"shape": list(shape), "dtype": name,
               "main_path": main_path is True,
               "paths": list(main_path) if isinstance(main_path, tuple)
               else [], "bound_by": by_, "max_abs_err": err.max().item(),
               "ms": time_ms(kernel), "device_ms": kernel_ms(torch, kernel),
               "host_ms": host_ms(torch, kernel),
               "plain_ms": time_ms(
                   lambda: dsra.dsra_gate_plain(fg, cf, cb, True)),
               "bound_ms": b}
        shapes.append(row)
        worst = max(worst, row["max_abs_err"])
        if main_path is True:
            by = by_
            for k in total:
                total[k] += row[k]
        for label in row["paths"]:
            sums = path_totals.setdefault(label, dict.fromkeys(total, 0.0))
            for k in total:
                sums[k] += row[k]
            sums["calls"] = sums.get("calls", 0) + 1
            sums["bound_by"] = by_
    for label, sums in path_totals.items():
        print(f"dsra_gate, {label} ({sums['calls']} gates): ms "
              f"{sums['ms']:.4f}, device {sums['device_ms']:.4f}, plain "
              f"{sums['plain_ms']:.4f}, bound {sums['bound_ms']:.5f}")
    print(f"dsra_gate, a train batch's nine float32 calls: ms "
          f"{total['ms']:.4f}, device {total['device_ms']:.4f}, host "
          f"{total['host_ms']:.4f}, bound {total['bound_ms']:.5f}")
    return {"name": "dsra_gate", "route": "cuda",
            "source": "pranet2_tpu_torch/csrc/dsra.cu",
            "replaces": "pranet2_tpu/ops/dsra.py:71",
            "max_abs_err": worst, **total, "bound_by": by,
            "library_ms": None, **path_totals, "shapes": shapes}


def _pvt_params(torch, g, dev, dt, shapes):
    """Seeded random tensors: LayerNorm parameters (1-D, suffix ``_ln``)
    float32, the rest in ``dt``; weights scaled by 1/sqrt(fan in)."""
    out = {}
    for name, shape in shapes.items():
        t = torch.randn(shape, generator=g, device=dev)
        if name.endswith("_ln"):
            t = 1.0 + 0.1 * t if name.startswith("w") else 0.1 * t
            out[name] = t
        else:
            scale = shape[1] ** -0.5 if len(shape) == 2 else (
                1 / 3 if len(shape) == 4 else 0.1)
            out[name] = (t * scale).to(dt)
    return out


def _held(got, want, tol, what, base=None):
    """Max |got - want| and ``testing.excess``, which holds ``got`` to
    ``want`` within ``tol`` of the kernel's part, ``want - base``; raises
    where it is over 1."""
    from pranet2_tpu_torch.testing import excess

    over = excess(got, want, base, tol)
    if not over <= 1:
        raise AssertionError(f"{what}: {over:.3g} times the tolerance")
    return (got.float() - want.float()).abs().max().item(), over


def _summary(name, source, replaces, rows):
    """One kernel entry whose times are one forward's worth: each main-path
    row times the calls a forward makes at its shape."""
    main = [r for r in rows if r["main_path"]]
    total = {k: sum(r[k] * r["calls_per_forward"] for r in main)
             for k in ("ms", "plain_ms", "bound_ms", "library_chain_ms",
                       "device_ms", "library_chain_device_ms")
             if all(k in r for r in main)}
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "excess": max(r["excess"] for r in rows), **total,
            "bound_by": max(main, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": None, "shapes": rows}


def _forward_sum(rows, flag: str) -> dict:
    """One forward's worth of the rows marked ``flag``: each row's times
    by the calls a forward makes at its shape."""
    sel = [r for r in rows if r.get(flag)]
    out = {k: sum(r[k] * r["calls_per_forward"] for r in sel)
           for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                     "library_chain_ms", "library_chain_device_ms")}
    out["calls"] = sum(r["calls_per_forward"] for r in sel)
    out["bound_by"] = max(sel, key=lambda r: r["bound_ms"])["bound_by"]
    out["max_abs_err"] = max(r["max_abs_err"] for r in sel)
    return out


def check_pvt_mlp(torch, dev) -> dict:
    """``mlp_block`` at the four PVTv2-b2 stage shapes (bf16, stats and
    final_ln modes, plain mode at stages 1 and 3) and one float32 case,
    against ``mlp_block_plain``.  Every bf16 call must be one launch of the
    on-chip kernel (``launch_profile``), whose tile and grid each row
    reports; kernel and library chain are also timed by device time.

    The main-path times are one forward's worth of the default PVT path:
    each stage's stats-mode call times its non-last blocks plus its
    final_ln call (12 + 4); the plain rows are the ``attn_impl="v2"``
    path's.  The stats and final_ln rows at the 224^2 stages (EMCAD-B2's
    forward) are totalled apart, as ``emcad_forward``."""
    import torch.nn.functional as F

    from pranet2_tpu_torch.ops import pvt_mlp

    g = torch.Generator(device=dev).manual_seed(2)
    cases = [(PVT_STAGES, si, dt, mode) for si in range(4)
             for dt in (torch.bfloat16,) for mode in ("stats", "final_ln")]
    cases += [(PVT_STAGES, 0, torch.bfloat16, "plain"),
              (PVT_STAGES, 2, torch.bfloat16, "plain"),
              (PVT_STAGES, 1, torch.float32, "stats")]
    cases += [(EMCAD_STAGES, si, torch.bfloat16, mode) for si in range(4)
              for mode in ("stats", "final_ln")]
    rows = []
    for stages, si, dt, mode in cases:
        side, d, _, ratio, _, depth = stages[si]
        c = d * ratio
        p = _pvt_params(torch, g, dev, dt, {
            "w_ln": (d,), "b_ln": (d,), "w1": (c, d), "b1": (c,),
            "dw": (c, 1, 3, 3), "dwb": (c,), "w2": (d, c), "b2": (d,),
            "wf_ln": (d,), "bf_ln": (d,)})
        x = torch.randn((BATCH, side, side, d), generator=g,
                        device=dev).to(dt)
        args = (x, p["w_ln"], p["b_ln"], p["w1"], p["b1"], p["dw"], p["dwb"],
                p["w2"], p["b2"], 1e-6)
        kw = {"plain": {}, "stats": {"stats_eps": 1e-6},
              "final_ln": {"final_ln": (p["wf_ln"], p["bf_ln"])}}[mode]
        got = pvt_mlp.mlp_block(*args, **kw)
        want = pvt_mlp.mlp_block_plain(*args, **kw)
        torch.cuda.synchronize()
        name = str(dt).removeprefix("torch.")
        what = f"mlp_block {mode} at {tuple(x.shape)} C {c} {name}"
        if mode == "stats":
            mu, rstd = pvt_mlp.ln_stats(got[0].float(), 1e-6)
            _held(got[1], mu, STATS_TOL, what + " mu")
            _held(got[2], rstd, STATS_TOL, what + " rstd")
            got, want = got[0], want[0]
        # the block without its MLP: fc2 zeroed leaves x, or LN(x)
        base = pvt_mlp.mlp_block_plain(*args[:7], torch.zeros_like(args[7]),
                                       torch.zeros_like(args[8]), 1e-6, **kw)
        base = base[0] if mode == "stats" else base
        err, over = _held(got, want, PVT_TOL[name], what, base)
        m = x.numel() // d
        # per token, outside the products: LN 7D, fc1 bias C, 9 taps 18C,
        # dw bias C, GELU 17C, fc2 bias and residual 2D, the epilogue's
        # statistics or LayerNorm 7D
        b, by = bound_ms(nbytes(x, *p.values()) + nbytes(got)
                         + (8 * m if mode == "stats" else 0),
                         m * (16 * d + 37 * c), 4 * m * d * c,
                         BF16_MMA_PER_S if dt == torch.bfloat16
                         else F32_OPS_PER_S)
        ln = (p["w_ln"].to(dt), p["b_ln"].to(dt))
        w1, b1, dw, dwb, w2, b2 = (p[k] for k in ("w1", "b1", "dw", "dwb",
                                                   "w2", "b2"))

        def chain():
            y = F.linear(F.layer_norm(x, (d,), *ln, 1e-6), w1, b1)
            y = F.conv2d(y.permute(0, 3, 1, 2), dw, dwb, padding=1, groups=c)
            return x + F.linear(F.gelu(y.permute(0, 2, 3, 1)), w2, b2)

        calls = depth - 1 if mode != "final_ln" else 1
        kernel = lambda: pvt_mlp.mlp_block(*args, **kw)
        emcad = stages is EMCAD_STAGES
        row = {"shape": list(x.shape), "hidden": c, "dtype": name,
               "mode": mode, "emcad_path": emcad,
               "main_path": (dt == torch.bfloat16 and mode != "plain"
                             and not emcad),
               "calls_per_forward": calls, "max_abs_err": err,
               "excess": over, "ms": time_ms(kernel),
               "device_ms": kernel_ms(torch, kernel),
               "plain_ms": time_ms(lambda: pvt_mlp.mlp_block_plain(*args,
                                                                   **kw),
                                   reps=3, rounds=3),
               "bound_ms": b, "bound_by": by,
               "library_chain_ms": time_ms(chain),
               "library_chain_device_ms": kernel_ms(torch, chain)}
        if dt == torch.bfloat16:
            row["launches_by_kernel"] = _one_launch(
                torch, kernel, "mlp", f"mlp_block {mode} stage {si + 1}")
            row["mlp_rows_chunk_splits"] = list(pvt_mlp.mlp_tile(
                *x.shape, c, dt))
            print(f"mlp_block {side} px stage {si + 1} {mode}: rows, "
                  f"chunk, splits "
                  f"{row['mlp_rows_chunk_splits']}, "
                  f"{row['launches_by_kernel']}")
        rows.append(row)
    out = _summary("mlp_block", "pranet2_tpu_torch/csrc/pvt_mlp.cu",
                   "pranet2_tpu/ops/pvt_mlp.py:112", rows)
    out["sources"] = [out["source"], "pranet2_tpu_torch/csrc/mlp_fused.cuh"]
    out["launch_ms"] = _launch_ms(rows)
    out["emcad_forward"] = _forward_sum(rows, "emcad_path")
    return out


def _one_launch(torch, fn, label, what, calls: int = 5) -> dict:
    """``launch_profile`` of ``fn``, which must launch ``label``'s kernel
    once a call and no other kernel."""
    key = next(k for k, v in LAUNCH_LABELS.items() if v == label)
    # a session that lost some of its events is traced again, up to
    # TRACE_TRIES times, while the count is short
    for _ in range(TRACE_TRIES):
        prof, names = _profile(torch, fn, (label,), calls)
        if any(key not in n for n in names):
            raise AssertionError(f"{what}: launches {names}; expected "
                                 f"{label} alone")
        if abs(prof[label]["per_call"] - 1) < 1e-9:
            break
        TRACES["short"] += 1
    else:
        raise AssertionError(f"{what}: {prof[label]['per_call']} launches "
                             f"of {label} a call; expected one")
    return prof


def check_sra_attention(torch, dev) -> dict:
    """``sra_attention`` at the four PVTv2-b2 stage shapes (bf16, Tkv 121)
    and one float32 case, against ``sra_attention_plain``.  The main-path
    times are one forward's worth (3 + 4 + 6 + 3 calls).  The 224^2 stages
    (Tkv 49 at each; EMCAD-B2's forward) are totalled apart, as
    ``emcad_forward``."""
    import torch.nn.functional as F

    from pranet2_tpu_torch.ops import pvt_attn

    g = torch.Generator(device=dev).manual_seed(3)
    cases = [(PVT_STAGES, si, torch.bfloat16) for si in range(4)]
    cases.append((PVT_STAGES, 2, torch.float32))
    cases += [(EMCAD_STAGES, si, torch.bfloat16) for si in range(4)]
    rows = []
    for stages, si, dt in cases:
        side, d, nh, _, sr, depth = stages[si]
        tkv = (side // sr) ** 2
        p = _pvt_params(torch, g, dev, dt, {
            "w_ln": (d,), "b_ln": (d,), "wq": (d, d), "bq": (d,),
            "wp": (d, d), "bp": (d,)})
        x = torch.randn((BATCH, side, side, d), generator=g,
                        device=dev).to(dt)
        kv = torch.randn((BATCH, tkv, 2 * d), generator=g, device=dev).to(dt)
        args = (x, p["w_ln"], p["b_ln"], p["wq"], p["bq"], kv, p["wp"],
                p["bp"], nh, 1e-6)
        got = pvt_attn.sra_attention(*args)
        want = pvt_attn.sra_attention_plain(*args)
        torch.cuda.synchronize()
        name = str(dt).removeprefix("torch.")
        err, over = _held(got, want, PVT_TOL[name],
                          f"sra_attention at {tuple(x.shape)} nh {nh} Tkv {tkv} "
                          f"{name}", base=x)
        m = x.numel() // d
        # per token, outside the products: LN 7D, q bias and scale 2D,
        # softmax max/subtract/exp/sum 4 Tkv per head, the division D,
        # proj bias and residual 2D
        b, by = bound_ms(nbytes(x, kv, *p.values()) + nbytes(got),
                         m * (12 * d + 4 * nh * tkv),
                         4 * m * d * d + 4 * m * tkv * d,
                         BF16_MMA_PER_S if dt == torch.bfloat16
                         else F32_OPS_PER_S)
        ln = (p["w_ln"].to(dt), p["b_ln"].to(dt))
        hd = d // nh
        heads = lambda t: t.reshape(BATCH, -1, nh, hd).transpose(1, 2)
        k, v = (heads(t) for t in kv.split(d, dim=-1))

        def chain():
            y = F.layer_norm(x, (d,), *ln, 1e-6).reshape(BATCH, -1, d)
            q = heads(F.linear(y, p["wq"], p["bq"]))
            o = F.scaled_dot_product_attention(q, k, v)
            o = o.transpose(1, 2).reshape(x.shape)
            return x + F.linear(o, p["wp"], p["bp"])

        kernel = lambda: pvt_attn.sra_attention(*args)
        emcad = stages is EMCAD_STAGES
        row = {"shape": list(x.shape), "heads": nh, "tkv": tkv,
               "dtype": name, "emcad_path": emcad,
               "main_path": dt == torch.bfloat16 and not emcad,
               "calls_per_forward": depth,
               "max_abs_err": err, "excess": over,
               "ms": time_ms(kernel),
               "device_ms": kernel_ms(torch, kernel),
               "plain_ms": time_ms(
                   lambda: pvt_attn.sra_attention_plain(*args), reps=3,
                   rounds=3),
               "bound_ms": b, "bound_by": by,
               "library_chain_ms": time_ms(chain),
               "library_chain_device_ms": kernel_ms(torch, chain),
               "launches_by_kernel": _one_launch(
                   torch, kernel, "attention",
                   f"sra_attention stage {si + 1} {name}")}
        # grid (query tiles, cluster size, images)
        grid = row["launches_by_kernel"]["attention"]["grids"]
        print(f"sra_attention {side} px stage {si + 1} {name}: grid "
              f"{grid}, ms "
              f"{row['ms']:.4f}, device {row['device_ms']:.4f}, chain "
              f"{row['library_chain_ms']:.4f}, device "
              f"{row['library_chain_device_ms']:.4f}")
        rows.append(row)
    out = _summary("sra_attention", "pranet2_tpu_torch/csrc/pvt_attn.cu",
                   "pranet2_tpu/ops/pvt_attn.py:43", rows)
    out["sources"] = [out["source"], "pranet2_tpu_torch/csrc/sra_attend.cuh"]
    out["launch_ms"] = _launch_ms(rows)
    out["emcad_forward"] = _forward_sum(rows, "emcad_path")
    return out


def _sra_block_case(torch, g, dev, dt, si):
    """x and ``sra_block``'s parameters at PVTv2-b2 stage ``si``, and the
    (d, heads, sr, depth, Tkv) of that stage."""
    side, d, nh, _, sr, depth = PVT_STAGES[si]
    p = _pvt_params(torch, g, dev, dt, {
        "w_ln": (d,), "b_ln": (d,), "wq": (d, d), "bq": (d,),
        "srb": (d,), "wk_ln": (d,), "bk_ln": (d,), "wkv": (2 * d, d),
        "bkv": (2 * d,), "wp": (d, d), "bp": (d,)})
    kv_path = (None,) * 4
    if sr > 1:
        srw = (torch.randn((d, d, sr, sr), generator=g, device=dev)
               * (sr * sr * d) ** -0.5).to(dt)
        kv_path = (srw, p["srb"], p["wk_ln"], p["bk_ln"])
    x = torch.randn((BATCH, side, side, d), generator=g, device=dev).to(dt)
    args = (x, p["w_ln"], p["b_ln"], p["wq"], p["bq"], *kv_path, p["wkv"],
            p["bkv"], p["wp"], p["bp"])
    return args, (d, nh, sr, depth, (side // sr) ** 2)


def _sra_block_work(m, d, nh, sr, tkv):
    """(operations outside the products, product operations) of a whole
    attention half over m tokens of BATCH images: per token LN 7D, q bias
    and scale 2D, softmax 4 Tkv per head, the division D, proj bias and
    residual 2D; per K/V token the sr bias and kv LN 8D (sr > 1), kv bias
    2D; products q, proj, scores, PV, the patch product and kv."""
    kv_tokens = BATCH * tkv
    ops = m * (12 * d + 4 * nh * tkv) + kv_tokens * (
        (10 if sr > 1 else 2) * d)
    mma = (4 * m * d * d + 4 * m * tkv * d
           + 2 * kv_tokens * d * (sr * sr * d if sr > 1 else 0)
           + 4 * kv_tokens * d * d)
    return ops, mma


def _sra_chain(torch, args, nh, sr):
    """The eager chain of PyTorch calls for a whole attention half: LN,
    the sr convolution, its LN, the kv Linear, q, SDPA, proj, residual."""
    import torch.nn.functional as F

    x, lw, lb, wq, bq, srw, srb, kw, kb, wkv, bkv, wp, bp = args
    dt, d = x.dtype, x.shape[-1]
    hd = d // nh
    heads = lambda t: t.reshape(BATCH, -1, nh, hd).transpose(1, 2)

    def chain():
        y = F.layer_norm(x, (d,), lw.to(dt), lb.to(dt), 1e-6)
        t = y
        if sr > 1:
            t = F.conv2d(y.permute(0, 3, 1, 2), srw, srb, stride=sr)
            t = F.layer_norm(t.permute(0, 2, 3, 1), (d,), kw.to(dt),
                             kb.to(dt), 1e-5)
        k, v = F.linear(t.reshape(BATCH, -1, d), wkv, bkv).split(d, -1)
        q = heads(F.linear(y.reshape(BATCH, -1, d), wq, bq))
        o = F.scaled_dot_product_attention(q, heads(k), heads(v))
        return x + F.linear(o.transpose(1, 2).reshape(x.shape), wp, bp)

    return chain


def check_sra_block(torch, dev) -> dict:
    """``sra_block`` at the four PVTv2-b2 stage shapes (bf16, Tkv 121) and
    one float32 case, against ``sra_block_plain``.  The main-path times are
    one forward's worth (3 + 4 + 6 + 3 calls)."""
    from pranet2_tpu_torch.ops import pvt_attn

    g = torch.Generator(device=dev).manual_seed(6)
    cases = [(si, torch.bfloat16) for si in range(4)]
    cases.append((2, torch.float32))
    rows = []
    for si, dt in cases:
        args, (d, nh, sr, depth, tkv) = _sra_block_case(torch, g, dev, dt,
                                                        si)
        x = args[0]
        got = pvt_attn.sra_block(*args, nh, sr)
        want = pvt_attn.sra_block_plain(*args, nh, sr)
        torch.cuda.synchronize()
        name = str(dt).removeprefix("torch.")
        err, over = _held(got, want, PVT_TOL[name],
                          f"sra_block at {tuple(x.shape)} nh {nh} sr {sr} "
                          f"{name}", base=x)
        ops, mma = _sra_block_work(x.numel() // d, d, nh, sr, tkv)
        b, by = bound_ms(nbytes(*args) + nbytes(got), ops, mma,
                         BF16_MMA_PER_S if dt == torch.bfloat16
                         else F32_OPS_PER_S)
        launches = launch_profile(
            torch, lambda: pvt_attn.sra_block(*args, nh, sr),
            ("kv_patch", "kv_finish", "attention") if sr > 1
            else ("kv_finish", "attention"))
        rows.append({"shape": list(x.shape), "heads": nh, "sr": sr,
                     "launches_by_kernel": launches,
                     "tkv": tkv, "dtype": name,
                     "main_path": dt == torch.bfloat16,
                     "calls_per_forward": depth, "max_abs_err": err,
                     "excess": over,
                     "ms": time_ms(
                         lambda: pvt_attn.sra_block(*args, nh, sr)),
                     "plain_ms": time_ms(
                         lambda: pvt_attn.sra_block_plain(*args, nh, sr),
                         reps=3, rounds=3),
                     "bound_ms": b, "bound_by": by,
                     "library_chain_ms": time_ms(
                         _sra_chain(torch, args, nh, sr))})
    out = _summary("sra_block", "pranet2_tpu_torch/csrc/pvt_kv.cu",
                   "pranet2_tpu/ops/pvt_attn.py:221", rows)
    # the K/V launches, then row 6's attention kernel with its residual
    # rounded once
    out["sources"] = [out["source"], "pranet2_tpu_torch/csrc/pvt_attn.cu"]
    out["launch_ms"] = _launch_ms(rows)
    return out


def _stem_pool_at(torch, g, shape) -> dict:
    """``stem_pool`` at ``shape`` (bf16) bit for bit against its plain
    version, timed beside its bound, plain version and ATen chain (one call
    a forward)."""
    import torch.nn.functional as F

    from pranet2_tpu_torch.ops import stem

    dev = g.device
    z = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    c = shape[1]
    w, b, mean = (torch.randn(c, generator=g, device=dev) * sc + sh
                  for sc, sh in ((0.1, 1.0), (0.1, 0.0), (0.1, 0.0)))
    bn = (w, b, mean, 0.5 + torch.rand(c, generator=g, device=dev))
    got = stem.stem_pool(z, *bn, 1e-5)
    want = stem.stem_pool_plain(z, *bn, 1e-5)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"stem_pool at {shape} differs from its plain "
                             f"version")
    b_stem, by = bound_ms(nbytes(z, got, *bn),
                          3 * z.numel() + 8 * got.numel())
    kernel = lambda: stem.stem_pool(z, *bn, 1e-5)
    chain = lambda: F.max_pool2d(torch.relu(F.batch_norm(
        z, bn[2], bn[3], bn[0], bn[1], False, 0.0, 1e-5)), 3, 2, 1)
    out = {"shape": list(shape), "max_abs_err": 0.0, "ms": time_ms(kernel),
           "device_ms": kernel_ms(torch, kernel),
           "plain_ms": time_ms(lambda: stem.stem_pool_plain(z, *bn, 1e-5)),
           "bound_ms": b_stem, "bound_by": by,
           "library_chain_ms": time_ms(chain),
           "library_chain_device_ms": kernel_ms(torch, chain)}
    print(f"stem_pool at {shape}: ms {out['ms']:.4f}, device "
          f"{out['device_ms']:.4f}, chain {out['library_chain_ms']:.4f} "
          f"(device {out['library_chain_device_ms']:.4f}), bound "
          f"{b_stem:.5f}")
    return out


def _launch_ms(rows) -> dict:
    """Device ms a forward of each labelled launch over the main-path
    rows (each row's calls a forward)."""
    total = {}
    for r in rows:
        if r["main_path"]:
            for label, v in r["launches_by_kernel"].items():
                total[label] = (total.get(label, 0.0)
                                + v["ms"] * r["calls_per_forward"])
    return total


def check_pvt_block(torch, dev) -> dict:
    """``pvt_block`` at the four PVTv2-b2 stage shapes (bf16) and one
    float32 case, against ``pvt_block_plain``.  The main-path times are one
    forward's worth (3 + 4 + 6 + 3 calls)."""
    import torch.nn.functional as F

    from pranet2_tpu_torch.ops.pvt_block import pvt_block, pvt_block_plain
    from pranet2_tpu_torch.ops.pvt_mlp import mlp_tile

    g = torch.Generator(device=dev).manual_seed(7)
    cases = [(si, torch.bfloat16) for si in range(4)]
    cases.append((2, torch.float32))
    rows = []
    for si, dt in cases:
        args, (d, nh, sr, depth, tkv) = _sra_block_case(torch, g, dev, dt,
                                                        si)
        c = d * PVT_STAGES[si][3]
        p = _pvt_params(torch, g, dev, dt, {
            "w_ln": (d,), "b_ln": (d,), "w1": (c, d), "b1": (c,),
            "dw": (c, 1, 3, 3), "dwb": (c,), "w2": (d, c), "b2": (d,)})
        mlp = (p["w_ln"], p["b_ln"], p["w1"], p["b1"], p["dw"], p["dwb"],
               p["w2"], p["b2"])
        x = args[0]
        got = pvt_block(*args, *mlp, nh, sr)
        want = pvt_block_plain(*args, *mlp, nh, sr)
        torch.cuda.synchronize()
        name = str(dt).removeprefix("torch.")
        err, over = _held(got, want, PVT_TOL[name],
                          f"pvt_block at {tuple(x.shape)} nh {nh} sr {sr} C "
                          f"{c} {name}", base=x)
        m = x.numel() // d
        ops, mma = _sra_block_work(m, d, nh, sr, tkv)
        # the MLP half per token, outside the products: LN 7D, fc1 bias C,
        # 9 taps 18C, dw bias C, GELU 17C, fc2 bias and residual 2D
        b, by = bound_ms(nbytes(*args, *mlp) + nbytes(got),
                         ops + m * (9 * d + 37 * c), mma + 4 * m * d * c,
                         BF16_MMA_PER_S if dt == torch.bfloat16
                         else F32_OPS_PER_S)
        attn = _sra_chain(torch, args, nh, sr)
        ln2 = (mlp[0].to(dt), mlp[1].to(dt))
        filled = ("kv_patch", "kv_finish", "mlp") if sr > 1 else (
            "kv_finish", "mlp")
        launches = launch_profile(
            torch, lambda: pvt_block(*args, *mlp, nh, sr),
            (*filled, "attention"))
        grids = {k: v["grids"] for k, v in launches.items()}
        tile = mlp_tile(*x.shape, c, dt)
        print(f"pvt_block stage {si + 1} {name}: MLP rows, chunk, splits "
              f"{tile}, grids {grids}, device ms "
              f"{ {k: v['ms'] for k, v in launches.items()} }")
        # at the serving shapes, in every traced call, the K/V launches
        # must give every SM a block and the MLP launch half of them (its
        # pick splits no further: mlp_fused.cuh::pick)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        least = {k: sms if k.startswith("kv") else -(-sms // 2)
                 for k in filled}
        if dt == torch.bfloat16 and any(_blocks(gr) < least[k]
                                        for k in filled for gr in grids[k]):
            raise AssertionError(f"pvt_block stage {si + 1}: a K/V launch "
                                 f"below {sms} blocks or an MLP launch "
                                 f"below half that: {grids}")

        def chain():
            h = attn()
            y = F.linear(F.layer_norm(h, (d,), *ln2, 1e-6), mlp[2], mlp[3])
            y = F.conv2d(y.permute(0, 3, 1, 2), mlp[4], mlp[5], padding=1,
                         groups=c)
            return h + F.linear(F.gelu(y.permute(0, 2, 3, 1)), mlp[6],
                                mlp[7])

        rows.append({"shape": list(x.shape), "heads": nh, "sr": sr,
                     "hidden": c, "dtype": name,
                     "mlp_rows_chunk_splits": list(tile),
                     "launches_by_kernel": launches,
                     "main_path": dt == torch.bfloat16,
                     "calls_per_forward": depth, "max_abs_err": err,
                     "excess": over,
                     "ms": time_ms(lambda: pvt_block(*args, *mlp, nh, sr)),
                     "plain_ms": time_ms(
                         lambda: pvt_block_plain(*args, *mlp, nh, sr),
                         reps=3, rounds=3),
                     "bound_ms": b, "bound_by": by,
                     "library_chain_ms": time_ms(chain)})
    out = _summary("pvt_block", "pranet2_tpu_torch/csrc/pvt_block.cu",
                   "pranet2_tpu/ops/pvt_block.py:105", rows)
    out["launch_ms"] = _launch_ms(rows)
    return out


def check_dwconv(torch, dev) -> dict:
    """``depthwise_conv3x3`` at PVTv2-b2's four hidden shapes, float32 and
    bf16, against ``depthwise_conv3x3_plain``; the library call is one
    grouped ``F.conv2d`` (TF32 off).  No model calls it, so the entry's
    times are the four bf16 shapes' sum, one call each.  ``ms`` and
    ``library_ms`` are CUDA events around back-to-back calls (``time_ms``),
    as every row is timed; at the small maps they time the host's cost of a
    call, so each shape also carries its device time (``kernel_ms``) and
    the host's wall time a call (``host_ms``)."""
    import torch.nn.functional as F

    from pranet2_tpu_torch.ops import dwconv

    g = torch.Generator(device=dev).manual_seed(8)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        for side, d, _, ratio, _, _ in PVT_STAGES:
            c = d * ratio
            x = torch.randn((BATCH, side, side, c), generator=g,
                            device=dev).to(dt)
            w = (torch.randn((3, 3, c), generator=g, device=dev) / 3).to(dt)
            got = dwconv.depthwise_conv3x3(x, w)
            want = dwconv.depthwise_conv3x3_plain(x, w)
            torch.cuda.synchronize()
            name = str(dt).removeprefix("torch.")
            err, over = _held(
                got, want, DW_TOL[name],
                f"depthwise_conv3x3 at {tuple(x.shape)} {name}")
            # per output: nine products and nine sums
            b, by = bound_ms(nbytes(x, w, got), 18 * got.numel())
            xc = x.permute(0, 3, 1, 2)
            wc = w.permute(2, 0, 1)[:, None].contiguous()
            kernel = lambda: dwconv.depthwise_conv3x3(x, w)
            library = lambda: F.conv2d(xc, wc, padding=1, groups=c)
            rows.append({"shape": list(x.shape), "dtype": name,
                         "max_abs_err": err, "excess": over,
                         "ms": time_ms(kernel),
                         "device_ms": kernel_ms(torch, kernel),
                         "host_ms": host_ms(torch, kernel),
                         "plain_ms": time_ms(
                             lambda: dwconv.depthwise_conv3x3_plain(x, w),
                             reps=3, rounds=3),
                         "bound_ms": b, "bound_by": by,
                         "library_ms": time_ms(library),
                         "library_device_ms": kernel_ms(torch, library),
                         "library_host_ms": host_ms(torch, library)})
    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
    return {"name": "depthwise_conv3x3", "route": "cuda",
            "source": "pranet2_tpu_torch/csrc/dwconv.cu",
            "replaces": "pranet2_tpu/ops/dwconv.py:60",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "excess": max(r["excess"] for r in rows),
            **{k: sum(r[k] for r in bf16)
               for k in ("ms", "device_ms", "host_ms", "plain_ms",
                         "bound_ms", "library_ms", "library_device_ms",
                         "library_host_ms")},
            "bound_by": "bytes", "shapes": rows}


def _res2_cases(torch):
    return [(li, dt) for dt in (torch.bfloat16, torch.float32)
            for li in range(len(RES2_LAYERS))]


def check_res2_tail(torch, dev) -> dict:
    """``fused_tail`` at the four stage blocks' tails of Res2Net-50-v1b
    (cc of 4 width channels to 4 planes), bf16 and float32, against
    ``res2_tail_plain``.  The main-path times are one forward's worth (one
    stage block a layer)."""
    import torch.nn.functional as F

    from pranet2_tpu_torch.ops import res2_tail
    from pranet2_tpu_torch.testing import random_bottle2neck

    g = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for li, dt in _res2_cases(torch):
        planes, side, _ = RES2_LAYERS[li]
        block = random_bottle2neck(planes * 2, planes, 10 + li, dev, dt,
                                   stride=2, has_downsample=True,
                                   stype="stage")
        cout, cin = block.conv3.weight.shape[:2]
        w3 = block.conv3.weight.detach().view(cout, cin)
        bn = block.bn3
        s3, t3 = res2_tail.fold_bn(bn.weight.detach(), bn.bias.detach(),
                                   bn.running_mean, bn.running_var)
        cc = torch.relu(torch.randn((BATCH, cin, side, side), generator=g,
                                    device=dev)).to(dt)
        short = torch.randn((BATCH, cout, side, side), generator=g,
                            device=dev).to(dt)
        args = (cc, short, w3, s3, t3)
        got = res2_tail.fused_tail(*args)
        want = res2_tail.res2_tail_plain(*args)
        torch.cuda.synchronize()
        name = str(dt).removeprefix("torch.")
        err, over = _held(got, want, RES2_TOL[name],
                          f"fused_tail at {tuple(cc.shape)} -> {cout} {name}",
                          base=short)
        m = BATCH * side * side
        # per output: BN scale and shift, the residual, ReLU
        b, by = bound_ms(nbytes(*args) + nbytes(got), 4 * m * cout,
                         2 * m * cin * cout,
                         BF16_MMA_PER_S if dt == torch.bfloat16
                         else F32_OPS_PER_S)
        w4 = w3.view(cout, cin, 1, 1)

        def chain():
            y = F.conv2d(cc, w4) * s3[:, None, None] + t3[:, None, None]
            return torch.relu(y + short).to(dt)

        kernel = lambda: res2_tail.fused_tail(*args)
        row = {"shape": list(cc.shape), "cout": cout, "dtype": name,
               "main_path": dt == torch.bfloat16,
               "calls_per_forward": 1, "max_abs_err": err,
               "excess": over, "ms": time_ms(kernel),
               "device_ms": kernel_ms(torch, kernel),
               "plain_ms": time_ms(
                   lambda: res2_tail.res2_tail_plain(*args), reps=3,
                   rounds=3),
               "bound_ms": b, "bound_by": by,
               "library_chain_ms": time_ms(chain),
               "library_chain_device_ms": kernel_ms(torch, chain)}
        if dt == torch.bfloat16:
            row["launches_by_kernel"] = launch_profile(torch, kernel,
                                                       ("conv1x1",))
            print(f"fused_tail layer {li + 1}: {row['launches_by_kernel']}")
        rows.append(row)
    out = _summary("fused_tail", "pranet2_tpu_torch/csrc/res2_tail.cu",
                   "pranet2_tpu/ops/res2_tail.py:37", rows)
    out["sources"] = [out["source"], "pranet2_tpu_torch/csrc/res2_gemm.cuh"]
    out["launch_ms"] = _launch_ms(rows)
    return out


def check_bottle2neck(torch, dev) -> dict:
    """``fused_bottle2neck`` at the normal blocks of Res2Net-50-v1b, bf16
    and float32, against ``bottle2neck_plain``; the library chain is the
    port's unfused Bottle2neck module in eval.  The main-path times are one
    forward's worth (2 + 3 + 5 + 2 calls)."""
    from pranet2_tpu_torch.ops import res2_block
    from pranet2_tpu_torch.testing import random_bottle2neck

    g = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for li, dt in _res2_cases(torch):
        planes, side, calls = RES2_LAYERS[li]
        c = planes * 4
        block = random_bottle2neck(c, planes, 20 + li, dev, dt)
        width = block.width
        args = tuple(t.detach() for t in block.fused_args())
        x = torch.randn((BATCH, c, side, side), generator=g,
                        device=dev).to(dt)
        got = res2_block.fused_bottle2neck(x, *args)
        want = res2_block.bottle2neck_plain(x, *args)
        torch.cuda.synchronize()
        name = str(dt).removeprefix("torch.")
        err, over = _held(got, want, RES2_TOL[name],
                          f"fused_bottle2neck at {tuple(x.shape)} width "
                          f"{width} {name}", base=x)
        m = BATCH * side * side
        # per pixel, outside the products: BN+ReLU of u (3 x 4w), the two
        # hierarchical adds (2w), BN+ReLU of the sp_i (3 x 3w), the tail's
        # BN, residual and ReLU (4c)
        b, by = bound_ms(nbytes(x, *args) + nbytes(got),
                         m * (12 * width + 2 * width + 9 * width + 4 * c),
                         2 * m * (c * 4 * width + 27 * width * width
                                  + 4 * width * c),
                         BF16_MMA_PER_S if dt == torch.bfloat16
                         else F32_OPS_PER_S)
        def library():
            with torch.inference_mode():
                return block(x)

        kernel = lambda: res2_block.fused_bottle2neck(x, *args)
        row = {"shape": list(x.shape), "width": width, "dtype": name,
               "main_path": dt == torch.bfloat16,
               "calls_per_forward": calls, "max_abs_err": err,
               "excess": over,
               # u and cat written (7 width channels), u, the sp_{i-1}
               # and cat read (9 width channels); bf16 pads each group
               "spill_bytes": 16 * width * m * x.element_size(),
               "ms": time_ms(kernel),
               "device_ms": kernel_ms(torch, kernel),
               "plain_ms": time_ms(
                   lambda: res2_block.bottle2neck_plain(x, *args),
                   reps=3, rounds=3),
               "bound_ms": b, "bound_by": by,
               "library_chain_ms": time_ms(library),
               "library_chain_device_ms": kernel_ms(torch, library)}
        if dt == torch.bfloat16:
            row["conv3x3_rows_cols_splits"] = list(res2_block.conv3x3_tile(
                BATCH, c, width, side, side))
            row["launches_by_kernel"] = launch_profile(
                torch, kernel, ("prep", "conv1x1", "conv3x3"))
            print(f"fused_bottle2neck layer {li + 1}: 3x3 tile "
                  f"{row['conv3x3_rows_cols_splits']}, "
                  f"{row['launches_by_kernel']}")
        rows.append(row)
    out = _summary("fused_bottle2neck",
                   "pranet2_tpu_torch/csrc/res2_block.cu",
                   "pranet2_tpu/ops/res2_block.py:125", rows)
    out["sources"] = [out["source"], "pranet2_tpu_torch/csrc/res2_gemm.cuh"]
    out["launch_ms"] = _launch_ms(rows)
    out["spill_bytes"] = sum(r["spill_bytes"] * r["calls_per_forward"]
                             for r in rows if r["main_path"])
    return out


def synthetic_images(np, n: int) -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (int(rng.integers(288, 577)),
                                  int(rng.integers(288, 577)), 3),
                         dtype=np.uint8) for _ in range(n)]


# served paths: label -> (model, get_model keyword arguments, launches per
# forward by kernel)
_NO_PVT = {"mlp_block": 0, "sra_attention": 0, "sra_block": 0,
           "pvt_block": 0}
_NO_RES2 = {"fused_bottle2neck": 0, "fused_tail": 0}
# no served forward calls the depthwise 3x3 (the JAX package only exports
# it), the standalone gate or the bare maxpool (the chains that run while
# autograd records take those two): every path's decoder runs three
# dsra_level launches, and the Res2Net stem one stem_pool
_TAIL = {"max_pool3x3s2": 0, "dsra_gate": 0, "dsra_level": 3,
         "depthwise_conv3x3": 0}
_PVT = {**_TAIL, "stem_pool": 0, **_NO_RES2}
# PraNet-V1 has no DSRA gate: its reverse attention and resizes are ATen
_V1 = {**_TAIL, "dsra_level": 0}
PATHS = {
    "pranet_v2": ("pranet_v2", {}, {**_TAIL, "stem_pool": 1, **_NO_RES2,
                                    **_NO_PVT}),
    "pranet_v2_fused": ("pranet_v2", {"fused": True, "tailfuse": True},
                        {**_TAIL, "stem_pool": 1, "fused_bottle2neck": 12,
                         "fused_tail": 4, **_NO_PVT}),
    "pvt_pranet_v2": ("pvt_pranet_v2", {}, {**_PVT, **_NO_PVT,
                                            "mlp_block": 16,
                                            "sra_attention": 16}),
    "pvt_pranet_v2_attn_v2": ("pvt_pranet_v2", {"attn_impl": "v2"},
                              {**_PVT, **_NO_PVT, "mlp_block": 16,
                               "sra_block": 16}),
    "pvt_pranet_v2_blockfuse": ("pvt_pranet_v2", {"blockfuse": True},
                                {**_PVT, **_NO_PVT, "pvt_block": 16}),
    "pranet_v1": ("pranet_v1", {}, {**_V1, "stem_pool": 1, **_NO_RES2,
                                    **_NO_PVT}),
    "pvt_pranet_v1": ("pvt_pranet_v1", {}, {**_V1, "stem_pool": 0,
                                            **_NO_RES2, **_NO_PVT,
                                            "mlp_block": 16,
                                            "sra_attention": 16}),
    "pranet_v1_resnet": ("pranet_v1_resnet", {}, {**_V1, "stem_pool": 1,
                                                  **_NO_RES2, **_NO_PVT}),
}
_NO_MLP = {"plain": 0, "stats": 0, "final_ln": 0}
MLP_MODES = {"pranet_v2": _NO_MLP, "pranet_v2_fused": _NO_MLP,
             "pvt_pranet_v2": {"plain": 0, "stats": 12, "final_ln": 4},
             "pvt_pranet_v2_attn_v2": {"plain": 12, "stats": 0,
                                       "final_ln": 4},
             "pvt_pranet_v2_blockfuse": _NO_MLP, "pranet_v1": _NO_MLP,
             "pvt_pranet_v1": {"plain": 0, "stats": 12, "final_ln": 4},
             "pranet_v1_resnet": _NO_MLP}


def _wrappers():
    from pranet2_tpu_torch.ops import (dsra, dwconv, pvt_attn, pvt_mlp,
                                       res2_block, res2_tail, stem)
    from pranet2_tpu_torch.ops.pvt_block import pvt_block

    return {"max_pool3x3s2": stem.max_pool3x3s2, "dsra_gate": dsra.dsra_gate,
            "stem_pool": stem.stem_pool, "dsra_level": dsra.dsra_level,
            "fused_bottle2neck": res2_block.fused_bottle2neck,
            "fused_tail": res2_tail.fused_tail,
            "mlp_block": pvt_mlp.mlp_block,
            "sra_attention": pvt_attn.sra_attention,
            "sra_block": pvt_attn.sra_block, "pvt_block": pvt_block,
            "depthwise_conv3x3": dwconv.depthwise_conv3x3}


def _reset_counts():
    for f in _wrappers().values():
        f.launches = 0
        if hasattr(f, "mode_launches"):
            f.mode_launches = dict.fromkeys(f.mode_launches, 0)


def _launch_counts() -> dict:
    return {k: f.launches for k, f in _wrappers().items()}


def run_path(torch, np, label, state_dict) -> tuple[dict, object]:
    """Serve the synthetic images on path ``label``; count launches over
    exactly that run."""
    from pranet2_tpu_torch.serve import BinaryPredictor, served_logits

    name, kwargs, launches = PATHS[label]
    images = synthetic_images(np, N_IMAGES)
    pred = BinaryPredictor(name, state_dict, batch_size=BATCH,
                           testsize=SIZE, dtype=torch.bfloat16,
                           model_kwargs=kwargs)
    try:
        pred.warmup()
        _reset_counts()
        t0 = time.perf_counter()
        masks = list(pred.stream(images))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _launch_counts()
        modes = dict(_wrappers()["mlp_block"].mode_launches)
        forwards = -(-N_IMAGES // BATCH)
        want = {k: n * forwards for k, n in launches.items()}
        want_modes = {k: n * forwards for k, n in MLP_MODES[label].items()}
        if counts != want or modes != want_modes:
            raise AssertionError(f"{label}: launches {counts}, MLP modes "
                                 f"{modes} over {forwards} forwards; "
                                 f"expected {want}, {want_modes}")
        if len(masks) != len(images):
            raise AssertionError(f"{len(masks)} masks for {len(images)} images")
        for im, m in zip(images, masks):
            if m.shape != im.shape[:2] or m.dtype != np.uint8:
                raise AssertionError(f"mask {m.shape} {m.dtype} for image "
                                     f"{im.shape}")
        batch = pred._preprocess(images[:BATCH]).to(pred.device)
        with torch.inference_mode():
            fwd_ms = time_ms(lambda: pred.model(batch), reps=10, rounds=5)
            logits = served_logits(pred.model(batch), pred.v2).float()
            device = device_time(torch, lambda: pred.model(batch))
            replaced = replaced_ops(torch, lambda: pred.model(batch),
                                    tail=launches["dsra_level"] > 0)
        if replaced:
            raise AssertionError(f"{label}: the forward still runs ops the "
                                 f"stem and decoder kernels replaced: "
                                 f"{replaced}")
        return {"model": label, "launches": counts, "mlp_modes": modes,
                "forwards": forwards,
                "stream_img_per_s": N_IMAGES / seconds,
                "forward_ms": fwd_ms,
                "forward_img_per_s": BATCH / fwd_ms * 1e3,
                "host": host_time(pred, images[:BATCH]),
                "device": device}, (batch, logits)
    finally:
        pred.close()


def _wait(launched):
    """``launched`` (``BinaryPredictor._launch``'s chunks) once every
    chunk's copy to the host is done."""
    for _, ready in launched:
        if ready is not None:
            ready.synchronize()
    return launched


def host_time(pred, chunk) -> dict:
    """Host clock for one batch's decode (thread pool) and post-processing
    (exact mode: float32 logits resized to native size, one image at a
    time), the two host stages of ``BinaryPredictor.stream``."""
    t0 = time.perf_counter()
    batch = pred._preprocess(chunk)
    t1 = time.perf_counter()
    launched = _wait(pred._launch(batch))
    t2 = time.perf_counter()
    masks = list(pred._postprocess(launched, chunk))
    t3 = time.perf_counter()
    if len(masks) != len(chunk):
        raise AssertionError(f"{len(masks)} masks for {len(chunk)} images")
    return {"decode_ms_per_batch": (t1 - t0) * 1e3,
            "postprocess_ms_per_batch": (t3 - t2) * 1e3}


# ATen ops that stem_pool and dsra_level took over, by the shape of their
# first input: bn1 and its ReLU on the stem's map, and any bilinear resize
# or copy of the decoder's one-channel maps (the partial decoder's x2
# upsamples take 32 channels)
STEM_OPS = ("aten::batch_norm", "aten::relu", "aten::relu_",
            "aten::clamp_min")
TAIL_OPS = ("aten::upsample_bilinear2d", "aten::_to_copy")


def replaced_ops(torch, fn, tail: bool = True) -> dict:
    """Counts of the ATen ops of one forward (a CPU-side trace with input
    shapes) that the stem and decoder kernels replaced; a served forward
    must have none.  ``tail=False`` (PraNet-V1, whose decoder resizes its
    one-channel maps in ATen) looks for the stem's only."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    stem = [BATCH, 64, SIZE // 2, SIZE // 2]
    found = {}
    for e in prof.events():
        first = list(e.input_shapes[0]) if e.input_shapes else []
        if ((e.name in STEM_OPS and first == stem)
                or (tail and e.name in TAIL_OPS and len(first) == 4
                    and first[1] == 1)):
            key = f"{e.name} {first}"
            found[key] = found.get(key, 0) + 1
    return found


def device_time(torch, fn, forwards: int = 5) -> dict:
    """Device time of one forward by kernel (torch.profiler), top ten.

    ``busy_ms`` is the summed kernel time; the forward's idle share follows
    from it and the CUDA-event ``forward_ms``.  ``None`` where the profiler
    saw no device activity.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(forwards):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / forwards)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    if not rows:
        return {"busy_ms": None, "ported_kernels_ms": None, "top": []}
    ported = sum(ms for k, ms in rows if any(
        n in k for n in ("stem_pool_kernel", "dsra_gate", "dsra_level",
                         "attend_kernel",
                         "patch_kernel", "finish_kernel", "mlp_kernel",
                         "dw3x3_kernel", "prep_kernel", "conv1x1_kernel",
                         "conv3x3_kernel", "split_reduce_kernel",
                         "res2_conv_kernel", "res2_split_epilogue")))
    return {"busy_ms": sum(ms for _, ms in rows), "ported_kernels_ms": ported,
            "top": [{"name": k[:90], "ms": ms} for k, ms in rows[:10]]}


def rel_err(a, b) -> float:
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-6)).item()


def check_reference(torch, name, state_dict, batch, logits_bf16) -> dict:
    """bf16 serving logits vs float32 on the card (TF32 off); float32 on the
    card vs float32 on the CPU (plain versions), small input.  The float32
    model is built without keyword arguments, and for PVT the float32 path
    is the module chain, so the first check holds the fused Res2Net and the
    PVT bf16 kernels end to end against code that does not use them."""
    from pranet2_tpu_torch import get_model
    from pranet2_tpu_torch.serve import is_v2, served_logits

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = get_model(name, device=batch.device)
    f32.load_state_dict(state_dict)
    f32.eval()
    cpu = get_model(name, device="cpu")
    cpu.load_state_dict(state_dict)
    cpu.eval()
    with torch.inference_mode():
        logits = served_logits(f32(batch), is_v2(name)).float()
        small = batch[:2, :, :64, :64]
        gpu_maps, cpu_maps = f32(small), cpu(small.cpu())
    for t in (logits, logits_bf16):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("non-finite logits")
    out = {"bf16_vs_f32_rel_err": rel_err(logits_bf16, logits),
           "gpu_vs_cpu_f32_rel_err": max(rel_err(g.cpu(), c) for g, c
                                         in zip(gpu_maps, cpu_maps))}
    if out["bf16_vs_f32_rel_err"] > MODEL_TOL:
        raise AssertionError(f"{name}: bf16 logits off: {out}")
    if out["gpu_vs_cpu_f32_rel_err"] > F32_TOL:
        raise AssertionError(f"{name}: GPU f32 maps off the CPU's: {out}")
    return out


# ---------------------------------------------------------------------------
# training: the binary recipe of pranet2_tpu/train/binary.py on the port
# ---------------------------------------------------------------------------


def write_polyp_set(np, root, n: int, seed: int) -> None:
    """``n`` image/mask PNG pairs under ``root/images`` and ``root/masks``:
    the serving phase's uint8 images (288-576 px sides) with a blob mask
    each, a disc of a random centre and radius."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for sub in ("images", "masks"):
        os.makedirs(os.path.join(root, sub))
    for i in range(n):
        h, w = (int(v) for v in rng.integers(288, 577, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        yy, xx = np.mgrid[:h, :w]
        cy, cx = rng.integers(h // 4, 3 * h // 4), rng.integers(w // 4,
                                                                3 * w // 4)
        r = rng.integers(min(h, w) // 8, min(h, w) // 3)
        mask = (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r).astype(
            np.uint8) * 255
        Image.fromarray(img).save(os.path.join(root, "images", f"{i}.png"))
        Image.fromarray(mask).save(os.path.join(root, "masks", f"{i}.png"))


def _grads(model) -> dict:
    return {k: None if p.grad is None else p.grad.detach().clone()
            for k, p in model.named_parameters()}


def _stats(model) -> dict:
    return {k: b.clone() for k, b in model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


def _hold_f64_step(what: str, ref_grads, ref_stats, got_grads,
                   got_stats) -> tuple[float, float]:
    """A float64 step's gradients and BatchNorm running statistics against
    the reference's: each parameter's gradient within 1e-6 of its largest
    |value| plus 1e-12 of the model's largest (a gradient that is zero in
    exact arithmetic, as a BatchNorm bias's before another BatchNorm, is
    rounding noise of the whole), a gradient on both sides or on neither;
    the statistics within 1e-8 relative and 1e-10 absolute.  Returns the
    worst gradient's and statistic's share of their bounds."""
    scale = max(g.abs().max().item() for g in ref_grads.values()
                if g is not None)
    worst_grad = 0.0
    for k, want in ref_grads.items():
        got = got_grads[k]
        if want is None or got is None:
            if (want is None) != (got is None):
                raise AssertionError(f"{what}: {k} has a gradient on one "
                                     "side only")
            continue
        err = (got.to(want.device) - want).abs().max().item()
        bound = 1e-6 * want.abs().max().item() + 1e-12 * scale
        if err > bound:
            raise AssertionError(f"{what}: gradient of {k} off by {err:.3g} "
                                 f"(bound {bound:.3g})")
        worst_grad = max(worst_grad, err / bound)
    worst_stat = max(((got_stats[k].to(b.device) - b).abs()
                      / (1e-10 + 1e-8 * b.abs())).max().item()
                     for k, b in ref_stats.items())
    if worst_stat > 1:
        raise AssertionError(f"{what}: BatchNorm statistics off "
                             f"({worst_stat:.3g} times the tolerance)")
    return worst_grad, worst_stat


def train_card_vs_cpu(torch, dev) -> dict:
    """One train step's forward and backward of ``pranet_v2`` (full width
    and depth, batch 2 at 256 x 256, the 0.75 scale's size) in float64 on
    the card, through the gate's float64 kernel, and on the CPU, with the
    same weights and batch.  Held: the loss within 1e-9 relative, the
    gradients and BatchNorm running statistics by ``_hold_f64_step``.
    Float64, because train-mode BatchNorm carries float32
    ordering noise through about 50 layers into percent-level gradient
    differences."""
    from pranet2_tpu_torch import get_model
    from pranet2_tpu_torch.ops import dsra
    from pranet2_tpu_torch.train.binary import train_loss

    cpu = get_model("pranet_v2", device="cpu", num_class=1,
                    generator=torch.Generator().manual_seed(5)).double()
    gpu = get_model("pranet_v2", device=dev, num_class=1).double()
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(6)
    x = torch.randn((2, 3, 256, 256), generator=g, dtype=torch.float64)
    gts = (torch.rand((2, 1, 256, 256), generator=g) > 0.6).double()
    before = dsra.dsra_gate.launches
    t0 = time.perf_counter()
    loss_gpu, _ = train_loss(gpu.train(), x.to(dev), gts.to(dev))
    loss_gpu.backward()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = dsra.dsra_gate.launches - before
    loss_cpu, _ = train_loss(cpu.train(), x, gts)
    loss_cpu.backward()
    t2 = time.perf_counter()
    if launches < 3:
        raise AssertionError(f"float64 step: {launches} dsra_gate launches")
    loss_err = abs(loss_gpu.item() - loss_cpu.item()) / abs(loss_cpu.item())
    worst_grad, worst_stat = _hold_f64_step(
        "float64 step", _grads(cpu), _stats(cpu), _grads(gpu), _stats(gpu))
    if loss_err > 1e-9:
        raise AssertionError(f"float64 step: loss {loss_gpu.item()} on the "
                             f"card, {loss_cpu.item()} on the CPU")
    return {"phase": "card_vs_cpu_f64", "dsra_gate_launches": launches,
            "loss": loss_cpu.item(), "loss_rel_err": loss_err,
            "grad_worst_share_of_tol": worst_grad,
            "bn_worst_share_of_tol": worst_stat,
            "card_s": t1 - t0, "cpu_s": t2 - t1}


def train_recipe(torch, np, dev) -> dict:
    """The recipe through its entry point, ``train``: ``pranet_v2`` float32,
    batch 8 at 352, scales 0.75/1/1.25, ``epochs=3`` (the reference's
    range(1, epochs): 2 epochs of 2 batches, 12 steps) over 16 synthetic
    image/mask pairs (cached by the worker pool, fed by
    ``DevicePrefetcher``), ``test_with_eval`` each epoch on 8 more, and one
    snapshot (``save_state``).  Launch counts from just before ``train``
    to just after: 9 ``dsra_gate`` a batch (3 a step, at 3 scales), and one
    ``stem_pool`` and three ``dsra_level`` an eval forward (8 images, one
    batch, each epoch).  Then, on the trained state and one batch, the ms
    of a step at each scale (CUDA events), and the 352 step's device busy
    time (``device_time``) and idle share."""
    from pranet2_tpu_torch.train.binary import (BinaryTrainConfig,
                                                make_train_step, train,
                                                test_with_eval)

    with tempfile.TemporaryDirectory() as root:
        write_polyp_set(np, os.path.join(root, "TrainDataset"), 16, seed=1)
        write_polyp_set(np, os.path.join(root, "TestDataset", "SYN"), 8,
                        seed=2)
        cfg = BinaryTrainConfig(
            model="pranet_v2", epochs=3, batch_size=TRAIN_BATCH,
            trainsize=TRAIN_SIZE, size_rates=TRAIN_RATES,
            train_path=os.path.join(root, "TrainDataset"),
            test_root=os.path.join(root, "TestDataset"),
            eval_datasets=("SYN",), save_dir=os.path.join(root, "snap"),
            snapshot_every=2, log_every=1, device=str(dev))
        metrics, logs = [], []

        def eval_fn(model, state):
            res = test_with_eval(model, cfg.test_root, cfg.eval_datasets,
                                 testsize=cfg.trainsize,
                                 batch_size=TRAIN_BATCH)["SYN"]
            metrics.append(res)
            return res["meanDic"]

        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, best, history = train(cfg, eval_fn=eval_fn, log=logs.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = state.step
        counts = _launch_counts()
        peak = torch.cuda.max_memory_allocated()
        snaps = sorted(os.listdir(cfg.save_dir))
        want = dict.fromkeys(counts, 0)
        want.update(dsra_gate=9 * 4, stem_pool=2, dsra_level=6)
        if counts != want:
            raise AssertionError(f"recipe: launches {counts}, expected {want}")
        if steps != 12 or snaps != ["epoch_2.pt"] or best is None:
            raise AssertionError(f"recipe: step {steps}, snapshots "
                                 f"{snaps}, best kept: {best is not None}")
        losses = [h["loss"] for h in history]
        if not all(np.isfinite(losses)) or len(metrics) != 2 or not all(
                np.isfinite(v) for m in metrics for v in m.values()):
            raise AssertionError(f"recipe: losses {losses}, metrics "
                                 f"{metrics}")

        # one batch of the set, on the trained state: each scale's step
        x = torch.randn((TRAIN_BATCH, 3, TRAIN_SIZE, TRAIN_SIZE),
                        device=dev, generator=torch.Generator(
                            device=dev).manual_seed(7))
        gts = (x[:, :1] > 0.5).float()
        per_scale = {}
        for rate in TRAIN_RATES:
            step = make_train_step(state.model, target_size=_rate_size_of(
                rate), rescale=rate != 1.0)
            per_scale[str(rate)] = time_ms(lambda: step(state, x, gts),
                                           reps=3, rounds=3)
        step = make_train_step(state.model, target_size=TRAIN_SIZE,
                               rescale=False)
        busy = device_time(torch, lambda: step(state, x, gts), forwards=3)
    step_ms = sum(per_scale.values())
    return {"phase": "recipe", "model": "pranet_v2", "dtype": "float32",
            "batch": TRAIN_BATCH, "trainsize": TRAIN_SIZE,
            "scales": list(TRAIN_RATES), "steps": steps,
            "launches": counts, "epochs": history,
            "train_img_per_s_3_scales": history[-1]["img_per_sec"],
            "wall_s": wall, "peak_mem_gb": peak / 1e9,
            "ms_per_step": per_scale,
            "batch_ms_3_scales": step_ms,
            "batch_img_per_s_3_scales": 3 * TRAIN_BATCH / step_ms * 1e3,
            "step_352_busy_ms": busy["busy_ms"],
            "step_352_idle_share": (None if busy["busy_ms"] is None else
                                    1 - busy["busy_ms"] / per_scale["1.0"]),
            "step_352_top": busy["top"][:6], "metrics": metrics[-1],
            "log_tail": logs[-3:]}


def train_fixed_batch(torch, dev, name: str, compute, kwargs: dict) -> dict:
    """4 recipe steps (Adam 1e-4, clip 0.5) of ``name`` on one fixed batch
    of 8 at 352: random images and binary masks from a seed.  Returns the
    losses, the ms of each step (CUDA events) and the gate's launches."""
    from pranet2_tpu_torch import get_model
    from pranet2_tpu_torch.train import TrainState, make_optimizer
    from pranet2_tpu_torch.train.binary import make_train_step

    model = get_model(name, device=dev, num_class=1, **kwargs)
    state = TrainState(model, make_optimizer(model.parameters(),
                                                     1e-4, clip_value=0.5))
    step = make_train_step(model, target_size=TRAIN_SIZE, rescale=False,
                           compute_dtype=compute)
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((TRAIN_BATCH, 3, TRAIN_SIZE, TRAIN_SIZE), device=dev,
                    generator=g)
    gts = (torch.rand((TRAIN_BATCH, 1, TRAIN_SIZE, TRAIN_SIZE), device=dev,
                      generator=g) > 0.5).float()
    _reset_counts()
    losses, ms = [], []
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss, _ = step(state, x, gts)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(loss.item())
    counts = _launch_counts()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: losses {losses}")
    if counts["dsra_gate"] != 12 or sum(counts.values()) != 12:
        raise AssertionError(f"{name}: launches {counts}")
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise AssertionError(f"{name}: a parameter left float32")
    return {"model": name, "dtype": "bfloat16" if compute else "float32",
            "kwargs": kwargs, "losses": losses, "ms_per_step": ms,
            "dsra_gate_launches": counts["dsra_gate"]}


def run_training(torch, np, dev, card) -> dict:
    """The training phase; prints a ``train:`` JSON line for each part.
    Runs with PyTorch's default float32 flags (cuDNN's TF32 on, cuBLAS's
    off), as a user of the CLI trains; returns the launch counts of each
    part."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f64 = train_card_vs_cpu(torch, dev)
        recipe = train_recipe(torch, np, dev)
        bf16 = train_fixed_batch(torch, dev, "pranet_v2", torch.bfloat16,
                                 {})
        if not bf16["losses"][-1] < bf16["losses"][0]:
            raise AssertionError(f"bf16: the loss did not fall: "
                                 f"{bf16['losses']}")
        pvt = train_fixed_batch(torch, dev, "pvt_pranet_v2", None,
                                {"drop_path_rate": 0.1})
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    for part in (f64, recipe, {"phase": "bf16", **bf16},
                 {"phase": "pvt", **pvt}):
        print("train: " + json.dumps({"card": card, **part}))
    print(f"train recipe pranet_v2 f32 {TRAIN_SIZE} batch {TRAIN_BATCH}, 3 "
          f"scales: {recipe['train_img_per_s_3_scales']:.1f} img/s in its "
          f"last epoch, {recipe['batch_img_per_s_3_scales']:.1f} img/s by "
          f"step times {recipe['ms_per_step']}, peak "
          f"{recipe['peak_mem_gb']:.2f} GB, 352 step busy "
          f"{recipe['step_352_busy_ms']} ms on {card}")
    return {"train": recipe["launches"],
            "train_f64": {"dsra_gate": f64["dsra_gate_launches"]},
            "train_bf16": {"dsra_gate": bf16["dsra_gate_launches"]},
            "train_pvt": {"dsra_gate": pvt["dsra_gate_launches"]}}


# ---------------------------------------------------------------------------
# the binary inference CLIs, each in its own process, as a user runs them
# ---------------------------------------------------------------------------

CLI_SETS, CLI_IMAGES = ("SYN1", "SYN2"), 8
CLI_BENCH = ("--models", "pranet_v1", "pranet_v1_resnet", "--batch_sizes",
             "1", "16", "--iters", "10", "--windows", "3")


def _cli(module: str, *args, expect_rc: int = 0) -> tuple[str, float]:
    """``python -m pranet2_tpu_torch.cli.<module> args`` from the checkout;
    its standard output and wall seconds.  Fails on an exit code other
    than ``expect_rc``."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        f"pranet2_tpu_torch.cli.{module}", *args], cwd=here,
                       capture_output=True, text=True, timeout=300)
    if r.returncode != expect_rc:
        raise AssertionError(f"cli.{module} exited {r.returncode}:\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    return r.stdout, time.perf_counter() - t0


def run_cli(torch, np) -> dict:
    """The binary CLIs on the card: random ``pranet_v1`` weights saved as a
    reference checkpoint (a ``state_dict`` container, ``module.`` keys, a
    stray ``resnet.fc.weight``); ``cli.test_binary`` exports two synthetic
    sets of 8 images (float32, 352, batch 16), ``cli.eval_binary`` scores
    its PNGs, ``cli.benchmark`` times pranet_v1 and pranet_v1_resnet (bf16,
    batch 1 and 16, 3 windows of 10 forwards).  Checks the PNGs' count and
    sizes, the dropped key's report, finite metrics and every table row."""
    from PIL import Image

    from pranet2_tpu_torch import get_model

    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "TestDataset")
        for k, ds in enumerate(CLI_SETS):
            write_polyp_set(np, os.path.join(data, ds), CLI_IMAGES,
                            seed=10 + k)
        sd = get_model("pranet_v1", device="cpu",
                       generator=torch.Generator().manual_seed(3)).state_dict()
        sd = {f"module.{k}": v for k, v in sd.items()}
        sd["module.resnet.fc.weight"] = torch.zeros((1000, 2048))
        pth = os.path.join(root, "pranet_v1.pth")
        torch.save({"state_dict": sd, "epoch": 1}, pth)
        results = os.path.join(root, "results")
        out, test_s = _cli("test_binary", "--model", "pranet_v1",
                           "--checkpoint", pth, "--data_root", data,
                           "--save_root", results, "--datasets", *CLI_SETS)
        if "'resnet.fc.weight'" not in out:
            raise AssertionError(f"test_binary: no dropped key reported: "
                                 f"{out}")
        for ds in CLI_SETS:
            pngs = sorted(os.listdir(os.path.join(results, "pranet_v1", ds)))
            if len(pngs) != CLI_IMAGES:
                raise AssertionError(f"test_binary: {len(pngs)} maps in {ds}")
            for f in pngs:
                pred = np.asarray(Image.open(os.path.join(
                    results, "pranet_v1", ds, f)))
                gt = np.asarray(Image.open(os.path.join(data, ds, "masks",
                                                        f)))
                if pred.dtype != np.uint8 or pred.shape != gt.shape:
                    raise AssertionError(f"test_binary: {ds}/{f} is "
                                         f"{pred.shape} {pred.dtype}")
        csvs = os.path.join(root, "eval")
        eval_out, eval_s = _cli("eval_binary", "--pred_root",
                                os.path.join(results, "pranet_v1"),
                                "--gt_root", data, "--datasets", *CLI_SETS,
                                "--result_path", csvs)
        metrics = {}
        for ds in CLI_SETS:
            with open(os.path.join(csvs, f"result_{ds}.csv")) as f:
                head, row = f.read().splitlines()
            metrics[ds] = dict(zip(head.split(", ")[1:], map(
                float, row.rstrip(",").split(",")[1:])))
            if not all(math.isfinite(v) for v in metrics[ds].values()):
                raise AssertionError(f"eval_binary: {metrics}")
    bench_out, bench_s = _cli("benchmark", *CLI_BENCH)
    rows = [ln.split() for ln in bench_out.splitlines()
            if ln.startswith("pranet_v1")]
    if sorted((r[0], r[1]) for r in rows) != sorted(
            (m, b) for m in ("pranet_v1", "pranet_v1_resnet")
            for b in ("1", "16")) or not all(float(r[2]) > 0 for r in rows):
        raise AssertionError(f"benchmark: table rows {rows}")
    return {"test_binary_s": test_s, "eval_binary_s": eval_s,
            "benchmark_s": bench_s, "pngs": CLI_IMAGES * len(CLI_SETS),
            "metrics": metrics, "eval_table": eval_out.splitlines(),
            "benchmark_table": bench_out.splitlines()}


# ---------------------------------------------------------------------------
# the multiclass half: EMCAD served over CT-sized volumes, its recipe and
# its CLIs
# ---------------------------------------------------------------------------

# one CT-sized volume: 32 slices of 512^2 (Synapse's volumes hold 85-198;
# cut for the script's time limit), two chunks of 16
EMCAD_VOLUME = (32, 512, 512)
EMCAD_CHUNK = 16
_NONE = {**_V1, "stem_pool": 0, **_NO_RES2, **_NO_PVT}
# served volume paths: label -> (model, get_model keyword arguments, the
# family's test mode, launches per forward by kernel, MLP modes a forward);
# every gate is its decoder's standalone ``dsra_gate`` (no dsra_level).
# EMCAD on PVTv2-b2 and ResNet-50; MERIT-small (two backbones, the decoder
# run twice: 6 gates) and MIST (3 gates), all dual, 9 classes
VOLUME_PATHS = {
    "emcad_pvt_v2_b2": ("emcad", {"encoder": "pvt_v2_b2"}, "fg_only",
                        {**_NONE, "dsra_gate": 3, "mlp_block": 16,
                         "sra_attention": 16},
                        {"plain": 0, "stats": 12, "final_ln": 4}),
    "emcad_resnet50": ("emcad", {"encoder": "resnet50"}, "fg_only",
                       {**_NONE, "dsra_gate": 3, "stem_pool": 1}, _NO_MLP),
    "merit_cascaded": ("merit_cascaded", {"model_scale": "small"},
                       "fg_minus_bg", {**_NONE, "dsra_gate": 6}, _NO_MLP),
    "mist_cam": ("mist_cam", {}, "fg_only", {**_NONE, "dsra_gate": 3},
                 _NO_MLP),
}
EMCAD_PATHS = ("emcad_pvt_v2_b2", "emcad_resnet50")
MAXVIT_PATHS = ("merit_cascaded", "mist_cam")


def synthetic_volume(np, shape, classes: int, seed: int):
    """A float32 volume of ``shape`` (values in [0, 1], smooth organs over
    noise, as a normalised CT) and its int32 labels: ``classes - 1``
    ellipsoids of labels 1.. at random centres."""
    rng = np.random.default_rng(seed)
    d, h, w = shape
    zz, yy, xx = np.ogrid[:d, :h, :w]
    labels = np.zeros(shape, np.int32)
    for c in range(1, classes):
        cz, cy, cx = (rng.uniform(0.2, 0.8) * n for n in shape)
        rz, ry, rx = (rng.uniform(0.1, 0.25) * n for n in shape)
        labels[((zz - cz) / rz) ** 2 + ((yy - cy) / ry) ** 2
               + ((xx - cx) / rx) ** 2 < 1] = c
    image = (0.2 * rng.random(shape, dtype=np.float32)
             + labels.astype(np.float32) / classes)
    return image, labels


class _Volumes:
    """A dataset of the given (image, label) volumes, as the multiclass
    datasets give them."""

    def __init__(self, volumes):
        self.volumes = volumes

    def __len__(self):
        return len(self.volumes)

    def case_name(self, i):
        return f"case{i:04d}"

    def __getitem__(self, i):
        return self.volumes[i]


def _outputs(out) -> tuple:
    """A model's maps as a tuple (``maxvit_seg`` returns one tensor)."""
    return out if isinstance(out, tuple) else (out,)


def _on_card(torch, cpu_model, dev, dtype=None):
    """A copy of ``cpu_model`` on ``dev`` in eval, its convolutions and
    Linears cast to ``dtype`` (``nn.set_compute_dtype``) when given: what
    ``get_model(..., device=dev, dtype=dtype)`` and ``load_state_dict``
    give, without drawing the weights again."""
    from pranet2_tpu_torch.nn import set_compute_dtype

    model = copy.deepcopy(cpu_model).to(dev)
    if dtype is not None:
        set_compute_dtype(model, dtype)
    return model.eval()


def run_volume_path(torch, np, dev, label, cpu_model,
                    full_metrics: bool = True) -> tuple[dict, object]:
    """Serve one synthetic CT volume on path ``label`` (``cpu_model``'s
    weights in bf16 on the card) through ``train.multiclass.test_volumes``
    (eval, chunks of 16, the family's test mode; Dice, HD95, Jaccard and
    ASD, or with ``full_metrics=False`` Dice alone); count launches over
    exactly that run."""
    from pranet2_tpu_torch.train.multiclass import (combined_logits,
                                                    test_volumes,
                                                    zoom_to_patch)

    _, _, mode, launches, mlp_modes = VOLUME_PATHS[label]
    model = _on_card(torch, cpu_model, dev, torch.bfloat16)
    image, labels = synthetic_volume(np, EMCAD_VOLUME, EMCAD_CLASSES, seed=0)
    patch = (EMCAD_SIZE, EMCAD_SIZE)
    t0 = time.perf_counter()
    chunk = zoom_to_patch(image[:EMCAD_CHUNK], patch)
    zoom_ms = (time.perf_counter() - t0) * 1e3
    batch = torch.from_numpy(chunk).to(dev)
    with torch.inference_mode():
        model(batch)  # warm-up: cuDNN's choices, the kernels' first launch
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    metrics, names = test_volumes(model, _Volumes([(image, labels)]),
                                  EMCAD_CLASSES, patch, mode,
                                  full_metrics=full_metrics,
                                  chunk=EMCAD_CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    modes = dict(_wrappers()["mlp_block"].mode_launches)
    forwards = -(-EMCAD_VOLUME[0] // EMCAD_CHUNK)
    want = {k: n * forwards for k, n in launches.items()}
    want_modes = {k: n * forwards for k, n in mlp_modes.items()}
    if counts != want or modes != want_modes:
        raise AssertionError(f"{label}: launches {counts}, MLP modes {modes} "
                             f"over {forwards} forwards; expected {want}, "
                             f"{want_modes}")
    n_metrics = 4 if full_metrics else 1
    if metrics.shape != (1, EMCAD_CLASSES - 1, n_metrics) or not np.isfinite(
            metrics).all():
        raise AssertionError(f"{label}: metrics {metrics}")
    with torch.inference_mode():
        fwd = lambda: model(batch)
        fwd_ms = time_ms(fwd, reps=10, rounds=5)
        logits = combined_logits(fwd(), mode).float()
        device = device_time(torch, fwd)
    busy = device["busy_ms"]
    return {"model": label, "launches": counts, "mlp_modes": modes,
            "forwards": forwards, "volume": list(EMCAD_VOLUME),
            "full_metrics": full_metrics,
            "volume_wall_s": wall, "forward_ms": fwd_ms,
            "forward_img_per_s": EMCAD_CHUNK / fwd_ms * 1e3,
            "idle_share": None if busy is None else 1 - busy / fwd_ms,
            "host_zoom_ms_per_chunk": zoom_ms, "device": device,
            "mean_dice": float(metrics[0, :, 0].mean())}, (batch, logits)


def _f32_reference(torch, label, cpu, batch, logits_bf16, to_logits) -> dict:
    """bf16 logits vs the float32 model's on the card (TF32 off; the gates
    on their float32 kernel); the card's float32 maps vs the CPU's
    (``cpu``, the plain versions) on a small input (2 images of 64^2)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = _on_card(torch, cpu, batch.device)
    with torch.inference_mode():
        logits = to_logits(f32(batch)).float()
        small = batch[:2, :, :64, :64]
        gpu_maps, cpu_maps = (_outputs(f32(small)),
                              _outputs(cpu(small.cpu())))
    for t in (logits, logits_bf16):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{label}: non-finite logits")
    out = {"bf16_vs_f32_rel_err": rel_err(logits_bf16, logits),
           "gpu_vs_cpu_f32_rel_err": max(rel_err(g.cpu(), c) for g, c
                                         in zip(gpu_maps, cpu_maps))}
    if out["bf16_vs_f32_rel_err"] > MODEL_TOL:
        raise AssertionError(f"{label}: bf16 logits off: {out}")
    if out["gpu_vs_cpu_f32_rel_err"] > F32_TOL:
        raise AssertionError(f"{label}: GPU f32 maps off the CPU's: {out}")
    return out


def serve_volume_path(torch, np, dev, label, card,
                      full_metrics: bool = True) -> dict:
    """One volume path (``run_volume_path``, random weights from seed 0)
    and its reference checks (``_f32_reference`` on the family's combined
    logits); prints and returns its ``model:`` record."""
    from pranet2_tpu_torch import get_model
    from pranet2_tpu_torch.train.multiclass import combined_logits

    name, kwargs, mode, _, _ = VOLUME_PATHS[label]
    cpu = get_model(name, device="cpu", num_classes=EMCAD_CLASSES,
                    generator=torch.Generator().manual_seed(0),
                    **kwargs).eval()
    model, (batch, logits_bf16) = run_volume_path(torch, np, dev, label, cpu,
                                                  full_metrics)
    model.update(_f32_reference(torch, label, cpu, batch, logits_bf16,
                                lambda o: combined_logits(o, mode)))
    print(f"{label} bf16 {EMCAD_SIZE}x{EMCAD_SIZE} chunk {EMCAD_CHUNK}: "
          f"forward {model['forward_ms']:.2f} ms "
          f"({model['forward_img_per_s']:.1f} img/s), busy "
          f"{model['device']['busy_ms']} ms, volume "
          f"{model['volume_wall_s']:.2f} s on {card}")
    print("model: " + json.dumps(model))
    return model


# the rest of the MaxViT zoo, one bf16 forward each at batch 16: label ->
# (model, keyword arguments, input side, gates a forward); merit_parallel at
# ACDC's 256^2 and 4 classes, the single-backbone models on the small
# 224^2 backbone at Synapse's 9
MAXVIT_FORWARDS = {
    "merit_parallel": ("merit_parallel", {"num_classes": 4}, 256, 6),
    "maxvit_seg": ("maxvit_seg", {"num_classes": EMCAD_CLASSES}, 224, 0),
    "maxvit4out": ("maxvit4out", {"num_classes": EMCAD_CLASSES}, 224, 0),
    "maxvit_cascade": ("maxvit_cascade", {"num_classes": EMCAD_CLASSES}, 224,
                       0),
}


def run_maxvit_forwards(torch, dev, card) -> list:
    """``MAXVIT_FORWARDS``: each model in bf16 (random weights from seed 0)
    on a seeded batch of 16, with the launch counters set to 0 just before
    its forward and read just after (``dsra_gate`` 6 for merit_parallel,
    no kernel for the zoo); the maps' shapes and finiteness, their sum
    against the float32 model's (TF32 off) and the card's float32 against
    the CPU's on a small input."""
    from pranet2_tpu_torch import get_model

    records = []
    for label, (name, kwargs, side, gates) in MAXVIT_FORWARDS.items():
        cpu = get_model(name, device="cpu",
                        generator=torch.Generator().manual_seed(0),
                        **kwargs).eval()
        model = _on_card(torch, cpu, dev, torch.bfloat16)
        g = torch.Generator(device=dev).manual_seed(4)
        batch = torch.rand((BATCH, 1, side, side), generator=g, device=dev)
        with torch.inference_mode():
            model(batch)
            torch.cuda.synchronize()
            _reset_counts()
            maps = _outputs(model(batch))
            torch.cuda.synchronize()
            counts = _launch_counts()
            fwd_ms = time_ms(lambda: model(batch), reps=3, rounds=3)
        if counts != {**_NONE, "dsra_gate": gates}:
            raise AssertionError(f"{label}: launches {counts}")
        want = (BATCH, kwargs["num_classes"], side, side)
        if any(tuple(m.shape) != want or not bool(torch.isfinite(m).all())
               for m in maps):
            raise AssertionError(f"{label}: maps {[m.shape for m in maps]}")
        rec = {"model": label, "launches": counts, "forwards": 1,
               "maps": len(maps), "forward_ms": fwd_ms,
               **_f32_reference(torch, label, cpu, batch,
                                sum(m.float() for m in maps),
                                lambda o: sum(_outputs(o)))}
        print(f"{label} bf16 {side}x{side} batch {BATCH}: forward "
              f"{fwd_ms:.2f} ms on {card}")
        print("model: " + json.dumps(rec))
        records.append(rec)
    return records


def write_slices(np, root, n: int, side: int, seed: int, keys,
                 classes: int = 14) -> list:
    """``n`` ``.npz`` slices of ``side``^2 under ``root`` (image and label
    under ``keys``: Synapse's ``image``/``label``, ACDC's ``img``/``label``),
    each a slice of a synthetic volume; returns their names."""
    os.makedirs(root, exist_ok=True)
    image, labels = synthetic_volume(np, (n, side, side), classes, seed)
    names = []
    for i in range(n):
        name = f"case{seed:02d}_slice{i:03d}"
        np.savez(os.path.join(root, f"{name}.npz"),
                 **{keys[0]: image[i], keys[1]: labels[i]})
        names.append(name)
    return names


def _write_list(path, names) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(names) + "\n")


MC_TRAIN_SLICES, MC_VALID_SLICES, MC_EPOCHS = 12, 6, 4


def train_multiclass_recipe(torch, np, dev) -> dict:
    """The recipe through ``train.multiclass.train_multiclass``: EMCAD-B2
    float32, batch 6 at 224 (Synapse's defaults: AdamW 1e-4, weight decay
    1e-4, MUTATION), ``MC_EPOCHS`` epochs of 2 batches over 12 synthetic
    Synapse ``.npz`` slices of 512^2 (labels 0-13, remapped to 9 classes,
    ``RandomGenerator``), validated on an ACDC-layout ``valid`` split of 6
    ``.npz`` slices of 256^2 (labels 0-8) from ``eval_from_frac`` on.
    Launch counts from just before ``train_multiclass`` to just after: 3
    ``dsra_gate`` a step and 3 a validation forward (one chunk a slice),
    no other kernel (float32: the PVT blocks on the module chain).  Then,
    on the trained state and one batch, ms a step (CUDA events), its
    launches, and its device busy time and idle share."""
    from pranet2_tpu_torch import get_model
    from pranet2_tpu_torch.data import (ACDCDataset, RandomGenerator,
                                        SynapseDataset)
    from pranet2_tpu_torch.train import multiclass as mc

    with tempfile.TemporaryDirectory() as root:
        names = write_slices(np, os.path.join(root, "train_npz"),
                             MC_TRAIN_SLICES, 512, 1, ("image", "label"))
        _write_list(os.path.join(root, "lists", "train.txt"), names)
        valid = write_slices(np, os.path.join(root, "acdc", "valid"),
                             MC_VALID_SLICES, 256, 2, ("img", "label"),
                             classes=EMCAD_CLASSES)
        _write_list(os.path.join(root, "acdc_lists", "valid.txt"),
                    [f"{n}.npz" for n in valid])
        cfg = mc.MulticlassTrainConfig(
            num_classes=EMCAD_CLASSES, max_epochs=MC_EPOCHS,
            batch_size=EMCAD_TRAIN_BATCH, img_size=EMCAD_SIZE)
        train_ds = SynapseDataset(
            os.path.join(root, "train_npz"), os.path.join(root, "lists"),
            "train", nclass=EMCAD_CLASSES,
            transform=RandomGenerator((EMCAD_SIZE, EMCAD_SIZE),
                                      seed=cfg.seed))
        val_ds = ACDCDataset(os.path.join(root, "acdc"),
                             os.path.join(root, "acdc_lists"), "valid")
        model = get_model("emcad", device=dev, num_classes=EMCAD_CLASSES,
                          encoder="pvt_v2_b2",
                          generator=torch.Generator().manual_seed(cfg.seed))
        logs = []
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, best, history = mc.train_multiclass(model, cfg, train_ds,
                                                   val_ds, log=logs.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = _launch_counts()
    trained = state.step
    steps = MC_EPOCHS * (MC_TRAIN_SLICES // EMCAD_TRAIN_BATCH)
    eval_from = int(MC_EPOCHS * cfg.eval_from_frac)
    validations = sum(e >= eval_from for e in range(1, MC_EPOCHS + 1))
    want = {**_NONE, "dsra_gate": 3 * steps
            + 3 * MC_VALID_SLICES * validations}
    if counts != want:
        raise AssertionError(f"multiclass recipe: launches {counts}, "
                             f"expected {want}")
    dice = [h["val_dice"] for h in history if "val_dice" in h]
    losses = [h["loss"] for h in history]
    if (trained != steps or len(dice) != validations
            or not all(np.isfinite(losses + dice))):
        raise AssertionError(f"multiclass recipe: step {trained}, "
                             f"history {history}")
    return {"phase": "multiclass_recipe", "model": "emcad_pvt_v2_b2",
            "dtype": "float32", "batch": EMCAD_TRAIN_BATCH,
            "img_size": EMCAD_SIZE, "steps": trained, "launches": counts,
            "epochs": history, "best_kept": best is not None, "wall_s": wall,
            "peak_mem_gb": peak / 1e9, "log_tail": logs[-3:],
            **_step_profile(torch, dev, model, cfg, state, 3)}


def _step_profile(torch, dev, model, cfg, state, gates: int) -> dict:
    """On the trained state and one seeded batch (``cfg``'s size, 9
    classes): the step's launches (``gates`` ``dsra_gate``, no other
    kernel), ms a step (CUDA events), and its device busy time and idle
    share."""
    from pranet2_tpu_torch.train import multiclass as mc

    g = torch.Generator(device=dev).manual_seed(3)
    n, side = cfg.batch_size, cfg.img_size
    x = torch.randn((n, 1, side, side), generator=g, device=dev)
    y = torch.randint(0, cfg.num_classes, (n, side, side), generator=g,
                      device=dev)
    step = mc.make_multiclass_train_step(model, cfg)
    _reset_counts()
    step(state, x, y)
    torch.cuda.synchronize()
    per_step = _launch_counts()
    if per_step != {**_NONE, "dsra_gate": gates}:
        raise AssertionError(f"multiclass step: launches {per_step}")
    step_ms = time_ms(lambda: step(state, x, y), reps=3, rounds=3)
    busy = device_time(torch, lambda: step(state, x, y), forwards=3)
    return {"dsra_gate_per_step": per_step["dsra_gate"],
            "ms_per_step": step_ms, "train_img_per_s": n / step_ms * 1e3,
            "step_busy_ms": busy["busy_ms"],
            "step_idle_share": (None if busy["busy_ms"] is None
                                else 1 - busy["busy_ms"] / step_ms),
            "step_top": busy["top"][:6]}


# MERIT-small and MIST on Synapse's recipe (float32, batch 6 at 224, the
# seeded dropout on): label -> (model, keyword arguments, gates a step)
MAXVIT_TRAIN = {"merit_cascaded": ("merit_cascaded", {"model_scale": "small"},
                                   6),
                "mist_cam": ("mist_cam", {}, 3)}
MAXVIT_TRAIN_EPOCHS = 2


def train_maxvit(torch, np, dev, label) -> dict:
    """``train_multiclass`` on ``MAXVIT_TRAIN[label]``: ``MAXVIT_TRAIN_EPOCHS``
    epochs of 2 batches over 12 synthetic Synapse ``.npz`` slices of 512^2
    (labels 0-13, remapped to 9 classes, ``RandomGenerator``), no
    validation; its launches from just before to just after (only the
    gates), then ``_step_profile``."""
    from pranet2_tpu_torch import get_model
    from pranet2_tpu_torch.data import RandomGenerator, SynapseDataset
    from pranet2_tpu_torch.nn import Dropout
    from pranet2_tpu_torch.train import multiclass as mc

    name, kwargs, gates = MAXVIT_TRAIN[label]
    with tempfile.TemporaryDirectory() as root:
        names = write_slices(np, os.path.join(root, "train_npz"),
                             MC_TRAIN_SLICES, 512, 7, ("image", "label"))
        _write_list(os.path.join(root, "lists", "train.txt"), names)
        cfg = mc.MulticlassTrainConfig(
            num_classes=EMCAD_CLASSES, max_epochs=MAXVIT_TRAIN_EPOCHS,
            batch_size=EMCAD_TRAIN_BATCH, img_size=EMCAD_SIZE)
        train_ds = SynapseDataset(
            os.path.join(root, "train_npz"), os.path.join(root, "lists"),
            "train", nclass=EMCAD_CLASSES,
            transform=RandomGenerator((EMCAD_SIZE, EMCAD_SIZE),
                                      seed=cfg.seed))
        model = get_model(name, device=dev, num_classes=EMCAD_CLASSES,
                          generator=torch.Generator().manual_seed(cfg.seed),
                          **kwargs)
        drops = sum(isinstance(m, Dropout) and m.rate > 0
                    for m in model.modules())
        logs = []
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, _, history = mc.train_multiclass(model, cfg, train_ds,
                                                log=logs.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = _launch_counts()
    steps = MAXVIT_TRAIN_EPOCHS * (MC_TRAIN_SLICES // EMCAD_TRAIN_BATCH)
    losses = [h["loss"] for h in history]
    if (counts != {**_NONE, "dsra_gate": gates * steps}
            or state.step != steps or not all(np.isfinite(losses))):
        raise AssertionError(f"{label} recipe: launches {counts}, step "
                             f"{state.step}, history {history}")
    return {"phase": "maxvit_recipe", "model": label, "dtype": "float32",
            "batch": EMCAD_TRAIN_BATCH, "img_size": EMCAD_SIZE,
            "steps": steps, "dropout_modules": drops, "launches": counts,
            "epochs": history, "wall_s": wall, "peak_mem_gb": peak / 1e9,
            "log_tail": logs[-2:],
            **_step_profile(torch, dev, model, cfg, state, gates)}


def _user_flags(torch, fn):
    """``fn()`` with PyTorch's default float32 flags (cuDNN's TF32 on,
    cuBLAS's off), as a user of the CLI trains."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return fn()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def _print_train(recipe, card) -> None:
    print("train: " + json.dumps({"card": card, **recipe}))
    print(f"train multiclass {recipe['model']} f32 {EMCAD_SIZE} batch "
          f"{EMCAD_TRAIN_BATCH}: {recipe['ms_per_step']:.1f} ms a step, "
          f"{recipe['train_img_per_s']:.1f} img/s, peak "
          f"{recipe['peak_mem_gb']:.2f} GB, busy {recipe['step_busy_ms']} ms "
          f"on {card}")


def run_multiclass_training(torch, np, dev, card) -> dict:
    """The multiclass recipe (``_user_flags``); prints its ``train:`` line
    and returns its launch counts."""
    recipe = _user_flags(torch, lambda: train_multiclass_recipe(torch, np,
                                                                dev))
    _print_train(recipe, card)
    return {"train_multiclass": recipe["launches"]}


def run_maxvit_training(torch, np, dev, card) -> dict:
    """``train_maxvit`` on MERIT and MIST (``_user_flags``); prints their
    ``train:`` lines and returns their launch counts."""
    counts = {}
    for label in MAXVIT_TRAIN:
        recipe = _user_flags(torch, lambda: train_maxvit(torch, np, dev,
                                                         label))
        _print_train(recipe, card)
        counts[f"train_{label}"] = recipe["launches"]
    return counts


def run_multiclass_cli(torch, np) -> dict:
    """The multiclass CLIs on the card, each as a process:
    ``cli.train_multiclass`` (EMCAD on ``pvt_v2_b0``, Synapse defaults:
    batch 6 at 224, one epoch) over 12 synthetic ``.npz`` slices, and
    ``cli.test_multiclass --dataset acdc`` (EMCAD-B2, 4 classes, 256,
    float32) over 2 synthetic ACDC ``.npz`` volumes, from a reference-style
    ``.pth`` (``module.`` keys in a ``state_dict`` container).  Checks the
    printed lines, the snapshot and the metrics' finiteness."""
    from pranet2_tpu_torch import get_model

    with tempfile.TemporaryDirectory() as root:
        names = write_slices(np, os.path.join(root, "train_npz"),
                             MC_TRAIN_SLICES, 512, 4, ("image", "label"))
        _write_list(os.path.join(root, "lists", "train.txt"), names)
        out_dir = os.path.join(root, "out")
        train_out, train_s = _cli(
            "train_multiclass", "--model", "emcad", "--encoder", "pvt_v2_b0",
            "--dataset", "synapse", "--max_epochs", "1", "--root_path",
            os.path.join(root, "train_npz"), "--list_dir",
            os.path.join(root, "lists"), "--save_dir", out_dir)
        lines = train_out.splitlines()
        if (not lines or not lines[0].startswith("epoch 1/1 loss")
                or not lines[-1].startswith("done; snapshots in")
                or not os.path.exists(os.path.join(out_dir, "last.pt"))):
            raise AssertionError(f"train_multiclass: {train_out}")
        cases = []
        for i in range(2):
            image, labels = synthetic_volume(np, (10, 256, 232), 4, 5 + i)
            np.savez(os.path.join(root, f"patient{i}.npz"), img=image,
                     label=labels)
            cases.append(f"patient{i}.npz")
        _write_list(os.path.join(root, "acdc_lists", "test.txt"), cases)
        sd = get_model("emcad", device="cpu", num_classes=4,
                       generator=torch.Generator().manual_seed(6)
                       ).state_dict()
        pth = os.path.join(root, "emcad_acdc.pth")
        torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
                   pth)
        test_out, test_s = _cli(
            "test_multiclass", "--dataset", "acdc", "--volume_path", root,
            "--list_dir", os.path.join(root, "acdc_lists"), "--checkpoint",
            pth)
    lines = test_out.splitlines()
    numbers = [float(v) for ln in lines
               for v in re.findall(r"-?\d+\.\d+|nan|inf", ln)]
    if (len(lines) != 2 + 3 + 1 or not lines[-1].startswith("mean dice")
            or not all(math.isfinite(v) for v in numbers)):
        raise AssertionError(f"test_multiclass: {test_out}")
    return {"train_multiclass_s": train_s, "test_multiclass_s": test_s,
            "train_lines": train_out.splitlines(), "test_lines": lines}


def run_maxvit_cli(torch, np) -> dict:
    """The multiclass CLIs on MIST and MERIT, each as a process:
    ``cli.test_multiclass --model mist --dataset acdc`` (float32, 4 classes,
    256) over 2 synthetic ACDC ``.npz`` volumes from a reference-style
    ``.pth`` (a ``state_dict`` container, ``module.`` keys, the packed
    ``in_proj_weight``s and the decoder blocks' dead ``conv3``, which the
    CLI drops and reports), and ``cli.train_multiclass --model merit``
    (Synapse defaults: batch 6 at 224, one epoch over 12 synthetic
    slices).  Checks the printed lines, the snapshot and the metrics'
    finiteness."""
    from pranet2_tpu_torch import get_model

    with tempfile.TemporaryDirectory() as root:
        cases = []
        for i in range(2):
            image, labels = synthetic_volume(np, (10, 256, 232), 4, 8 + i)
            np.savez(os.path.join(root, f"patient{i}.npz"), img=image,
                     label=labels)
            cases.append(f"patient{i}.npz")
        _write_list(os.path.join(root, "acdc_lists", "test.txt"), cases)
        sd = get_model("mist_cam", device="cpu", num_classes=4,
                       generator=torch.Generator().manual_seed(9)
                       ).state_dict()
        if "decoder.block_5.trans.attention_output.attention." \
                "in_proj_weight" not in sd:
            raise AssertionError("mist_cam holds no packed in_proj_weight")
        for i in (6, 7, 8, 9):  # Block_decoder.conv3: defined, never run
            sd[f"decoder.block_{i}.conv3.weight"] = torch.zeros((4, 4, 3, 3))
            sd[f"decoder.block_{i}.conv3.bias"] = torch.zeros(4)
        pth = os.path.join(root, "mist_acdc.pth")
        torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
                   pth)
        del sd
        test_out, test_s = _cli(
            "test_multiclass", "--model", "mist", "--dataset", "acdc",
            "--volume_path", root, "--list_dir",
            os.path.join(root, "acdc_lists"), "--checkpoint", pth)
        names = write_slices(np, os.path.join(root, "train_npz"),
                             MC_TRAIN_SLICES, 512, 10, ("image", "label"))
        _write_list(os.path.join(root, "lists", "train.txt"), names)
        out_dir = os.path.join(root, "out")
        train_out, train_s = _cli(
            "train_multiclass", "--model", "merit", "--dataset", "synapse",
            "--max_epochs", "1", "--no-cache", "--root_path",
            os.path.join(root, "train_npz"), "--list_dir",
            os.path.join(root, "lists"), "--save_dir", out_dir)
        saved = os.path.exists(os.path.join(out_dir, "last.pt"))
    lines = test_out.splitlines()
    numbers = [float(v) for ln in lines[1:]
               for v in re.findall(r"-?\d+\.\d+|nan|inf", ln)]
    if (len(lines) != 1 + 2 + 3 + 1
            or not lines[0].startswith("dropped 8 checkpoint keys")
            or not lines[-1].startswith("mean dice")
            or not all(math.isfinite(v) for v in numbers)):
        raise AssertionError(f"test_multiclass mist: {test_out}")
    tlines = train_out.splitlines()
    if (not tlines or not tlines[0].startswith("epoch 1/1 loss")
            or not tlines[-1].startswith("done; snapshots in") or not saved):
        raise AssertionError(f"train_multiclass merit: {train_out}")
    return {"test_multiclass_mist_s": test_s,
            "train_multiclass_merit_s": train_s, "test_lines": lines,
            "train_lines": tlines}


# ---------------------------------------------------------------------------
# the parallel phase: data-parallel training (ranks) and multi-card serving
# (replicas), run on the one card unless two are present
# ---------------------------------------------------------------------------

PAR_F64_SIZE, PAR_F64_BATCH = 256, 2        # train_card_vs_cpu's step
PAR_F32_SIZE, PAR_F32_BATCH, PAR_F32_STEPS = 352, 8, 4  # global batch
PAR_PROFILED_STEPS = 2
PAR_CLI_TRAIN, PAR_CLI_TEST = 16, 8         # torchrun CLI: images
PAR_SERVE_IMAGES = 48                       # three batches of 16
PAR_RANK_TIMEOUT_S = 300                    # each rank's collectives
PAR_LAUNCH_TIMEOUT_S = 600                  # the spawned pair, all told
PAR_PARAM_TOL = 1e-7    # after clip + Adam: 1e-3 of the learning rate
RB_SETS, RB_IMAGES = ("CVC-300", "Kvasir"), 8


def _par_f64_step(torch, dev):
    """One float64 train step of ``pranet_v2`` (full width and depth, the
    recipe's clip + Adam) on this process's rows of a seeded global batch
    of 2 at 256 x 256 (both rows without a group), on its current card.
    Returns the loss (averaged over the ranks), the gradients as
    ``apply_gradients`` took them, the BatchNorm statistics and the
    parameters after the step, and the launches of the step alone."""
    from pranet2_tpu_torch import get_model, parallel
    from pranet2_tpu_torch.train import TrainState, make_optimizer
    from pranet2_tpu_torch.train.binary import make_train_step

    model = get_model("pranet_v2", device=dev, num_class=1,
                      generator=torch.Generator().manual_seed(5)).double()
    net = parallel.data_parallel(model)
    state = TrainState(model, make_optimizer(model.parameters(), 1e-4,
                                             clip_value=0.5))
    grads = {}
    apply = state.apply_gradients

    def spy():
        grads.update(_grads(model))
        apply()

    state.apply_gradients = spy
    step = make_train_step(net, target_size=PAR_F64_SIZE, rescale=False)
    g = torch.Generator().manual_seed(6)
    s = PAR_F64_SIZE
    x = torch.randn((PAR_F64_BATCH, 3, s, s), generator=g,
                    dtype=torch.float64)
    gts = (torch.rand((PAR_F64_BATCH, 1, s, s), generator=g) > 0.6).double()
    rows = parallel.shard_rows(PAR_F64_BATCH, parallel.rank(),
                               parallel.world())
    _reset_counts()
    state, loss, _ = step(state, x[rows].to(dev), gts[rows].to(dev))
    torch.cuda.synchronize()
    launches = _launch_counts()
    return {"loss": float(parallel.all_mean(loss)), "grads": grads,
            "stats": _stats(model),
            "params": {k: p.detach().clone()
                       for k, p in model.named_parameters()},
            "launches": launches, "kind": type(net).__name__}


def _par_compare(ref, got) -> dict:
    """The data-parallel float64 step against one process's, on the card:
    the loss within 1e-9 relative and the gradients and statistics by
    ``_hold_f64_step`` (``train_card_vs_cpu``'s bounds), and the parameters
    after clip + Adam within ``PAR_PARAM_TOL`` (Adam's first step is
    sign-like, so a gradient's error shows in the gradients, not here)."""
    what = "two-rank float64 step"
    loss_err = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    if loss_err > 1e-9:
        raise AssertionError(f"{what}: loss {got['loss']}, one process "
                             f"{ref['loss']}")
    worst_grad, worst_stat = _hold_f64_step(what, ref["grads"], ref["stats"],
                                            got["grads"], got["stats"])
    worst_param = max((got["params"][k].to(p.device) - p).abs().max().item()
                      for k, p in ref["params"].items())
    if worst_param > PAR_PARAM_TOL:
        raise AssertionError(f"{what}: parameters after clip + Adam off by "
                             f"{worst_param:.3g}")
    return {"loss": ref["loss"], "loss_rel_err": loss_err,
            "grad_worst_share_of_tol": worst_grad,
            "bn_worst_share_of_tol": worst_stat,
            "param_max_abs_err": worst_param}


def _hold_gates(torch, dev, batch: int, sides, dtype) -> float:
    """``dsra_gate`` on ``dev`` at a rank's gate shapes (one channel at each
    side) against ``dsra_gate_plain``; the worst error."""
    from pranet2_tpu_torch.ops import dsra

    g = torch.Generator(device=dev).manual_seed(11)
    worst = 0.0
    for s in sides:
        fg, cf, cb = (torch.randn((batch, 1, s, s), generator=g, device=dev,
                                  dtype=dtype) for _ in range(3))
        with torch.no_grad():
            got = dsra.dsra_gate(fg, cf, cb, True)
            want = dsra.dsra_gate_plain(fg, cf, cb, True)
        err = (got.double() - want.double()).abs()
        if dtype == torch.float64:
            ok = err.max() <= F64_GATE_TOL * want.abs().max()
        else:
            tol = GATE_TOL[str(dtype).removeprefix("torch.")]
            ok = (err <= tol + tol * want.double().abs()).all()
        if not bool(ok):
            raise AssertionError(f"dsra_gate on {dev} at {(batch, 1, s, s)} "
                                 f"{dtype}: max {err.max().item()}")
        worst = max(worst, err.max().item())
    return worst


def _par_f32_steps(torch, dev) -> dict:
    """float32 train steps of ``pranet_v2`` at 352 x 352 on this rank's rows
    of a global batch of 8 (the torchrun CLI's step at scale 1, PyTorch's
    default TF32 flags): one warm-up, ``PAR_F32_STEPS`` timed by the host
    clock to a synchronize, then ``PAR_PROFILED_STEPS`` under
    torch.profiler (rank 0's trace read for the gradient all-reduce); the
    launches over all of them, and one all-reduce of a gradient-sized
    buffer timed alone."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from pranet2_tpu_torch import get_model, parallel
    from pranet2_tpu_torch.train import TrainState, make_optimizer
    from pranet2_tpu_torch.train.binary import make_train_step

    model = get_model("pranet_v2", device=dev, num_class=1,
                      generator=torch.Generator().manual_seed(5))
    net = parallel.data_parallel(model)
    state = TrainState(model, make_optimizer(model.parameters(), 1e-4,
                                             clip_value=0.5))
    step = make_train_step(net, target_size=PAR_F32_SIZE, rescale=False)
    g = torch.Generator().manual_seed(7)
    s, n = PAR_F32_SIZE, PAR_F32_BATCH
    x = torch.randn((n, 3, s, s), generator=g)
    gts = (torch.rand((n, 1, s, s), generator=g) > 0.6).float()
    rows = parallel.shard_rows(n, parallel.rank(), parallel.world())
    x, gts = x[rows].to(dev), gts[rows].to(dev)
    _reset_counts()
    _user_flags(torch, lambda: step(state, x, gts))
    torch.cuda.synchronize()
    times = []
    for _ in range(PAR_F32_STEPS):
        t0 = time.perf_counter()
        _user_flags(torch, lambda: step(state, x, gts))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(PAR_PROFILED_STEPS):
            _user_flags(torch, lambda: step(state, x, gts))
        torch.cuda.synchronize()
    launches = _launch_counts()
    # the backend's all-reduce events, each from its start to its end on
    # the backend's threads: the gradient buckets (DDP's, overlapping the
    # backward) and SyncBatchNorm's statistics (2C + 1 values at most)
    reduce_events = {"gradient_buckets": [0.0, 0], "batchnorm_stats": [0.0, 0]}
    for e in prof.events():
        if not re.fullmatch(r"(gloo|nccl):all_reduce", e.name):
            continue
        numel = math.prod(e.input_shapes[0]) if e.input_shapes else 0
        kind = "gradient_buckets" if numel > 8192 else "batchnorm_stats"
        reduce_events[kind][0] += e.cpu_time_total / 1e3 / PAR_PROFILED_STEPS
        reduce_events[kind][1] += 1
    n_grad = sum(p.numel() for p in model.parameters() if p.requires_grad)
    flat = torch.zeros(n_grad, device=dev)
    dist.all_reduce(flat)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist.all_reduce(flat)
    torch.cuda.synchronize()
    alone = (time.perf_counter() - t0) * 1e3
    step_ms = statistics.median(times)
    allreduce_ms = reduce_events["gradient_buckets"][0]
    return {"step_ms": step_ms, "step_ms_all": times,
            "rank_img_per_s": (rows.stop - rows.start) / step_ms * 1e3,
            "global_img_per_s": n / step_ms * 1e3,
            "grad_mb": 4 * n_grad / 1e6,
            "profiled_allreduce_ms_per_step": allreduce_ms,
            "allreduce_share": allreduce_ms / step_ms,
            "allreduce_events_ms_calls": reduce_events,
            "allreduce_alone_ms": alone,
            "launches": launches,
            "gate_err": _hold_gates(torch, dev, n // parallel.world(),
                                    (s // 32, s // 16, s // 8),
                                    torch.float32)}


def _par_rank(devices) -> dict:
    """One spawned rank of the two-rank check, in the group: the float64
    step on its rows and the float32 steps, and the gate kernel held at
    its shapes.  Returns its counts and timings; rank 0 also its float64
    step, for the caller to hold against one process."""
    import torch
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device(devices[rank])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f64 = _par_f64_step(torch, dev)
    if f64["kind"] != "DistributedDataParallel":
        raise AssertionError(f"rank {rank}: the model is {f64['kind']}")
    f64_gate_err = _hold_gates(
        torch, dev, PAR_F64_BATCH // world,
        (PAR_F64_SIZE // 32, PAR_F64_SIZE // 16, PAR_F64_SIZE // 8),
        torch.float64)
    summary = {"rank": rank, "device": str(devices[rank]),
               "f64_launches": f64["launches"], "f64_gate_err": f64_gate_err,
               "f32": _par_f32_steps(torch, dev)}
    if rank == 0:
        summary["f64_step"] = {k: f64[k] for k in ("loss", "grads", "stats",
                                                   "params")}
    return summary


def run_ranks(torch, devices) -> list:
    """The two-rank check on ``devices`` (one card twice: gloo; two cards:
    nccl), each rank a spawned process (``parallel.spawn.launch``), rank
    0's float64 step held against the same step taken here, in one
    process on ``devices[0]``; fails if a rank fails, hangs past
    ``PAR_LAUNCH_TIMEOUT_S`` or took another number of gate launches than
    3 a step.  Returns the ranks' summaries."""
    from pranet2_tpu_torch.parallel import spawn

    backend = ("nccl" if len(set(devices)) == len(devices)
               and all(d.startswith("cuda") for d in devices) else "gloo")
    ref = _par_f64_step(torch, torch.device(devices[0]))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = spawn.launch(_par_rank, len(devices), tmp, devices,
                             backend=backend, devices=devices,
                             timeout=PAR_LAUNCH_TIMEOUT_S,
                             rank_timeout=PAR_RANK_TIMEOUT_S)
        wall = time.perf_counter() - t0
    ranks[0]["f64"] = _par_compare(ref, ranks[0].pop("f64_step"))
    steps = 1 + PAR_F32_STEPS + PAR_PROFILED_STEPS
    for r in ranks:
        if (r["f64_launches"]["dsra_gate"] != 3
                or r["f32"]["launches"]["dsra_gate"] != 3 * steps
                or any(v for k, v in {**r["f64_launches"],
                                      **r["f32"]["launches"]}.items()
                       if k != "dsra_gate")):
            raise AssertionError(f"rank {r['rank']}: launches "
                                 f"{r['f64_launches']}, {r['f32']['launches']}")
    ranks[0]["backend"], ranks[0]["wall_s"] = backend, wall
    return ranks


def run_torchrun_cli(np) -> dict:
    """``torchrun --standalone --nproc_per_node 2 -m
    pranet2_tpu_torch.cli.train_binary`` as a user runs it (float32, 352,
    global batch 8, 16 training images, two epochs: 12 steps, the in-loop
    evaluation on 8 more each epoch): exit 0, every log line from rank 0
    (``--tee 3`` prefixes each with its rank), one snapshot set; ms a step
    from the second epoch's line."""
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as root:
        write_polyp_set(np, os.path.join(root, "TrainDataset"),
                        PAR_CLI_TRAIN, seed=21)
        write_polyp_set(np, os.path.join(root, "TestDataset", "SYN"),
                        PAR_CLI_TEST, seed=22)
        snap = os.path.join(root, "snap")
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [here, os.environ.get("PYTHONPATH", "")])}
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "2", "--tee", "3", "--log-dir",
               os.path.join(root, "logs"), "-m",
               "pranet2_tpu_torch.cli.train_binary", "--train_path",
               os.path.join(root, "TrainDataset"), "--test_root",
               os.path.join(root, "TestDataset"), "--eval_datasets", "SYN",
               "--batchsize", str(PAR_F32_BATCH), "--trainsize",
               str(PAR_F32_SIZE), "--epoch", "3", "--snapshot_every", "2",
               "--train_save", snap]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                           text=True, timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode:
            raise AssertionError(f"torchrun train_binary exited "
                                 f"{r.returncode}:\n{r.stdout[-3000:]}\n"
                                 f"{r.stderr[-3000:]}")
        snaps = sorted(os.listdir(snap))
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    by_rank = {}
    for ln in lines:
        m = re.match(r"\[\w*?(\d+)\]:(.*)", ln)
        if m:
            by_rank.setdefault(int(m.group(1)), []).append(m.group(2))
    epochs = [ln for ln in by_rank.get(0, []) if "train img/s" in ln]
    if (set(by_rank) != {0} or len(epochs) != 2
            or snaps != ["best.pt", "epoch_2.pt", "last.pt"]
            or not any("backend gloo" in ln or "backend nccl" in ln
                       for ln in by_rank[0])):
        raise AssertionError(f"torchrun train_binary: lines by rank "
                             f"{by_rank}, snapshots {snaps}")
    img_per_s = float(re.search(r"\(([\d.]+) train img/s", epochs[-1])
                      .group(1))
    return {"wall_s": wall, "lines": by_rank[0], "snapshots": snaps,
            "epoch2_img_per_s": img_per_s,
            "epoch2_ms_per_step": PAR_F32_BATCH / img_per_s * 1e3}


def _emcad_step(torch, dev, convert: bool) -> dict:
    """One EMCAD-B2 float64 train step (9 classes, 224 x 224, batch 6, the
    PVT encoder's drop path on) on the card: its loss, gradients and
    launches; ``convert``: through ``convert_sync_batchnorm`` and
    ``data_parallel`` in the current group."""
    from pranet2_tpu_torch import get_model, parallel
    from pranet2_tpu_torch.train import TrainState, make_optimizer
    from pranet2_tpu_torch.train.multiclass import (MulticlassTrainConfig,
                                                    make_multiclass_train_step)

    cfg = MulticlassTrainConfig(num_classes=EMCAD_CLASSES,
                                img_size=EMCAD_SIZE,
                                batch_size=EMCAD_TRAIN_BATCH)
    model = get_model("emcad", device=dev, num_classes=EMCAD_CLASSES,
                      encoder="pvt_v2_b2",
                      generator=torch.Generator().manual_seed(8)).double()
    net = model
    if convert:
        model = parallel.convert_sync_batchnorm(model)
        net = parallel.data_parallel(model)
        if net is not model:
            raise AssertionError("data_parallel wrapped a world-1 model")
    state = TrainState(model, make_optimizer(
        model.parameters(), cfg.lr, clip_value=None,
        weight_decay=cfg.weight_decay))
    grads = {}
    apply = state.apply_gradients

    def spy():
        grads.update(_grads(model))
        apply()

    state.apply_gradients = spy
    step = make_multiclass_train_step(net, cfg)
    g = torch.Generator().manual_seed(9)
    s = EMCAD_SIZE
    x = torch.randn((EMCAD_TRAIN_BATCH, 1, s, s), generator=g,
                    dtype=torch.float64).to(dev)
    y = torch.randint(0, EMCAD_CLASSES, (EMCAD_TRAIN_BATCH, s, s),
                      generator=g).to(dev)
    _reset_counts()
    state, loss = step(state, x, y)
    torch.cuda.synchronize()
    return {"loss": loss.item(), "grads": grads, "launches": _launch_counts(),
            "sync_bns": sum(type(m).__name__ == "SyncBatchNorm"
                            for m in model.modules())}


def _grad_diff(a, b) -> float:
    if [k for k in a if a[k] is None] != [k for k in b if b[k] is None]:
        raise AssertionError("world-1 step: other parameters have gradients")
    return max((a[k] - b[k]).abs().max().item() for k in a
               if a[k] is not None)


def run_world1_nccl(torch, dev) -> dict:
    """A world-1 NCCL group on the card: the EMCAD-B2 step through
    ``convert_sync_batchnorm`` + ``data_parallel`` (which wraps nothing at
    world 1) against the same step without a group, held within 1e-6 of
    the largest gradient and the loss within 1e-9 relative; and
    ``SyncBatchNorm``'s autograd Function, all-reducing over NCCL, against
    ``F.batch_norm`` (float32, 1e-5 of max).  The step is float64: in
    float32 two runs of it without a group differ by 1.3e-6 to 1.9e-6 of
    the largest gradient (the resizes' backward adds with atomics), so
    1e-6 of max could not tell a fault from that noise."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from pranet2_tpu_torch.parallel.sync_batchnorm import _SyncBatchNormFn

    plain = _emcad_step(torch, dev, convert=False)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            grouped = _emcad_step(torch, dev, convert=True)
            g = torch.Generator(device=dev).manual_seed(10)
            x = torch.randn((EMCAD_TRAIN_BATCH, 64, 56, 56), generator=g,
                            device=dev) * 2 + 1
            dy = torch.randn(x.shape, generator=g, device=dev)
            w, b = (torch.randn(64, generator=g, device=dev)
                    for _ in range(2))
            outs = []
            for fn in ("plain", "sync"):
                xi, wi, bi = (t.clone().requires_grad_() for t in (x, w, b))
                rm, rv = torch.zeros(64, device=dev), torch.ones(64, device=dev)
                y = (F.batch_norm(xi, rm, rv, wi, bi, True, 0.1, 1e-5)
                     if fn == "plain" else _SyncBatchNormFn.apply(
                         xi, wi, bi, rm, rv, 1e-5, 0.1))
                y.backward(dy)
                outs.append((y, xi.grad, wi.grad, bi.grad, rm, rv))
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    fn_err = max(((p - q).abs().max() / p.abs().max()).item()
                 for p, q in zip(*outs))
    if fn_err > 1e-5:
        raise AssertionError(f"SyncBatchNorm's Function over NCCL: "
                             f"{fn_err:.3g} of max from F.batch_norm")
    scale = max(v.abs().max().item() for v in plain["grads"].values())
    diff = _grad_diff(grouped["grads"], plain["grads"])
    if (abs(grouped["loss"] - plain["loss"]) > 1e-9 * abs(plain["loss"])
            or diff > 1e-6 * scale
            or grouped["launches"] != plain["launches"]
            or plain["launches"]["dsra_gate"] != 3 or not grouped["sync_bns"]):
        raise AssertionError(
            f"world-1 NCCL step: loss {grouped['loss']} vs {plain['loss']}, "
            f"gradients {diff:.3g} apart (max {scale:.3g}), launches "
            f"{grouped['launches']} vs "
            f"{plain['launches']}")
    return {"loss": plain["loss"], "grad_max_abs_diff": diff,
            "grad_scale": scale,
            "bit_for_bit": diff == 0.0, "sync_batchnorms": grouped["sync_bns"],
            "function_rel_err": fn_err, "launches": grouped["launches"]}


def _hold_replica_kernels(torch, dev, batch: int) -> float:
    """``stem_pool`` and ``dsra_level`` on a replica's card at its chunk's
    shapes (bf16, 352: the stem map and the three decoder levels) against
    their plain versions; the worst error."""
    from pranet2_tpu_torch.ops import dsra, stem
    from pranet2_tpu_torch.testing import level_excess

    g = torch.Generator(device=dev).manual_seed(12)
    bf = torch.bfloat16
    z = torch.randn((batch, 64, SIZE // 2, SIZE // 2), generator=g,
                    device=dev).to(bf)
    bn = (1 + 0.1 * torch.randn(64, generator=g, device=dev),
          0.1 * torch.randn(64, generator=g, device=dev),
          0.1 * torch.randn(64, generator=g, device=dev),
          0.5 + torch.rand(64, generator=g, device=dev))
    with torch.no_grad():
        if not torch.equal(stem.stem_pool(z, *bn, 1e-5),
                           stem.stem_pool_plain(z, *bn, 1e-5)):
            raise AssertionError(f"stem_pool on {dev} differs from its "
                                 f"plain version")
        worst = 0.0
        for prev, ra, emit in ((44, 11, True), (11, 22, False),
                               (22, 44, False)):
            ts = [torch.randn((batch, 1, s, s), generator=g,
                              device=dev).to(bf) for s in (prev, prev, ra, ra)]
            got = dsra.dsra_level(*ts, (SIZE, SIZE), True, emit)
            want = dsra.dsra_level_plain(*ts, (SIZE, SIZE), True, emit)
            over = level_excess(got, want, (SIZE, SIZE), GATE_TOL["bfloat16"])
            if not over <= 1:
                raise AssertionError(f"dsra_level on {dev} at {prev} -> {ra}:"
                                     f" {over:.3g} times the tolerance")
            worst = max(worst, max((a.float() - b.float()).abs().max().item()
                                   for a, b in zip(got, want)))
    return worst


def run_replicas(torch, np, state_dict, devices) -> dict:
    """``BinaryPredictor(devices=devices)`` (``pranet_v2``, bf16, 352, batch
    16: a chunk a replica) over the synthetic images against the
    one-device predictor: per forward each replica launches ``stem_pool``
    once and ``dsra_level`` 3 times, no other kernel; the bf16 masks equal
    to one device's at the chunk's batch size (the same rows through the
    same convolutions), and reported beside one device's at batch 16
    (cuDNN picks its convolutions by batch size, and bf16 rounds their sums
    apart); the float32 masks of one batch at most one level from one
    device's at batch 16; a batch's forwards timed (CUDA events on the
    first card, every card synchronized) beside one device's; each
    replica's kernels held at its chunk's shapes."""
    from pranet2_tpu_torch.serve import BinaryPredictor

    images = synthetic_images(np, PAR_SERVE_IMAGES)
    kw = dict(batch_size=BATCH, testsize=SIZE, dtype=torch.bfloat16)
    one = BinaryPredictor("pranet_v2", state_dict, device=devices[0], **kw)
    many = BinaryPredictor("pranet_v2", state_dict, devices=devices, **kw)
    try:
        one.warmup()
        many.warmup()
        _reset_counts()
        t0 = time.perf_counter()
        masks = list(many.stream(images))
        for d in many.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        seconds = time.perf_counter() - t0
        launches = _launch_counts()
        forwards = -(-PAR_SERVE_IMAGES // BATCH)
        want = {k: 0 for k in launches}
        want.update(stem_pool=len(devices) * forwards,
                    dsra_level=3 * len(devices) * forwards)
        if launches != want:
            raise AssertionError(f"replicas on {devices}: launches "
                                 f"{launches}, expected {want}")
        chunk = BinaryPredictor("pranet_v2", state_dict, device=devices[0],
                                batch_size=BATCH // len(devices),
                                testsize=SIZE, dtype=torch.bfloat16)
        same = list(chunk.stream(images))
        chunk.close()
        if len(masks) != len(images) or not all(
                np.array_equal(a, b) for a, b in zip(masks, same)):
            raise AssertionError(f"replicas on {devices}: bf16 masks differ "
                                 f"from one device's at the chunk's batch")
        ref = list(one.stream(images))
        diffs = [np.abs(a.astype(np.int32) - b.astype(np.int32))
                 for a, b in zip(masks, ref)]
        worst = max(int(d.max()) for d in diffs)
        mean = max(float(d.mean()) for d in diffs)
        f32 = [BinaryPredictor("pranet_v2", state_dict, batch_size=BATCH,
                               testsize=SIZE, **where)
               for where in ({"device": devices[0]}, {"devices": devices})]
        a, b = (p(images[:BATCH]) for p in f32)
        for p in f32:
            p.close()
        worst_f32 = max(int(np.abs(x.astype(np.int32) - y.astype(np.int32))
                            .max()) for x, y in zip(a, b))
        if worst_f32 > 1:
            raise AssertionError(f"replicas on {devices}: float32 masks "
                                 f"{worst_f32} levels from one device's")
        batch = many._preprocess(images[:BATCH])
        many_ms = time_ms(lambda: _wait(many._launch(batch)), reps=5)
        one_ms = time_ms(lambda: _wait(one._launch(batch)), reps=5)
        errs = [_hold_replica_kernels(torch, d, BATCH // len(devices))
                for d in many.devices]
    finally:
        one.close()
        many.close()
    return {"model": "replicas_" + "_".join(d.replace(":", "") for d in
                                            devices),
            "devices": list(devices), "launches": launches,
            "forwards": forwards, "equal_at_chunk_batch": True,
            "bf16_vs_batch16_max_level_diff": worst,
            "bf16_vs_batch16_worst_image_mean_level_diff": mean,
            "float32_max_level_diff": worst_f32,
            "stream_img_per_s": PAR_SERVE_IMAGES / seconds,
            "batch_ms": many_ms, "one_device_batch_ms": one_ms,
            "kernel_max_abs_err": max(errs)}


def run_reproduce_baseline(torch, np) -> dict:
    """``cli.reproduce_baseline`` as a process on the card (352, float32,
    TF32 off): random ``pranet_v2`` weights as a reference ``.pth``
    (``module.`` keys in a ``state_dict`` container) and as a port ``.pt``
    (``save_params``) over two synthetic sets of 8 images; both give the
    same table, 8 PNGs a set at the masks' sizes, ``parity verdict: PASS``
    at ``--tol_pp 100``, and exit 1 with ``FAIL`` at an unmeetable
    expectation."""
    from PIL import Image

    from pranet2_tpu_torch import get_model
    from pranet2_tpu_torch.utils.checkpoint import save_params

    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "TestDataset")
        for k, ds in enumerate(RB_SETS):
            write_polyp_set(np, os.path.join(data, ds), RB_IMAGES,
                            seed=30 + k)
        sd = get_model("pranet_v2", device="cpu", num_class=1,
                       generator=torch.Generator().manual_seed(13)
                       ).state_dict()
        os.makedirs(os.path.join(root, "pth"))
        torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
                   os.path.join(root, "pth", "RES-V2.pth"))
        save_params(os.path.join(root, "pt", "pranet_v2.pt"), sd)
        expect = os.path.join(root, "expect.json")
        with open(expect, "w") as f:
            json.dump({"pranet_v2": {"CVC-300": 50.0}}, f)
        tables, walls = {}, {}
        for kind in ("pth", "pt"):
            out, walls[kind] = _cli(
                "reproduce_baseline", "--data_root", data, "--ckpt_dir",
                os.path.join(root, kind), "--models", "pranet_v2",
                "--datasets", *RB_SETS, "--save_root",
                os.path.join(root, f"res_{kind}"), "--expect_json", expect,
                "--tol_pp", "100")
            tables[kind] = [ln for ln in out.splitlines()
                            if ln.startswith("pranet_v2 ")]
            if "parity verdict: PASS" not in out:
                raise AssertionError(f"reproduce_baseline ({kind}): {out}")
            for ds in RB_SETS:
                pngs = sorted(os.listdir(os.path.join(
                    root, f"res_{kind}", "pranet_v2", ds)))
                for p in pngs:
                    a = Image.open(os.path.join(root, f"res_{kind}",
                                                "pranet_v2", ds, p))
                    m = Image.open(os.path.join(data, ds, "masks", p))
                    if a.size != m.size:
                        raise AssertionError(f"{ds}/{p}: {a.size}, mask "
                                             f"{m.size}")
                if len(pngs) != RB_IMAGES:
                    raise AssertionError(f"{ds}: {len(pngs)} PNGs")
        # the metric table's rows (model, set, six metrics); the verdict's
        # rows start with the model's name too
        rows = [r for r in map(str.split, tables["pth"]) if len(r) == 8]
        if (tables["pth"] != tables["pt"] or len(rows) != len(RB_SETS)
                or not all(math.isfinite(float(v)) for r in rows
                           for v in r[2:8])):
            raise AssertionError(f"reproduce_baseline tables: {tables}")
        with open(expect, "w") as f:
            json.dump({"pranet_v2": {"CVC-300": 99.9}}, f)
        out, walls["fail"] = _cli(
            "reproduce_baseline", "--data_root", data, "--ckpt_dir",
            os.path.join(root, "pt"), "--models", "pranet_v2", "--datasets",
            *RB_SETS, "--save_root", os.path.join(root, "res_fail"),
            "--expect_json", expect, "--tol_pp", "0.1", expect_rc=1)
        if "parity verdict: FAIL" not in out:
            raise AssertionError(f"reproduce_baseline (FAIL): {out}")
    return {"table": tables["pth"], "wall_s": walls}


def run_parallel(torch, np, dev, card, state_dict) -> tuple[list, dict, dict]:
    """The parallel phase (see the module's docstring).  Returns the
    replicas' serving entries, the ranks' and the world-1 step's launch
    counts by label, and the ``parallel:`` line's record."""
    n_cards = torch.cuda.device_count()
    record, runs = {"card": card}, {}
    t0 = time.perf_counter()
    ranks = run_ranks(torch, ["cuda:0"] * 2)
    record["ranks_one_card"] = ranks
    print("parallel ranks: " + json.dumps(ranks))
    for r in ranks:
        runs[f"ranks_one_card_r{r['rank']}_f64"] = r["f64_launches"]
        runs[f"ranks_one_card_r{r['rank']}_f32"] = r["f32"]["launches"]
    f32 = ranks[0]["f32"]
    print(f"parallel note: 2 ranks on one card ({ranks[0]['backend']}), "
          f"float64 step within {ranks[0]['f64']['loss_rel_err']:.3g} of one "
          f"process; float32 {PAR_F32_SIZE} global batch {PAR_F32_BATCH}: "
          f"{f32['step_ms']:.1f} ms a step, gradient all-reduce "
          f"{f32['profiled_allreduce_ms_per_step']:.1f} ms by the profiler "
          f"({f32['allreduce_alone_ms']:.1f} ms alone) on {card}")
    record["torchrun_cli"] = run_torchrun_cli(np)
    print("parallel torchrun: " + json.dumps(record["torchrun_cli"]))
    record["world1_nccl"] = run_world1_nccl(torch, dev)
    print("parallel world 1: " + json.dumps(record["world1_nccl"]))
    runs["world1_nccl_emcad"] = record["world1_nccl"]["launches"]
    models = [run_replicas(torch, np, state_dict, ["cuda:0"] * 2)]
    record["replicas_one_card"] = models[0]
    if n_cards >= 2:
        record["ranks_two_cards"] = run_ranks(torch, ["cuda:0", "cuda:1"])
        for r in record["ranks_two_cards"]:
            runs[f"ranks_two_cards_r{r['rank']}_f64"] = r["f64_launches"]
            runs[f"ranks_two_cards_r{r['rank']}_f32"] = r["f32"]["launches"]
        models.append(run_replicas(torch, np, state_dict,
                                   ["cuda:0", "cuda:1"]))
        record["replicas_two_cards"] = models[-1]
    else:
        record["two_cards"] = "skipped (1 card)"
        print("parallel note: two cards: skipped (1 card)")
    record["reproduce_baseline"] = run_reproduce_baseline(torch, np)
    record["phase_s"] = time.perf_counter() - t0
    return models, runs, record


def _lap(label: str, last: list) -> None:
    """Print the seconds since ``last[0]`` (a phase's command time) and
    restart the clock."""
    now = time.perf_counter()
    print(f"time: {label} {now - last[0]:.1f} s", flush=True)
    last[0] = now


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "pranet2_tpu_torch", "csrc")):
        # an installed copy elsewhere is not the checkout under test
        return fail("run from the repository root: pranet2_tpu_torch/ is "
                    "not beside this script")
    sys.path.insert(0, here)
    try:
        import numpy as np

        from pranet2_tpu_torch.ops import _build
    except ImportError as e:
        return fail(f"the port is not importable here ({e})")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    clock = [time.perf_counter()]
    print(f"built kernels {_build.sources()} in {_build.build():.1f} s")
    dev = torch.device("cuda")
    # the plain versions' float32 convolutions and products in full float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    kernels = [*check_maxpool(torch, dev), *check_gate(torch, dev),
               check_res2_tail(torch, dev), check_bottle2neck(torch, dev),
               check_pvt_mlp(torch, dev), check_sra_attention(torch, dev),
               check_sra_block(torch, dev), check_pvt_block(torch, dev),
               check_dwconv(torch, dev)]
    print("kernels checked against their plain versions")
    _lap("build and kernel checks", clock)

    from pranet2_tpu_torch import get_model

    models, weights = [], {}
    for label, (name, _, _) in PATHS.items():
        if name not in weights:
            weights[name] = get_model(
                name, device="cpu",
                generator=torch.Generator().manual_seed(0)).state_dict()
        state_dict = weights[name]
        model, (batch, logits_bf16) = run_path(torch, np, label, state_dict)
        model.update(check_reference(torch, name, state_dict, batch,
                                     logits_bf16))
        print(f"{label} bf16 {SIZE}x{SIZE} batch {BATCH}: forward "
              f"{model['forward_img_per_s']:.1f} img/s, stream "
              f"{model['stream_img_per_s']:.1f} img/s on {card}")
        print("model: " + json.dumps(model))
        models.append(model)
    _lap("binary serving paths", clock)
    train_runs = run_training(torch, np, dev, card)
    _lap("binary training", clock)
    cli = run_cli(torch, np)
    print("cli: " + json.dumps({"card": card, **cli}))
    print("\n".join(cli["benchmark_table"]))
    _lap("binary CLIs", clock)

    models += [serve_volume_path(torch, np, dev, label, card)
               for label in EMCAD_PATHS]
    _lap("EMCAD volumes", clock)
    train_runs.update(run_multiclass_training(torch, np, dev, card))
    mc_cli = run_multiclass_cli(torch, np)
    print("cli: " + json.dumps({"card": card, **mc_cli}))
    _lap("multiclass training and CLIs", clock)

    # the MaxViT phase: MERIT and MIST served over the volume (Dice only:
    # the EMCAD paths time the full metrics), the rest of the zoo, their
    # training and their CLIs
    models += [serve_volume_path(torch, np, dev, label, card,
                                 full_metrics=False)
               for label in MAXVIT_PATHS]
    models += run_maxvit_forwards(torch, dev, card)
    _lap("MaxViT volumes and forwards", clock)
    train_runs.update(run_maxvit_training(torch, np, dev, card))
    mv_cli = run_maxvit_cli(torch, np)
    print("cli: " + json.dumps({"card": card, **mv_cli}))
    _lap("MaxViT training and CLIs", clock)

    # the parallel phase: two ranks and two replicas on the card
    par_models, par_runs, par = run_parallel(torch, np, dev, card,
                                             weights["pranet_v2"])
    models += par_models
    train_runs.update(par_runs)
    print("parallel: " + json.dumps(par))
    _lap("parallel phase", clock)
    for k in kernels:
        by_path = {m["model"]: m["launches"][k["name"]] for m in models}
        by_path.update({label: counts.get(k["name"], 0)
                        for label, counts in train_runs.items()})
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
    print(f"device traces: {TRACES['sessions']} sessions, "
          f"{TRACES['short']} short and traced again")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

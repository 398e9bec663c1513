#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pranet2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions, then builds every kernel in ``pranet2_tpu_torch/csrc`` with nvcc.
2. Holds each kernel against its plain PyTorch version at the shapes the
   serving path gives it, and times kernel, plain version and, where one
   PyTorch call computes the same function, that call (CUDA events, median).
3. Serves PraNet-V2 (Res2Net-50, full width, random weights from a seed) in
   bf16 at 352x352, batch 16, through ``serve.BinaryPredictor.stream`` over
   seeded synthetic images, with the kernels' launch counters set to 0 just
   before and read just after; times the forward alone (CUDA events), its
   device time by kernel (torch.profiler) and the host stages of one batch;
   then checks the bf16 logits against a float32 forward of the same
   weights, and the GPU's float32 forward against the CPU's (plain
   versions) on a small input.
4. Prints one JSON line of kernel results, then as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device, outside the
repository, or when any check fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores
BATCH, SIZE = 16, 352
N_IMAGES = 40               # batches of 16, 16 and a padded 8
GATE_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
MODEL_TOL = 0.1             # bf16 vs f32 logits, relative to max |f32|
F32_TOL = 1e-3              # GPU f32 vs CPU f32, relative to max |CPU|;
                            # cuDNN may pick Winograd/FFT algorithms


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


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_maxpool(torch, dev) -> dict:
    import torch.nn.functional as F

    from pranet2_tpu_torch.ops import stem

    g = torch.Generator(device=dev).manual_seed(0)
    # the stem's post-BN+ReLU conv3 output
    x = torch.relu(torch.randn((BATCH, 64, SIZE // 2, SIZE // 2), generator=g,
                               device=dev)).to(torch.bfloat16)
    got = stem.max_pool3x3s2(x)
    want = stem.max_pool3x3s2_plain(x)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("maxpool kernel differs from its plain version")
    err = (got.float() - want.float()).abs().max().item()
    b, by = bound_ms(x.numel() * x.element_size()
                     + got.numel() * got.element_size(), 8 * got.numel())
    return {"name": "max_pool3x3s2", "route": "cuda",
            "source": "pranet2_tpu_torch/csrc/maxpool.cu",
            "replaces": "pranet2_tpu/ops/stem.py:106",
            "max_abs_err": err,
            "ms": time_ms(lambda: stem.max_pool3x3s2(x)),
            "plain_ms": time_ms(lambda: stem.max_pool3x3s2_plain(x)),
            "bound_ms": b, "bound_by": by,
            "library_ms": time_ms(lambda: F.max_pool2d(x, 3, 2, 1)),
            "shapes": [{"shape": list(x.shape), "dtype": "bfloat16"}]}


def check_gate(torch, dev) -> dict:
    from pranet2_tpu_torch.ops import dsra

    g = torch.Generator(device=dev).manual_seed(1)
    cases = [((BATCH, 1, s, s), torch.bfloat16, True) for s in (44, 22, 11)]
    cases += [((BATCH, 4, 44, 44), dt, False)
              for dt in (torch.float32, torch.bfloat16)]
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    shapes, worst, by = [], 0.0, "bytes"
    for shape, dt, main_path in cases:
        fg, cf, cb = (torch.randn(shape, generator=g, device=dev).to(dt)
                      for _ in range(3))
        got = dsra.dsra_gate(fg, cf, cb, True)
        want = dsra.dsra_gate_plain(fg, cf, cb, True)
        torch.cuda.synchronize()
        name = str(dt).removeprefix("torch.")
        tol = GATE_TOL[name]
        err = (got.float() - want.float()).abs()
        if not bool((err <= tol + tol * want.float().abs()).all()):
            raise AssertionError(f"gate kernel differs from its plain version "
                                 f"at {shape} {name}: max {err.max().item()}")
        # per element: the difference, max, exp, sum and divide of the
        # softmax twice over, then fg * gate + fg
        b, by = bound_ms(4 * fg.numel() * fg.element_size(), 10 * fg.numel())
        row = {"shape": list(shape), "dtype": name, "main_path": main_path,
               "max_abs_err": err.max().item(),
               "ms": time_ms(lambda: dsra.dsra_gate(fg, cf, cb, True)),
               "plain_ms": time_ms(
                   lambda: dsra.dsra_gate_plain(fg, cf, cb, True)),
               "bound_ms": b}
        shapes.append(row)
        worst = max(worst, row["max_abs_err"])
        if main_path:
            for k in total:
                total[k] += row[k]
    # the entry's times are one forward's worth: the three main-path shapes
    return {"name": "dsra_gate", "route": "cuda",
            "source": "pranet2_tpu_torch/csrc/dsra.cu",
            "replaces": "pranet2_tpu/ops/dsra.py:71",
            "max_abs_err": worst, **total, "bound_by": by,
            "library_ms": None, "shapes": shapes}


def synthetic_images(np, n: int) -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (int(rng.integers(288, 577)),
                                  int(rng.integers(288, 577)), 3),
                         dtype=np.uint8) for _ in range(n)]


def run_main_path(torch, np, state_dict) -> tuple[dict, object]:
    """Serve the synthetic images; count launches over exactly that run."""
    from pranet2_tpu_torch.ops import dsra, stem
    from pranet2_tpu_torch.serve import BinaryPredictor

    images = synthetic_images(np, N_IMAGES)
    pred = BinaryPredictor("pranet_v2", state_dict, batch_size=BATCH,
                           testsize=SIZE, dtype=torch.bfloat16)
    try:
        pred.warmup()
        stem.max_pool3x3s2.launches = 0
        dsra.dsra_gate.launches = 0
        t0 = time.perf_counter()
        masks = list(pred.stream(images))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {"max_pool3x3s2": stem.max_pool3x3s2.launches,
                  "dsra_gate": dsra.dsra_gate.launches}
        forwards = -(-N_IMAGES // BATCH)
        if counts != {"max_pool3x3s2": forwards, "dsra_gate": 3 * forwards}:
            raise AssertionError(f"launches {counts} over {forwards} forwards:"
                                 " expected 1 maxpool and 3 gates each")
        if len(masks) != len(images):
            raise AssertionError(f"{len(masks)} masks for {len(images)} images")
        for im, m in zip(images, masks):
            if m.shape != im.shape[:2] or m.dtype != np.uint8:
                raise AssertionError(f"mask {m.shape} {m.dtype} for image "
                                     f"{im.shape}")
        batch = pred._preprocess(images[:BATCH]).to(pred.device)
        with torch.inference_mode():
            fwd_ms = time_ms(lambda: pred.model(batch), reps=10, rounds=5)
            logits = sum(pred.model(batch)[:4]).float()
            device = device_time(torch, lambda: pred.model(batch))
        return {"launches": counts, "forwards": forwards,
                "stream_img_per_s": N_IMAGES / seconds,
                "forward_ms": fwd_ms,
                "forward_img_per_s": BATCH / fwd_ms * 1e3,
                "host": host_time(pred, images[:BATCH]),
                "device": device}, (batch, logits)
    finally:
        pred.close()


def host_time(pred, chunk) -> dict:
    """Host clock for one batch's decode (thread pool) and post-processing
    (exact mode: float32 logits resized to native size, one image at a
    time), the two host stages of ``BinaryPredictor.stream``."""
    t0 = time.perf_counter()
    batch = pred._preprocess(chunk)
    t1 = time.perf_counter()
    launched = pred._launch(batch)
    launched[1].synchronize()
    t2 = time.perf_counter()
    masks = list(pred._postprocess(launched, chunk))
    t3 = time.perf_counter()
    if len(masks) != len(chunk):
        raise AssertionError(f"{len(masks)} masks for {len(chunk)} images")
    return {"decode_ms_per_batch": (t1 - t0) * 1e3,
            "postprocess_ms_per_batch": (t3 - t2) * 1e3}


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
    ported = sum(ms for k, ms in rows
                 if "maxpool3x3s2" in k or "dsra_gate" in k)
    return {"busy_ms": sum(ms for _, ms in rows), "ported_kernels_ms": ported,
            "top": [{"name": k[:90], "ms": ms} for k, ms in rows[:10]]}


def rel_err(a, b) -> float:
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-6)).item()


def check_reference(torch, state_dict, batch, logits_bf16) -> dict:
    """bf16 serving logits vs float32 on the card (TF32 off); float32 on the
    card (kernels) vs float32 on the CPU (plain versions), small input."""
    from pranet2_tpu_torch import get_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = get_model("pranet_v2", device=batch.device)
    f32.load_state_dict(state_dict)
    f32.eval()
    cpu = get_model("pranet_v2", device="cpu")
    cpu.load_state_dict(state_dict)
    cpu.eval()
    with torch.inference_mode():
        logits = sum(f32(batch)[:4]).float()
        small = batch[:2, :, :64, :64]
        gpu_maps, cpu_maps = f32(small), cpu(small.cpu())
    for t in (logits, logits_bf16):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("non-finite logits")
    out = {"bf16_vs_f32_rel_err": rel_err(logits_bf16, logits),
           "gpu_vs_cpu_f32_rel_err": max(rel_err(g.cpu(), c) for g, c
                                         in zip(gpu_maps, cpu_maps))}
    if out["bf16_vs_f32_rel_err"] > MODEL_TOL:
        raise AssertionError(f"bf16 logits off: {out}")
    if out["gpu_vs_cpu_f32_rel_err"] > F32_TOL:
        raise AssertionError(f"GPU f32 maps off the CPU's: {out}")
    return out


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
    print(f"built kernels {_build.sources()} in {_build.build():.1f} s")
    dev = torch.device("cuda")

    kernels = [check_maxpool(torch, dev), check_gate(torch, dev)]
    print("kernels checked against their plain versions")

    from pranet2_tpu_torch import get_model

    state_dict = get_model("pranet_v2", device="cpu",
                           generator=torch.Generator().manual_seed(0)
                           ).state_dict()
    model, (batch, logits_bf16) = run_main_path(torch, np, state_dict)
    for k in kernels:
        k["launches"] = model["launches"][k["name"]]
    model.update(check_reference(torch, state_dict, batch, logits_bf16))
    print(f"PraNet-V2 bf16 {SIZE}x{SIZE} batch {BATCH}: forward "
          f"{model['forward_img_per_s']:.1f} img/s, stream "
          f"{model['stream_img_per_s']:.1f} img/s on {card}")
    print("model: " + json.dumps(model))
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Inference FPS benchmark across models and batch sizes.

Port of ``pranet2_tpu/cli/benchmark.py``: the reference's Jittor benchmark
protocol (``binary_seg/jittor/MyTest.py:63-123``: timing brackets only the
forward), printed as a table beside the reference README's PyTorch column
(``REFERENCE_FPS``).  Example:

    python -m pranet2_tpu_torch.cli.benchmark --models pranet_v1 pranet_v2

Methodology: five warm-up forwards (the first builds the kernels), then
``--windows`` windows of ``--iters`` forwards each, on the host clock
closed by ``torch.cuda.synchronize``; the best and the median window are
reported.  GFLOP an image come from ``utils.profiling.cost_analysis`` (the
module chain at batch 1), MFU from the card's dense bf16 peak.  A model
that fails is reported, the table is finished, and the command exits 1.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from pranet2_tpu_torch.cli.table import format_table

# the reference README's PyTorch img/s at batch 1/4/8/16
# (binary_seg/jittor/README.md): another setup's numbers, a yardstick for
# the table, not a figure of this card
REFERENCE_FPS = {
    "pranet_v1": (32, 165, 328, 642),
    "pvt_pranet_v1": (28, 138, 261, 541),
    "pranet_v2": (31, 143, 283, 556),
    "pvt_pranet_v2": (29, 130, 241, 493),
}
HEADERS = ["model", "bs", "fps", "fps_median", "gflop_img", "tflops",
           "mfu_pct", "torch_fps", "speedup"]


def bench_model(name: str, batch_sizes, size: int, iters: int, dtype: str,
                windows: int = 3, warmup: int = 5, with_flops: bool = True,
                device=None):
    """Best and median img/s and GFLOP an image of ``name``'s eval forward
    at each batch size: V2 sums its four fg maps, V1 returns its finest
    map, as ``serve.BinaryPredictor`` serves them."""
    from pranet2_tpu_torch.models import get_model
    from pranet2_tpu_torch.serve import head_kwargs, is_v2, served_logits
    from pranet2_tpu_torch.utils.profiling import cost_analysis, fence

    v2 = is_v2(name)
    model = get_model(name, device=device,
                      dtype=torch.bfloat16 if dtype == "bfloat16" else None,
                      **head_kwargs(name)).eval()
    dev = next(model.parameters()).device
    rng = np.random.default_rng(0)

    @torch.inference_mode()
    def fwd(x):
        return served_logits(model(x), v2)

    gflop_img = None
    results = []
    for bs in batch_sizes:
        x = torch.from_numpy(rng.standard_normal(
            (bs, 3, size, size), dtype=np.float32)).to(dev)
        out = None
        for _ in range(max(warmup, 1)):
            out = fwd(x)
        fence(out)
        fps = []
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fwd(x)
            fence(out)
            fps.append(bs * iters / (time.perf_counter() - t0))
        if with_flops and gflop_img is None:
            flops = cost_analysis(model, x)["flops"]
            gflop_img = flops / 1e9 if flops else None
        results.append(dict(best=max(fps), median=statistics.median(fps),
                            gflop_img=gflop_img))
    return results


def table_rows(name: str, batch_sizes, results, peak: float | None):
    """The table's rows (dicts keyed by ``HEADERS``) of one model."""
    ref = REFERENCE_FPS.get(name)
    rows = []
    for bs, r in zip(batch_sizes, results):
        row = dict(model=name, bs=bs, fps=round(r["best"], 1),
                   fps_median=round(r["median"], 1))
        if r["gflop_img"]:
            row["gflop_img"] = round(r["gflop_img"], 1)
            tflops = r["best"] * r["gflop_img"] / 1e3
            row["tflops"] = round(tflops, 1)
            if peak:
                row["mfu_pct"] = round(100 * tflops / peak, 1)
        if ref is not None and bs in (1, 4, 8, 16):
            row["torch_fps"] = ref[(1, 4, 8, 16).index(bs)]
            row["speedup"] = round(r["best"] / row["torch_fps"], 2)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    from pranet2_tpu_torch.device import resolve
    from pranet2_tpu_torch.utils.profiling import device_peak_tflops

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--models", nargs="+",
                   default=["pranet_v1", "pvt_pranet_v1",
                            "pranet_v2", "pvt_pranet_v2"])
    p.add_argument("--batch_sizes", type=int, nargs="+", default=[1, 4, 8, 16])
    p.add_argument("--testsize", type=int, default=352)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--windows", type=int, default=3)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default=None,
                   help="torch device; the CUDA card unless given")
    args = p.parse_args(argv)

    device = resolve(args.device)
    kind, peak = device_peak_tflops(device)
    print(f"device_kind: {kind}"
          + (f"  (peak bf16 ~{peak:.0f} TFLOP/s)" if peak else
             "  (peak unknown — MFU omitted)"))

    rows, failed = [], []
    for name in args.models:
        try:
            res = bench_model(name, args.batch_sizes, args.testsize,
                              args.iters, args.dtype, windows=args.windows,
                              device=device)
        except Exception as e:  # finish the table, then exit non-zero
            print(f"{name}: FAILED ({type(e).__name__}: {e})")
            failed.append(name)
            continue
        rows += table_rows(name, args.batch_sizes, res, peak)
    print(format_table([[r.get(h, "") for h in HEADERS] for r in rows],
                       HEADERS, floatfmt=".1f"))
    if failed:
        print(f"FAILED: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The PyTorch port's PraNet-V2 forward of several checkouts, side by side on
one CUDA GPU: what the stem tail and the decoder tail cost end to end.

    python3 tools/torch_tail_ab.py ROOT [ROOT ...]

For each checkout ROOT in turn (each in a process of its own, so that each
imports its own ``pranet2_tpu_torch`` and builds its own kernels), serves
``pranet_v2`` (Res2Net-50-v1b, random weights from seed 0) in bf16 at
352x352, batch 16, in eval under ``torch.inference_mode`` as the predictor
does, and prints one JSON line: the forward by CUDA events around
back-to-back forwards (``forward_ms``), the host's wall time a forward
ending in a synchronise (``wall_ms``), the device's busy time a forward and
its kernel launches a forward from a torch.profiler trace (``busy_ms``,
``launches``), and the device time a forward of the kernels whose names
hold ``maxpool``, ``stem_pool``, ``dsra``, ``upsample_bilinear2d`` or
``batch_norm`` (``by_kernel``), timed by this repository's
``chip_smoke.py``.  Name a checkout twice, in the order A B B A, to see how
far the card's state moves the numbers.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("maxpool", "stem_pool", "dsra", "upsample_bilinear2d",
         "batch_norm")
FORWARDS = 5


def measure(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import pranet2_tpu_torch
    from pranet2_tpu_torch import get_model

    assert pranet2_tpu_torch.__file__.startswith(os.path.abspath(root)), root
    dev = torch.device("cuda")
    model = get_model("pranet_v2", device=dev, dtype=torch.bfloat16).eval()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((cs.BATCH, 3, cs.SIZE, cs.SIZE), generator=g,
                    device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        fwd = lambda: model(x)
        maps = fwd()
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(m).all()) for m in maps):
            raise AssertionError(f"{root}: non-finite maps")
        forward_ms = cs.time_ms(fwd, reps=10, rounds=5)
        t0 = time.perf_counter()
        for _ in range(FORWARDS):
            fwd()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / FORWARDS
        events = cs._trace(torch, fwd, FORWARDS)
    by_kernel = {}
    for e in events:
        for n in NAMES:
            if n in e.get("name", ""):
                ms = e["dur"] / 1e3 / FORWARDS
                by_kernel[n] = by_kernel.get(n, 0.0) + ms
    print(json.dumps({
        "root": root, "forward_ms": forward_ms, "wall_ms": wall_ms,
        "busy_ms": sum(e.get("dur", 0.0) for e in events) / 1e3 / FORWARDS,
        "launches": len(events) / FORWARDS, "by_kernel": by_kernel}),
        flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        measure(sys.argv[2])
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in sys.argv[1:]:
        rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                              "--one", os.path.abspath(root)])
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())

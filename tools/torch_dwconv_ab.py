#!/usr/bin/env python3
"""The PyTorch port's depthwise 3x3 of several checkouts, side by side on
one CUDA GPU.

    python3 tools/torch_dwconv_ab.py ROOT [ROOT ...]

For each checkout ROOT in turn (each in a process of its own, so that each
imports its own ``pranet2_tpu_torch`` and builds its own kernel), at
PVTv2-b2's four hidden shapes (batch 16) in float32 and bf16: checks the
kernel equal to its plain version, then prints one JSON line a shape with
its time by CUDA events around back-to-back calls (``event_ms``), its
device time from a torch.profiler trace (``device_ms``) and the host's wall
time a call (``host_ms``), timed by this repository's ``chip_smoke.py``.
Name a checkout twice, in the order A B B A, to see how far the card's
state moves the numbers.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from pranet2_tpu_torch.ops import dwconv

    assert dwconv.__file__.startswith(os.path.abspath(root)), dwconv.__file__
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    for dt in (torch.float32, torch.bfloat16):
        for side, d, _, ratio, _, _ in cs.PVT_STAGES:
            c = d * ratio
            x = torch.randn((cs.BATCH, side, side, c), generator=g,
                            device=dev).to(dt)
            w = (torch.randn((3, 3, c), generator=g, device=dev) / 3).to(dt)
            f = lambda: dwconv.depthwise_conv3x3(x, w)
            if not torch.equal(f(), dwconv.depthwise_conv3x3_plain(x, w)):
                raise AssertionError(f"{root}: kernel differs at {side} {dt}")
            print(json.dumps({"root": root, "dtype": str(dt)[6:],
                              "shape": list(x.shape),
                              "event_ms": cs.time_ms(f),
                              "device_ms": cs.kernel_ms(torch, f),
                              "host_ms": cs.host_ms(torch, f)}), flush=True)


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

#!/usr/bin/env python3
"""The PyTorch port's SRA attention kernel (``ops.sra_attention``) of several
checkouts, side by side on one CUDA GPU.

    python3 tools/torch_attn_ab.py ROOT [ROOT ...]

For each checkout ROOT in turn (each in a process of its own, so that each
imports its own ``pranet2_tpu_torch`` and builds its own kernel), at
PVTv2-b2's four stage shapes (batch 16, bf16, Tkv 121): holds the kernel to
its plain version (``testing.excess``), then prints one JSON line a stage
with its time by CUDA events around back-to-back calls (``event_ms``), its
device time from a torch.profiler trace (``device_ms``), and the same two
of the eager chain with SDPA (``chain_ms``, ``chain_device_ms``), timed by
this repository's ``chip_smoke.py``.  Name a checkout twice, in the order
A B B A, to see how far the card's state moves the numbers.
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
    import torch.nn.functional as F

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from pranet2_tpu_torch.ops import pvt_attn
    from pranet2_tpu_torch.testing import excess

    assert pvt_attn.__file__.startswith(os.path.abspath(root)), root
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    dt = torch.bfloat16
    for si, (side, d, nh, _, sr, depth) in enumerate(cs.PVT_STAGES):
        tkv = (side // sr) ** 2
        p = cs._pvt_params(torch, g, dev, dt, {
            "w_ln": (d,), "b_ln": (d,), "wq": (d, d), "bq": (d,),
            "wp": (d, d), "bp": (d,)})
        x = torch.randn((cs.BATCH, side, side, d), generator=g,
                        device=dev).to(dt)
        kv = torch.randn((cs.BATCH, tkv, 2 * d), generator=g,
                         device=dev).to(dt)
        args = (x, p["w_ln"], p["b_ln"], p["wq"], p["bq"], kv, p["wp"],
                p["bp"], nh, 1e-6)
        f = lambda: pvt_attn.sra_attention(*args)
        over = excess(f(), pvt_attn.sra_attention_plain(*args), x,
                      cs.PVT_TOL["bfloat16"])
        if not over <= 1:
            raise AssertionError(f"{root}: stage {si + 1} off, {over}")
        hd = d // nh
        heads = lambda t: t.reshape(cs.BATCH, -1, nh, hd).transpose(1, 2)
        k, v = (heads(t) for t in kv.split(d, dim=-1))
        ln = (p["w_ln"].to(dt), p["b_ln"].to(dt))

        def chain():
            y = F.layer_norm(x, (d,), *ln, 1e-6).reshape(cs.BATCH, -1, d)
            o = F.scaled_dot_product_attention(
                heads(F.linear(y, p["wq"], p["bq"])), k, v)
            return x + F.linear(o.transpose(1, 2).reshape(x.shape),
                                p["wp"], p["bp"])

        print(json.dumps({"root": root, "stage": si + 1,
                          "shape": list(x.shape), "heads": nh,
                          "calls_per_forward": depth, "excess": over,
                          "event_ms": cs.time_ms(f),
                          "device_ms": cs.kernel_ms(torch, f),
                          "chain_ms": cs.time_ms(chain),
                          "chain_device_ms": cs.kernel_ms(torch, chain)}),
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

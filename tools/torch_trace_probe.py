#!/usr/bin/env python3
"""How often torch.profiler loses the device events of a short session, with
and without the idle pad that ``chip_smoke.py`` puts around each session.

    python3 tools/torch_trace_probe.py [PAD_S ...]    (default: 0 0.02 0)

On one CUDA GPU, builds the port's kernels, then for each pad in turn traces
``mlp_block`` at PVTv2-b2's four stage shapes (bf16, batch 16, stats and
final_ln modes) and its library chain, as ``chip_smoke.py``'s
``check_pvt_mlp`` does: per shape, a 20-call and a 5-call session of the
kernel and a 20-call session of the chain, twelve times over.  Prints one
JSON line a pad: the sessions, those of the kernel that came back with no
``mlp_kernel`` event (``kernel_empty``) or with fewer than it launched
(``kernel_short``), chain sessions with no kernel (``chain_empty``),
kernel sessions holding another kernel (``extra``), and the seconds taken.
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(pads: list[float]) -> None:
    sys.path.insert(0, HERE)
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from pranet2_tpu_torch.ops import _build, pvt_mlp

    print(f"built kernels in {_build.build():.1f} s", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    items = []
    for side, d, _, ratio, _, _ in cs.PVT_STAGES:
        c = d * ratio
        p = cs._pvt_params(torch, g, dev, torch.bfloat16, {
            "w_ln": (d,), "b_ln": (d,), "w1": (c, d), "b1": (c,),
            "dw": (c, 1, 3, 3), "dwb": (c,), "w2": (d, c), "b2": (d,),
            "wf_ln": (d,), "bf_ln": (d,)})
        x = torch.randn((cs.BATCH, side, side, d), generator=g,
                        device=dev).to(torch.bfloat16)
        args = (x, p["w_ln"], p["b_ln"], p["w1"], p["b1"], p["dw"],
                p["dwb"], p["w2"], p["b2"], 1e-6)
        ln = (p["w_ln"].to(torch.bfloat16), p["b_ln"].to(torch.bfloat16))

        def chain(x=x, d=d, c=c, p=p, ln=ln):
            y = F.linear(F.layer_norm(x, (d,), *ln, 1e-6), p["w1"], p["b1"])
            y = F.conv2d(y.permute(0, 3, 1, 2), p["dw"], p["dwb"], padding=1,
                         groups=c)
            return x + F.linear(F.gelu(y.permute(0, 2, 3, 1)), p["w2"],
                                p["b2"])

        for kw in ({"stats_eps": 1e-6},
                   {"final_ln": (p["wf_ln"], p["bf_ln"])}):
            items.append((lambda a=args, k=kw: pvt_mlp.mlp_block(*a, **k),
                          chain))
    for pad in pads:
        cs.TRACE_PAD_S = pad
        out = {"pad_s": pad, "sessions": 0, "kernel_empty": 0,
               "kernel_short": 0, "chain_empty": 0, "extra": 0}
        t0 = time.perf_counter()
        for _ in range(12):
            for kernel, chain in items:
                for fn, calls in ((kernel, 20), (chain, 20), (kernel, 5)):
                    events = cs._trace(torch, fn, calls)
                    out["sessions"] += 1
                    if fn is chain:
                        out["chain_empty"] += not events
                        continue
                    n = sum("mlp_kernel" in e.get("name", "") for e in events)
                    out["kernel_empty"] += n == 0
                    out["kernel_short"] += 0 < n < calls
                    out["extra"] += len(events) != n
        out["s"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main([float(a) for a in sys.argv[1:]] or [0.0, 0.02, 0.0])

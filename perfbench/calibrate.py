"""Readings that set a cell's limits: for each seed, in one process, the
program's numbers (set-up, a short window at the cell's own load, the
check) and the control's (the reference at the precision below the
configuration's, in the program's place).  Limits are then set between
the largest program reading and the smallest control reading.

    python3 perfbench/calibrate.py --workload <cell> --seconds 3 \\
        --seeds 101 102 ... [--control-seeds 101 102 103]

prints one JSON line a seed and a summary line.  It needs the card, as
the benchmark does.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell: str, seed: int, seconds: float, control: bool,
             device="cuda", overrides=None) -> dict:
    """One seed's program readings, and with ``control`` the control's."""
    import torch

    from perfbench import harness

    run = harness.Run(cell, seed, seconds, device, overrides=overrides)
    t0 = time.perf_counter()
    run.driver.setup(run)
    t1 = time.perf_counter()
    run.window = run.driver.loop(run, seconds)
    got = run.driver.check(run)
    out = {"seed": seed, "setup_s": t1 - t0,
           "window": {k: v for k, v in run.window.items()
                      if isinstance(v, (int, float))},
           "program": got, "check_s": time.perf_counter() - t1 - seconds}
    if control:
        out["control"] = run.driver.control(run)
        if hasattr(run.driver, "faults"):
            out["faults"] = run.driver.faults(run)
    del run
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    rows = []
    for seed in args.seeds:
        row = readings(args.workload, seed, args.seconds,
                       seed in args.control_seeds)
        rows.append(row)
        print(json.dumps(row), flush=True)
    names = rows[0]["program"].keys()
    summary = {n: {"program_max": max(r["program"][n] for r in rows),
                   "control_min": min((r["control"][n] for r in rows
                                       if "control" in r), default=None)}
               for n in names if n != "failed"}
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

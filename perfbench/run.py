"""The benchmark of the PyTorch / CUDA port (``pranet2_tpu_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell once, from the root of a checkout, on the card this machine
holds, and prints the result as one JSON line, last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` (with
``busy_s`` and ``window_s`` when traced), ``breakdown`` when traced, and
last ``checks``, each number compared beside its limit (also the last
lines of standard error).

It exits non-zero and prints no result where there is no CUDA card or
fewer than the cell asks for, where the program is not in the checkout,
and where JAX, flax or the JAX package were loaded.  Set-up (counted from
the process's start) makes the weights and the traffic from ``--seed`` on
the card, loads the program's kernels (built into the checkout at the
first run) and warms up the cell's own shapes; then the window runs for
``--seconds``; then the program's state is freed and what the window
produced is held to the plain reference under ``perfbench/reference/``.
"""

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def process_start() -> float:
    """The process's start on the perf_counter clock (Linux: from
    /proc/self/stat's start time and the boot-time clock), else the
    moment this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return T_IMPORT


def fail(msg: str, code: int = 2) -> int:
    print(f"perfbench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's caches stay in the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / ".perfbench_cache" / sub)
    sys.path.insert(0, str(ROOT))
    import importlib.util

    spec = importlib.util.find_spec("pranet2_tpu_torch")
    if spec is None or ROOT not in Path(spec.origin).resolve().parents:
        return fail(f"the program (pranet2_tpu_torch) is not in {ROOT}")

    import torch

    from perfbench import harness

    try:
        cell = harness.load_json("workloads", args.workload)
    except FileNotFoundError as e:
        return fail(str(e))
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card and "
                    "does not fall back to the CPU")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"{args.workload} needs {cell['chips']} cards, "
                    f"{torch.cuda.device_count()} present")
    print(f"perfbench: {harness.power_limit()}", file=sys.stderr)
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", t_start)
    found = harness.forbidden_modules()
    if found:
        return fail(f"loaded {found}: the benchmark and the program must "
                    "not load JAX, flax or the JAX package", 3)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

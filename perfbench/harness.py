"""One run of one cell: set-up, the measured window, the traced segment,
the check of what the window produced, and the result's line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by name:

* ``configs/<config>.json``: the model's sizes, its program entry and its
  reference;
* ``traffic/<traffic>.json``: the mix's parameters and the driver that
  generates it (``drivers/<driver>.py``);
* ``workloads/<cell>.json``: the configuration, the traffic, the chips,
  why the cell exists, and the limit of each number its check compares;
* ``metrics/<metric>.json``: a per-layer metric (unit, layer, source, the
  end-to-end metric it moves, its cells) and the reader that takes it
  (``readers/<reader>.py``) with that reader's arguments.

A driver module gives ``setup(run)``, ``loop(run, seconds)`` (returns the
end-to-end values of that stretch) and ``check(run)`` (returns each
number compared); ``control(run)`` (the same numbers with the reference at
a lower precision in the program's place) serves ``calibrate.py``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

from perfbench import tracing

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pranet2_tpu")


def load_json(kind: str, name: str, root: Path = HERE) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = HERE):
    """``<root>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def merge(base: dict, over: dict | None) -> dict:
    """``base`` with ``over``'s keys, nested dicts merged."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = (merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def metrics_of(cell: str, root: Path = HERE) -> dict:
    """The per-layer metrics whose ``workloads`` name ``cell``."""
    out = {}
    for path in sorted((root / "metrics").glob("*.json")):
        with open(path) as f:
            meta = json.load(f)
        if cell in meta.get("workloads", []):
            out[path.stem] = meta
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``pranet2_tpu_torch`` is not
    ``pranet2_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"
    return out.splitlines()[0] if out else "unread"


class Run:
    """The state of one run, shared by the harness, the driver and the
    readers."""

    def __init__(self, cell: str, seed: int, seconds: float, device,
                 root: Path = HERE, overrides: dict | None = None):
        import torch

        self.torch = torch
        self.root = root
        self.name = cell
        ov = overrides or {}
        self.cell = merge(load_json("workloads", cell, root),
                          ov.get("workload"))
        self.config = merge(load_json("configs", self.cell["config"], root),
                            ov.get("config"))
        self.traffic = merge(load_json("traffic", self.cell["traffic"], root),
                             ov.get("traffic"))
        self.driver = load_module("drivers", self.traffic["driver"], root)
        self.metrics = metrics_of(cell, root)
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = torch.device(device)
        self.spans = tracing.Spans()
        self.objects: dict = {}    # program objects the readers may wrap
        self.state: dict = {}      # the driver's own
        self.window: dict = {}     # what the window measured
        self.trace = None          # tracing.Trace of the traced segment
        self.undo: list = []

    def lap(self, what: str) -> None:
        """Print the seconds since the last lap to standard error: the
        set-up's phases."""
        now = time.perf_counter()
        print(f"perfbench: {self.name} {what} "
              f"{now - getattr(self, '_lap', now):.3f} s", file=sys.stderr)
        self._lap = now

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None,
             root: Path = HERE, overrides: dict | None = None) -> dict:
    """One run of ``cell``; returns the result's line as a dict.
    ``t_start`` is the process's start on the perf_counter clock (set-up
    is counted from it); ``device="cpu"`` rehearses at the sizes that
    ``overrides`` gives (nested ``workload``, ``config`` and ``traffic``
    keys)."""
    t_start = time.perf_counter() if t_start is None else t_start
    run = Run(cell, seed, seconds, device, root, overrides)
    run._lap = t_start
    run.lap("set-up: start to harness")
    torch = run.torch
    drv = run.driver
    drv.setup(run)
    readers = {}
    if trace:
        for name, meta in run.metrics.items():
            mod = load_module("readers", meta["reader"], root)
            readers[name] = mod
            if hasattr(mod, "install"):
                mod.install(run, meta.get("args", {}))
    run.sync()
    run.setup_s = time.perf_counter() - t_start
    run.spans.phase = "window"
    run.window = drv.loop(run, run.seconds)
    run.spans.phase = None
    if trace and run.cuda:
        seg = float(run.traffic.get("trace_seconds", 2.0))
        run.spans.phase = "trace"
        run.trace = tracing.traced(torch, lambda: drv.loop(run, seg))
        run.spans.phase = None
    for undo in run.undo:
        undo()
    per_layer = {}
    if trace:
        for name, mod in readers.items():
            meta = run.metrics[name]
            value = mod.read(run, meta.get("args", {}))
            if value is not None:
                per_layer[name] = {"value": value, "unit": meta["unit"]}
    peak = (torch.cuda.max_memory_allocated(run.device) if run.cuda else 0)
    gc.collect()
    checks = drv.check(run)
    limits = run.cell["checks"]
    compared = {k: {"value": checks[k], "limit": limits[k]["limit"]}
                for k in limits}
    attempted = int(run.window["attempted"])
    failed = int(run.window["failed"]) + int(checks.get("failed", 0))
    correct = (attempted > 0 and failed == 0
               and all(v["value"] <= v["limit"] for v in compared.values()))
    if trace:
        metrics = per_layer
    else:
        metrics = {k: {"value": run.window[k], "unit": u}
                   for k, u in run.cell["reports"].items() if k != "setup_s"}
        metrics["setup_s"] = {"value": run.setup_s, "unit": "s"}
    dev = {"platform": "gpu" if run.cuda else run.device.type,
           "kind": (torch.cuda.get_device_name(run.device) if run.cuda
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s()
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.idle_gaps(run.spans)}
    out["checks"] = compared
    return out

"""The harness on the CPU: it loads no JAX, refuses to run without a card,
finds cells, mixes, configurations and metrics by their files alone,
agrees with BENCHMARK.json, keeps the frozen work counts, and its check
catches a broken timed path.

The fault tests drive each cell's set-up, window and check at a tiny size
(``TINY``; the program in float32, whose sound readings are near zero)
with the timed path broken underneath, and see ``correct`` come out
false: once for each fault the cell can have (an answer altered where it
is produced; half of the batch left out; for training also a step that
leaves its state unchanged).  A sound run of the same size comes out
true.
"""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench import harness, work  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2 ** 31 + 7

# every cell at a size the CPU runs in seconds, its program in float32
F32 = {"input_size": 64, "serve_dtype": "float32"}
TINY = {
    "pranet_v2.serve": {"config": F32, "traffic": {
        "pool": 8, "batch_size": 4, "sample": 5,
        "sets": [{"name": "a", "share": 1, "size": [40, 50]},
                 {"name": "b", "share": 1,
                  "size_range": [[30, 30], [70, 90]]}]}},
    "pranet_v2.video": {"config": F32, "traffic": {
        "pool": 3, "sample": 2,
        "sets": [{"name": "a", "share": 1, "size": [60, 80]}]}},
    "pvt_pranet_v2.forward": {"config": F32, "traffic": {
        "batch_size": 2, "batches": 2}},
    "pranet_v2.train": {"config": {"input_size": 64}, "traffic": {
        "set_size": 8, "batch_size": 2, "trainsize": 64}},
}


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _python(code: str, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_nothing_loads_jax():
    """run.py, the harness, every driver, reader and the reference load no
    module whose top-level name is jax, jaxlib, flax or pranet2_tpu
    (compared whole: pranet2_tpu_torch is the program)."""
    code = """
import sys, json
sys.path.insert(0, ".")
import perfbench.run, perfbench.harness, perfbench.calibrate
from perfbench import harness
from pathlib import Path
for kind in ("drivers", "readers"):
    for p in sorted((harness.HERE / kind).glob("*.py")):
        harness.load_module(kind, p.stem)
import pranet2_tpu_torch.serve, pranet2_tpu_torch.train.binary
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    p = _python(code)
    assert p.returncode == 0, p.stderr
    top = set(json.loads(p.stdout.splitlines()[-1]))
    assert "pranet2_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "pranet2_tpu"}


def test_reference_imports_nothing_of_the_program():
    code = """
import sys, json
sys.path.insert(0, ".")
import perfbench.reference.pranet, perfbench.reference.serve
import perfbench.reference.train, perfbench.work, perfbench.weights
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    p = _python(code)
    assert p.returncode == 0, p.stderr
    top = set(json.loads(p.stdout.splitlines()[-1]))
    assert not top & {"pranet2_tpu_torch", "pranet2_tpu", "jax", "flax"}


def test_refuses_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "pranet_v2.serve", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_refuses_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    files gives no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for path in BENCH["paths"]:
        shutil.copytree(ROOT / path, tmp_path / path,
                        ignore=shutil.ignore_patterns("__pycache__"))
    env = {**os.environ, "PYTHONPATH": ""}
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "pranet_v2.serve", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_matches_the_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        cfg = harness.load_json("configs", c["name"])
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert c["reduced"] == cfg["reduced"]
        assert NAME.match(c["name"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell = harness.load_json("workloads", w["name"])
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
            cell["config"], cell["traffic"], cell["chips"], cell["why"])
        harness.load_json("traffic", cell["traffic"])
        for name, unit in cell["reports"].items():
            assert e2e[name]["unit"] == unit
            assert w["name"] in e2e[name].get("workloads", [w["name"]])
    for m in BENCH["per_layer"]:
        meta = harness.load_json("metrics", m["name"])
        for k in ("unit", "better", "source", "layer", "moves", "workloads"):
            assert m[k] == meta[k], (m["name"], k)
        assert (ROOT / "perfbench" / "readers"
                / f"{meta['reader']}.py").is_file()
        for cell in m["workloads"]:
            reports = harness.load_json("workloads", cell)["reports"]
            assert m["moves"] in reports, (m["name"], cell)
    # every metric a declared cell's files name is declared; the files of
    # cells not declared yet (pranet_v2.train) may hold more
    cells = {w["name"] for w in BENCH["workloads"]}
    declared = {m["name"] for m in BENCH["per_layer"]}
    for p in (ROOT / "perfbench" / "metrics").glob("*.json"):
        if cells & set(json.loads(p.read_text())["workloads"]):
            assert p.stem in declared, p.stem


def test_frozen_kernel_bounds():
    """The least times of a PVTv2-b2 forward's 16 ``mlp_block`` and 16
    ``sra_attention`` calls at 352, batch 16, as ``chip_smoke.py`` bounds
    them: 0.2862 ms operations-bound, 0.0836 ms bytes-bound."""
    cfg = harness.load_json("configs", "pvt_pranet_v2_b2")
    mlp = work.forward_bound_s("mlp_block", cfg, 352, 16) * 1e3
    attn = work.forward_bound_s("sra_attention", cfg, 352, 16) * 1e3
    assert round(mlp, 4) == 0.2862 and round(attn, 4) == 0.0836
    st = work.pvt_stages(cfg, 352)
    assert work.bound_s(*work.mlp_block_call(16, st[0], "stats"))[1] == (
        "operations")
    assert work.bound_s(*work.sra_attention_call(16, st[0]))[1] == "bytes"
    assert work.forward_calls("mlp_block", cfg) == 16


def test_flop_counts_are_the_reference_s():
    res2 = harness.load_json("configs", "pranet_v2_res2net50")
    fwd = work.flops_per_image(res2, 352, False)
    assert 25e9 < fwd < 27e9
    assert 2.9 < work.flops_per_image(res2, 352, True) / fwd < 3.1


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_added_by_files_alone(tmp_path):
    """A throwaway configuration, mix, cell and metric, added as new files
    in a copy, are found and run, and no file that was there changes."""
    bench = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(bench)
    cfg = json.loads((bench / "configs/pvt_pranet_v2_b2.json").read_text())
    cfg.update(input_size=64, serve_dtype="float32")
    (bench / "configs/tiny_pvt.json").write_text(json.dumps(cfg))
    (bench / "traffic/two_batches.json").write_text(json.dumps({
        "driver": "forward", "batch_size": 2, "batches": 2,
        "trace_seconds": 0.5}))
    (bench / "workloads/tiny_pvt.forward.json").write_text(json.dumps({
        "config": "tiny_pvt", "traffic": "two_batches", "chips": 1,
        "why": "a throwaway cell", "reports": {"forward_img_per_s": "img/s"},
        "checks": {"logit_rel_err": {"limit": 1e-3}}}))
    (bench / "metrics/model.enqueue_ms.tiny.json").write_text(json.dumps({
        "reader": "hook_ms", "args": {"target": "model", "span": "enqueue"},
        "unit": "ms", "better": "lower", "source": "host_clock",
        "layer": "eager model dispatch", "moves": "forward_img_per_s",
        "workloads": ["tiny_pvt.forward"]}))
    assert list(harness.metrics_of("tiny_pvt.forward", bench)) == [
        "model.enqueue_ms.tiny"]
    out = harness.run_cell("tiny_pvt.forward", SEED, 0.5, True, "cpu",
                           root=bench)
    assert out["correct"] and out["attempted"] > 0
    assert out["metrics"]["model.enqueue_ms.tiny"]["value"] > 0
    after = _digest(bench)
    assert {k: after[k] for k in before} == before


def _run(cell, trace=False):
    return harness.run_cell(cell, SEED, 0.5, trace, "cpu",
                            overrides=TINY[cell])


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell):
    out = _run(cell, trace=True)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["metrics"], "a traced run reads per-layer metrics"


def _alter_masks(monkeypatch):
    """Every mask altered where it is produced: the export's sigmoid
    dropped (min-max of the raw logits)."""
    from pranet2_tpu_torch import serve

    monkeypatch.setattr(serve, "expit", lambda x: x)


def _half_batch_serve(monkeypatch):
    from pranet2_tpu_torch import serve

    pre = serve.BinaryPredictor._preprocess

    def half(self, chunk):
        batch = pre(self, chunk)
        batch[len(batch) // 2:] = 0
        return batch

    monkeypatch.setattr(serve.BinaryPredictor, "_preprocess", half)


def _one_slot_serve(monkeypatch):
    """The last row of every batch given an empty frame: a fault confined
    to one batch slot."""
    from pranet2_tpu_torch import serve

    pre = serve.BinaryPredictor._preprocess

    def last_row(self, chunk):
        batch = pre(self, chunk)
        batch[len(chunk) - 1] = 0
        return batch

    monkeypatch.setattr(serve.BinaryPredictor, "_preprocess", last_row)


def _alter_logits(monkeypatch):
    """Each image given its neighbour's answer (the batch's rows rolled by
    one where the maps are produced)."""
    from pranet2_tpu_torch.models import pranet

    fwd = pranet.PraNetV2.forward

    def altered(self, x):
        return tuple(torch.roll(o, 1, dims=0) for o in fwd(self, x))

    monkeypatch.setattr(pranet.PraNetV2, "forward", altered)


def _half_batch_forward(monkeypatch):
    from pranet2_tpu_torch.models import pranet

    fwd = pranet.PraNetV2.forward

    def half(self, x):
        h = x.shape[0] // 2
        outs = fwd(self, x[:h])
        return tuple(torch.cat([o, o]) for o in outs)

    monkeypatch.setattr(pranet.PraNetV2, "forward", half)


def _state_unchanged(monkeypatch):
    from pranet2_tpu_torch.train import state

    def frozen(self):
        self.optimizer.zero_grad()
        self.step += 1

    monkeypatch.setattr(state.TrainState, "apply_gradients", frozen)


def _half_batch_train(monkeypatch):
    from pranet2_tpu_torch.train import binary

    loss = binary.train_loss

    def half(model, images, gts, compute_dtype=None):
        h = images.shape[0] // 2
        return loss(model, images[:h], gts[:h], compute_dtype)

    monkeypatch.setattr(binary, "train_loss", half)


def _alter_loss(monkeypatch):
    from pranet2_tpu_torch.train import binary

    loss = binary.train_loss

    def altered(model, images, gts, compute_dtype=None):
        total, parts = loss(model, images, gts, compute_dtype)
        return total * 1.01, parts

    monkeypatch.setattr(binary, "train_loss", altered)


FAULTS = {
    "pranet_v2.serve": [_alter_masks, _half_batch_serve, _one_slot_serve],
    "pranet_v2.video": [_alter_masks],
    "pvt_pranet_v2.forward": [_alter_logits, _half_batch_forward],
    "pranet_v2.train": [_state_unchanged, _half_batch_train, _alter_loss],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items()
                                        for f in fs],
                         ids=lambda v: getattr(v, "__name__", v))
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["pranet_v2.serve", "pranet_v2.video"])
def test_sample_covers_every_batch_slot(cell):
    """The served masks checked after the window: the largest frame, and
    every batch slot as often as the traffic's ``sample`` allows."""
    from perfbench.drivers import serve

    run = harness.Run(cell, SEED, 1.0, "cpu")
    t = run.traffic
    sizes = serve.pool_sizes(t)
    run.state.update(pool=[np.zeros((*hw, 3), np.uint8) for hw in sizes],
                     kept=dict.fromkeys(range(len(sizes))))
    picked = serve._sample(run)
    assert len(picked) == len(set(picked)) == t["sample"]
    assert max(sizes[i][0] * sizes[i][1] for i in picked) == max(
        h * w for h, w in sizes)
    per_slot = (t["sample"] - 1) // t["batch_size"]
    counts = np.bincount([i % t["batch_size"] for i in picked],
                         minlength=t["batch_size"])
    assert counts.min() >= per_slot >= 1


def test_trace_reduction():
    """Busy time is the union of the device events inside the window;
    each idle gap is named by the innermost host span open over it."""
    from perfbench.tracing import Spans, Trace

    spans = Spans()
    spans.phase = "trace"
    spans.add("frame", 0.0, 1.0)
    spans.add("postprocess", 0.5, 0.95)
    spans.add("decode", 0.0, 0.1)
    tr = Trace([("a", 0.1, 0.4), ("b", 0.3, 0.5), ("c", 0.9, 1.2)],
               (0.0, 1.0))
    assert tr.busy_intervals() == [(0.1, 0.5), (0.9, 1.0)]
    assert abs(tr.busy_s() - 0.5) < 1e-12
    secs, launches = tr.by_name("a")
    assert launches == 1 and abs(secs - 0.3) < 1e-12
    gaps = tr.idle_gaps(spans)
    assert [g[0] for g in gaps] == ["postprocess", "decode"]
    assert abs(gaps[0][1] - 0.4) < 1e-12

"""The EMCAD cells on the CPU: ``emcad_b2.volume`` and ``emcad_b2.forward``
rehearsed at a tiny size (``TINY``; the program in float32, whose sound
readings are near zero) read ``correct`` true and every per-layer metric
their files name that a CPU run can read; with the timed path broken
underneath (``FAULTS``) they read ``correct`` false; on a program without
the volumetric path's spans the readers read nothing and do not fail.
Also the frozen FLOP count and the padding share at the cell's depths.
"""

import contextlib
import json
import sys
import types
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench import harness, tracing  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2 ** 31 + 19
VOLUME, FORWARD = "emcad_b2.volume", "emcad_b2.forward"
TINY = {
    VOLUME: {"config": {"input_size": 64, "serve_dtype": "float32",
                        "chunk": 2},
             "traffic": {"side": 96, "depths": [5, 3, 7]}},
    FORWARD: {"config": {"input_size": 64, "serve_dtype": "float32"},
              "traffic": {"batch_size": 2, "batches": 2}},
}
# what a CPU run reads: the card's trace and peak are not there
ON_CPU = {VOLUME: ["volume.copyout_wait_ms.volume", "volume.launch_ms.volume",
                   "volume.pad_pct.volume", "volume.zoom_in_ms.volume",
                   "volume.zoom_out_ms.volume"],
          FORWARD: []}
NEW = ["volume.zoom_in_ms.volume", "volume.launch_ms.volume",
       "volume.copyout_wait_ms.volume", "volume.zoom_out_ms.volume",
       "volume.pad_pct.volume", "model.launches.volume",
       "model.launches.emcad_forward", "model.mfu.emcad_forward"]


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _run(cell, trace=False):
    """A rehearsal whose window returns every volume several times: each
    is odd in depth, so its last chunk is padded."""
    return harness.run_cell(cell, SEED, 2.0, trace, "cpu",
                            overrides=TINY[cell])


@pytest.mark.parametrize("cell", [VOLUME, FORWARD])
def test_sound_run_is_correct(cell):
    out = _run(cell, trace=True)
    assert out["correct"], out["checks"]
    assert sorted(out["metrics"]) == ON_CPU[cell]
    for name in ON_CPU[cell]:
        assert out["metrics"][name]["value"] > 0, name


def _shift_rows(monkeypatch):
    """Each chunk's labels shifted by one slice (its rows rolled)."""
    from pranet2_tpu_torch.train import multiclass

    combine = multiclass.combined_logits
    monkeypatch.setattr(multiclass, "combined_logits", lambda outs, mode:
                        torch.roll(combine(outs, mode), 1, dims=0))


def _fg_minus_bg(monkeypatch):
    from pranet2_tpu_torch.train import multiclass

    combine = multiclass.combined_logits
    monkeypatch.setattr(multiclass, "combined_logits",
                        lambda outs, mode: combine(outs, "fg_minus_bg"))


def _padding_rows(monkeypatch):
    """The last chunk's padding rows written into the volume: its zero
    rows put first, where the real rows' labels are taken."""
    from pranet2_tpu_torch.train import multiclass

    def padding_first(arrays, *a, **kw):
        return np.concatenate(arrays[::-1], *a, **kw)

    numpy = types.ModuleType("numpy")  # numpy as the program sees it
    numpy.__dict__.update(np.__dict__, concatenate=padding_first)
    monkeypatch.setattr(multiclass, "np", numpy)


def _zoom_out_order_1(monkeypatch):
    from pranet2_tpu_torch.train import multiclass

    zoom = multiclass.zoom

    def order_1(x, factors, order=3, **kw):
        return zoom(x, factors, order=1 if order == 0 else order, **kw)

    monkeypatch.setattr(multiclass, "zoom", order_1)


def _fg_map_left_out(monkeypatch):
    """The forward's finest fg map (level 1's) zeroed, so the sum leaves
    it out."""
    from pranet2_tpu_torch.models import emcad

    fwd = emcad.EMCADNet.forward

    def three_maps(self, x):
        outs = fwd(self, x)
        return (*outs[:3], torch.zeros_like(outs[3]), *outs[4:])

    monkeypatch.setattr(emcad.EMCADNet, "forward", three_maps)


FAULTS = [(VOLUME, _shift_rows), (VOLUME, _fg_minus_bg),
          (VOLUME, _padding_rows), (VOLUME, _zoom_out_order_1),
          (FORWARD, _fg_map_left_out)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=lambda v: getattr(v, "__name__", v))
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(cell)
    assert not out["correct"], out["checks"]


def test_a_program_without_the_spans_reads_nothing(monkeypatch):
    """The parent's program has EMCAD but neither the volumetric path's
    spans nor EMCAD's ``model.forward``: a traced rehearsal runs through,
    correct, and reads no metric."""
    from pranet2_tpu_torch.models import emcad
    from pranet2_tpu_torch.train import multiclass

    for mod in (multiclass, emcad):
        monkeypatch.setattr(mod, "span",
                            lambda name, key=None: contextlib.nullcontext())
    out = _run(VOLUME, trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"] == {}


@pytest.mark.parametrize("name", ["volume.pad_pct.volume",
                                  "model.launches.volume",
                                  "model.mfu.emcad_forward"])
def test_readers_read_nothing_without_their_source(name):
    meta = harness.load_json("metrics", name)
    mod = harness.load_module("readers", meta["reader"])
    run = SimpleNamespace(spans=tracing.Spans(), undo=[], trace=None,
                          window={"slices": 40, "images": 64,
                                  "elapsed_s": 1.0},
                          config={"chunk": 16}, cuda=False)
    assert mod.read(run, meta["args"]) is None


def test_padding_share_at_the_cell_s_depths():
    """One launch a chunk of 16 over the Synapse depths: 96 padded rows
    of 1664, 5.77%."""
    t = harness.load_json("traffic", "synapse_volumes")
    mod = harness.load_module("readers", "pad_pct")
    run = SimpleNamespace(spans=tracing.Spans(), config={"chunk": 16},
                          window={"slices": sum(t["depths"])})
    run.spans.phase = "window"
    for d in t["depths"]:
        for _ in range(-(-d // 16)):
            run.spans.add("volume.launch", 0.0, 1.0)
    got = mod.read(run, {"span": "volume.launch", "per": "slices"})
    assert sum(t["depths"]) == 1568
    assert got == pytest.approx(100 * 96 / 1664)


def test_flop_count_is_the_reference_s():
    cfg = harness.load_json("configs", "emcad_b2_synapse")
    mod = harness.load_module("readers", "emcad_mfu")
    assert 8.8e9 < mod.flops_per_image(cfg, 224) < 9.0e9


def test_the_new_entries_are_appended():
    """The configuration, the two cells, their end-to-end metrics and the
    eight per-layer metrics, each last in its list and naming only its
    new cell."""
    assert BENCH["configs"][-1]["name"] == "emcad_b2_synapse"
    assert [w["name"] for w in BENCH["workloads"][-2:]] == [VOLUME, FORWARD]
    e2e = {m["name"]: m.get("workloads") for m in BENCH["end_to_end"]}
    assert e2e["serve_img_per_s"][-1] == VOLUME
    assert e2e["forward_img_per_s"][-1] == FORWARD
    assert [m["name"] for m in BENCH["per_layer"][-8:]] == NEW
    for m in BENCH["per_layer"][-8:]:
        cell = VOLUME if m["moves"] == "serve_img_per_s" else FORWARD
        assert m["workloads"] == [cell]
        assert m["name"] in harness.metrics_of(cell)

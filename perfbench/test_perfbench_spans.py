"""The readers of the program's own spans on the CPU: ``program_span_ms``
and ``launches`` on rehearsals of the cells at a tiny size and on a
synthetic trace; a program span names the idle gap it covers; only a
traced run turns the program's recording on, once; a program without
spans reads nothing and does not fail."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench import harness, tracing  # noqa: E402
from pranet2_tpu_torch.utils import profiling  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2 ** 31 + 11

F32 = {"input_size": 64, "serve_dtype": "float32"}
TINY = {
    "pranet_v2.serve": {"config": F32, "traffic": {
        "pool": 8, "batch_size": 4, "sample": 5,
        "sets": [{"name": "a", "share": 1, "size": [40, 50]}]}},
    "pranet_v2.video": {"config": F32, "traffic": {
        "pool": 3, "sample": 2,
        "sets": [{"name": "a", "share": 1, "size": [60, 80]}]}},
    "pranet_v2.train": {"config": {"input_size": 64}, "traffic": {
        "set_size": 8, "batch_size": 2, "trainsize": 64}},
}
SPAN_METRICS = {
    "pranet_v2.serve": ["serve.copyout_wait_ms.serve",
                        "serve.launch_ms.serve", "serve.resize_ms.serve"],
    "pranet_v2.video": ["serve.copyout_wait_ms.video",
                        "serve.launch_ms.video", "serve.resize_ms.video"],
    "pranet_v2.train": ["train.backward_ms.train", "train.forward_ms.train",
                        "train.update_ms.train"],
}
NEW = {"serve.launch_ms.serve": "pranet_v2.serve",
       "serve.launch_ms.video": "pranet_v2.video",
       "serve.copyout_wait_ms.serve": "pranet_v2.serve",
       "serve.copyout_wait_ms.video": "pranet_v2.video",
       "serve.resize_ms.serve": "pranet_v2.serve",
       "serve.resize_ms.video": "pranet_v2.video",
       "model.launches.forward": "pvt_pranet_v2.forward",
       "model.launches.video": "pranet_v2.video"}


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def recordings(monkeypatch):
    """Counts the program's ``recording`` sessions entered."""
    entered = []
    real = profiling.recording

    def counted(sink):
        entered.append(sink)
        return real(sink)

    monkeypatch.setattr(profiling, "recording", counted)
    return entered


def _reader(name):
    return harness.load_module("readers", name)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_span_metrics_read_on_a_rehearsal(cell, recordings):
    """A traced rehearsal reads every program-span metric of the cell as a
    positive number, from one recording session, closed at the end."""
    out = harness.run_cell(cell, SEED, 2.0, True, "cpu",
                           overrides=TINY[cell])
    assert out["correct"], out["checks"]
    for name in SPAN_METRICS[cell]:
        assert out["metrics"][name]["value"] > 0, name
        assert out["metrics"][name]["unit"] == "ms"
    assert len(recordings) == 1
    assert profiling.span("x") is profiling.span("y")  # recording is off


def test_untraced_run_installs_no_sink(recordings):
    cell = "pranet_v2.video"
    out = harness.run_cell(cell, SEED, 2.0, False, "cpu",
                           overrides=TINY[cell])
    assert out["correct"] and recordings == []
    assert set(out["metrics"]) == {"frame_ms_p95", "setup_s"}


def _run(window=None, trace=None):
    return SimpleNamespace(spans=tracing.Spans(), undo=[], trace=trace,
                           window=window or {})


def test_program_span_ms_reads_the_window_only():
    run = _run({"images": 4})
    _reader("program_span_ms").install(run, {})
    _reader("launches").install(run, {})  # the same sink: not twice
    assert len(run.undo) == 1
    for phase in (None, "window", "trace"):
        run.spans.phase = phase
        with profiling.span("serve.resize", 0):
            pass
    run.spans.phase = None
    run.undo[0]()
    secs, count = run.spans.total("serve.resize")
    assert count == 1 and run.spans.total("serve.resize", "trace")[1] == 1
    got = _reader("program_span_ms").read(
        run, {"span": "serve.resize", "per": "images"})
    assert got == pytest.approx(secs * 1e3 / 4)
    assert _reader("program_span_ms").read(
        run, {"span": "serve.launch", "per": "images"}) is None


def test_launches_on_a_synthetic_trace():
    """Device events that start inside the window, over the forwards: the
    one that started before it is left out, the one running past its end
    is counted."""
    events = [("copy", 0.5, 1.2), ("k1", 1.0, 1.1), ("k2", 1.3, 1.4),
              ("k3", 1.5, 1.6), ("k4", 1.8, 2.3), ("late", 2.5, 2.6)]
    run = _run(trace=tracing.Trace(events, (1.0, 2.0)))
    run.spans.phase = "trace"
    run.spans.add("model.forward", 1.0, 1.2)
    run.spans.add("model.forward", 1.4, 1.6)
    args = {"span": "model.forward"}
    assert _reader("launches").read(run, args) == 2.0
    assert _reader("launches").read(_run(), args) is None
    no_spans = _run(trace=tracing.Trace(events, (1.0, 2.0)))
    assert _reader("launches").read(no_spans, args) is None


def test_a_program_span_names_the_idle_gap():
    """A long idle gap inside the harness's ``postprocess`` that a program
    span covers is named by the program span, the innermost one."""
    run = _run()
    _reader("program_span_ms").install(run, {})
    run.spans.phase = "trace"
    with run.spans.span("postprocess"):
        with profiling.span("serve.copyout_wait", 3):
            pass
        with profiling.span("serve.resize", 3):
            t0 = profiling.time.perf_counter()
            while profiling.time.perf_counter() - t0 < 0.02:
                pass
    run.undo[0]()
    (_, (r0, r1)), = [(n, iv[0]) for n, iv in
                      run.spans.intervals["trace"].items()
                      if n == "serve.resize"]
    trace = tracing.Trace([("k", r0 - 0.01, r0), ("k", r1, r1 + 0.01)],
                          (r0 - 0.01, r1 + 0.01))
    (name, secs), = trace.idle_gaps(run.spans, k=1)
    assert name == "serve.resize" and secs == pytest.approx(r1 - r0)


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """The readers on a program from before the spans: no
    ``profiling.recording``, no span recorded, no metric, no error."""
    monkeypatch.delattr(profiling, "recording")
    run = _run({"images": 4},
               trace=tracing.Trace([("k", 1.1, 1.2)], (1.0, 2.0)))
    _reader("program_span_ms").install(run, {})
    _reader("launches").install(run, {})
    assert run.undo == []
    run.spans.phase = "window"
    with profiling.span("serve.launch", 0):
        pass
    assert _reader("program_span_ms").read(
        run, {"span": "serve.launch", "per": "images"}) is None
    assert _reader("launches").read(run, {"span": "model.forward"}) is None


def test_the_eight_span_metrics_are_declared():
    declared = {m["name"]: m for m in BENCH["per_layer"]}
    names = [m["name"] for m in BENCH["per_layer"]]
    assert names[-8:] == list(NEW)
    for name, cell in NEW.items():
        meta = harness.load_json("metrics", name)
        assert declared[name]["workloads"] == meta["workloads"] == [cell]
        assert meta["reader"] == ("launches" if ".launches." in name
                                  else "program_span_ms")
        assert name in harness.metrics_of(cell)
    for cell, names in SPAN_METRICS.items():
        for name in names:
            meta = harness.load_json("metrics", name)
            assert meta["args"]["span"].split(".")[0] in ("serve", "train")
            assert meta["source"] == "program_span"

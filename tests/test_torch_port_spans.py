"""The port's own spans (``utils.profiling.span``) on the CPU: nothing is
recorded while recording is off, and while it is on the served path, the
model and the train step record each span once per unit of work, keyed
and nested as ``PERF.md`` names them."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from pranet2_tpu_torch import get_model
from pranet2_tpu_torch.serve import BinaryPredictor
from pranet2_tpu_torch.train import TrainState, make_optimizer
from pranet2_tpu_torch.train.binary import make_train_step
from pranet2_tpu_torch.utils import profiling

TESTSIZE, BATCH = 64, 2


@pytest.fixture(scope="module")
def state_dict():
    torch.manual_seed(0)
    return get_model("pranet_v2", device="cpu", num_class=1).state_dict()


def _images(n):
    rng = np.random.default_rng(4)
    return [(rng.random((40 + 7 * i, 50 + 3 * i, 3)) * 255).astype(np.uint8)
            for i in range(n)]


def _predictor(sd, exact_postproc=True):
    return BinaryPredictor("pranet_v2", sd, batch_size=BATCH,
                           testsize=TESTSIZE, exact_postproc=exact_postproc,
                           host_workers=0, device="cpu")


def _recorded(fn):
    """``fn()``'s result and the spans it recorded, as (name, t0, t1,
    parent, key) in the order they ended."""
    spans = []
    with profiling.recording(lambda *s: spans.append(s)):
        out = fn()
    return out, spans


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def test_off_records_nothing_and_masks_match(state_dict, monkeypatch):
    """Off (the default): ``span`` is one shared no-op that never reads
    the clock, and the masks are bit-identical to a recorded run's."""
    pred = _predictor(state_dict)
    images = _images(3)
    assert profiling.span("serve.launch", 0) is profiling.span("x")
    clock = []
    monkeypatch.setattr(profiling.time, "perf_counter",
                        lambda: clock.append(1) or 0.0)
    off = pred(images)
    assert clock == []
    monkeypatch.undo()
    on, spans = _recorded(lambda: pred(images))
    pred.close()
    assert spans
    assert len(off) == len(on) == 3
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("exact_postproc", [True, False])
def test_stream_spans_once_a_batch_keyed(state_dict, exact_postproc):
    """Two and a half batches: ``serve.decode``, ``serve.launch`` and
    ``serve.copyout_wait`` once a batch, ``serve.resize`` once an image,
    each keyed by its batch's number."""
    pred = _predictor(state_dict, exact_postproc)
    images = _images(5)
    masks, spans = _recorded(lambda: list(pred.stream(iter(images))))
    pred.close()
    assert len(masks) == 5
    for name in ("serve.decode", "serve.launch", "serve.copyout_wait"):
        assert [s[4] for s in _named(spans, name)] == [0, 1, 2], name
    assert [s[4] for s in _named(spans, "serve.resize")] == [0, 0, 1, 1, 2]
    for name, t0, t1, parent, _ in spans:
        assert t0 <= t1
        if name.startswith("serve."):
            assert parent is None, name


def test_keys_count_on_across_calls(state_dict):
    """The key is the predictor's batch number, not the call's."""
    pred = _predictor(state_dict)
    pred(_images(1))
    _, spans = _recorded(lambda: pred(_images(3)))
    pred.close()
    assert [s[4] for s in _named(spans, "serve.launch")] == [1, 2]


def test_model_forward_once_a_forward_under_launch(state_dict):
    pred = _predictor(state_dict)
    _, spans = _recorded(lambda: pred(_images(5)))
    pred.close()
    launches = _named(spans, "serve.launch")
    forwards = _named(spans, "model.forward")
    assert len(forwards) == len(launches) == 3
    for (_, f0, f1, parent, key), (_, l0, l1, _, _) in zip(forwards,
                                                            launches):
        assert parent == "serve.launch" and key is None
        assert l0 <= f0 <= f1 <= l1


@pytest.mark.parametrize("model_name", ["pranet_v1", "pvt_pranet_v2"])
def test_every_pranet_forward_is_one_span(model_name):
    torch.manual_seed(0)
    kw = {"num_class": 1} if model_name.endswith("_v2") else {}
    model = get_model(model_name, device="cpu", **kw).eval()
    with torch.inference_mode():
        _, spans = _recorded(lambda: model(torch.zeros(1, 3, 64, 64)))
    assert [s[0] for s in spans] == ["model.forward"]
    assert spans[0][3] is None


def test_train_step_phases(state_dict):
    """One step: ``train.forward``, ``train.backward`` and
    ``train.update`` once each and in that order, ``model.forward`` under
    ``train.forward``."""
    model = get_model("pranet_v2", device="cpu", num_class=1)
    model.load_state_dict(state_dict)
    state = TrainState(model, make_optimizer(model.parameters(), 1e-4,
                                             clip_value=0.5))
    step = make_train_step(model, target_size=32, rescale=True)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 3, TESTSIZE, TESTSIZE),
                                             dtype=np.float32))
    gts = torch.from_numpy((rng.random((2, 1, TESTSIZE, TESTSIZE)) > 0.6)
                           .astype(np.float32))
    (state, loss, _), spans = _recorded(lambda: step(state, x, gts))
    assert torch.isfinite(loss) and state.step == 1
    assert [(s[0], s[3]) for s in spans] == [
        ("model.forward", "train.forward"), ("train.forward", None),
        ("train.backward", None), ("train.update", None)]
    ends = [s[2] for s in spans[1:]]
    starts = [s[1] for s in spans[1:]]
    assert all(e <= s for e, s in zip(ends, starts[1:]))


def test_recording_restores_the_state_before_it():
    outer, inner = [], []
    with profiling.recording(lambda *s: outer.append(s[0])):
        with profiling.span("a"):
            with profiling.recording(lambda *s: inner.append(s[0])):
                with profiling.span("b"):
                    pass
        with profiling.span("c"):
            pass
    assert (outer, inner) == (["a", "c"], ["b"])
    assert profiling.span("d") is profiling.span("e")


def test_parent_is_the_span_open_in_the_same_thread():
    got = []

    def other():
        with profiling.span("other"):
            pass

    with profiling.recording(lambda *s: got.append((s[0], s[3]))):
        with profiling.span("main"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()
            with profiling.span("child"):
                pass
    assert sorted(got) == [("child", "main"), ("main", None),
                           ("other", None)]


def test_a_span_closed_by_an_exception_is_recorded():
    got = []
    with profiling.recording(lambda *s: got.append(s[0])):
        with pytest.raises(ValueError):
            with profiling.span("outer"):
                with profiling.span("failed"):
                    raise ValueError
        with profiling.span("after"):
            pass
    assert got == ["failed", "outer", "after"]


def test_trace_holds_the_span_names(state_dict, tmp_path):
    """``profiling.trace``'s Chrome trace holds the served path's spans as
    ranges, and a sink around the session still receives them."""
    pred = _predictor(state_dict)
    got = []
    with profiling.recording(lambda *s: got.append(s[0])):
        with profiling.trace(str(tmp_path / "tb")):
            pred(_images(3))
        after = profiling.span("after")
        with after:
            pass
    pred.close()
    (name,) = os.listdir(tmp_path / "tb")
    with open(tmp_path / "tb" / name) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    spans = {"serve.decode", "serve.launch", "serve.copyout_wait",
             "serve.resize", "model.forward"}
    assert spans <= names
    assert spans <= set(got) and got[-1] == "after"
    assert after.range is None  # ranges end with the session

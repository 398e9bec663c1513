"""The port's EMCAD-B2 and its volumetric path against the benchmark's
plain reference (``perfbench/reference/emcad.py``, ``volume.py``), on the
CPU, float32, with seeded random weights (``perfbench/weights_emcad.py``,
the benchmark's own draw).  Nothing here imports JAX.

* ``EMCADNet`` at PVTv2-b2's widths, 9 classes, one channel, 64 x 64,
  batch 2, eval: every map within 1e-4 of the largest |logit|, the float32
  tolerance of ``test_torch_port_emcad.py`` (summation order only).
* ``make_slice_predictor`` on a seeded 5-slice 96 x 96 volume at patch 64,
  chunk 2 (the last chunk padded): the labels equal the reference's but
  where the reference's two largest logits lie within that tolerance of
  each other (a near tie, which summation order may break either way: 4
  voxels of 46080 here), and vary (at patch 32 the deepest map is 1 x 1
  and some seeds give one label everywhere, which would compare nothing).
* Its spans: ``volume.zoom_in``, ``volume.zoom_out`` and
  ``volume.copyout_wait`` once a volume, ``volume.launch`` once a chunk,
  keyed by the volume's number, one ``model.forward`` under each launch.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.ndimage import zoom

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench import volumes, weights_emcad  # noqa: E402
from perfbench.reference import emcad as ref_emcad  # noqa: E402
from perfbench.reference import volume as ref_volume  # noqa: E402
from pranet2_tpu_torch import get_model  # noqa: E402
from pranet2_tpu_torch.train.multiclass import (  # noqa: E402
    make_slice_predictor)
from pranet2_tpu_torch.utils import profiling  # noqa: E402

SIZE, PATCH, SIDE, DEPTH, CHUNK = 64, 64, 96, 5, 2
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def config():
    with open(ROOT / "perfbench" / "configs" / "emcad_b2_synapse.json") as f:
        return json.load(f)


def _model(config, sd):
    m = get_model("emcad", device="cpu",
                  **config["program"]["model_kwargs"])
    m.load_state_dict(sd)
    return m.eval()


def test_forward_matches_reference(config):
    sd = weights_emcad.make_state_dict(config, 21, "cpu", calib_size=SIZE)
    ref = ref_volume.model(config, sd, "cpu")
    x = volumes.ct_batches(1, 2, SIZE, 22, "cpu")[0]
    with torch.no_grad():
        got = _model(config, sd)(x)
        want = ref(x)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 9, SIZE, SIZE)
        assert (g - w).abs().max() <= TOL * w.abs().max()
    served = ref_emcad.served_logits(want)
    assert (served.argmax(1) != served.argmax(1)[:, :1, :1]).any()


def _predict(config, sd):
    return make_slice_predictor(_model(config, sd), (PATCH, PATCH),
                                config["mode"], CHUNK)


def test_volume_labels_match_reference(config):
    sd = weights_emcad.make_state_dict(config, 23, "cpu", calib_size=PATCH)
    vol = volumes.ct_volumes([DEPTH], SIDE, 24, "cpu")[0]
    got = _predict(config, sd)(vol)
    want = ref_volume.labels(ref_volume.model(config, sd, "cpu"), vol,
                             PATCH, "cpu", batch=CHUNK)
    assert got.dtype == np.int32 and got.shape == vol.shape
    assert len(np.unique(want)) > 1
    # the reference's near ties, at the patch and zoomed back as the labels
    ref = ref_volume.model(config, sd, "cpu")
    x = torch.from_numpy(np.stack([zoom(v, PATCH / SIDE, order=3)
                                   for v in vol])[:, None])
    with torch.no_grad():
        logits = ref_emcad.served_logits(ref(x))
    top2 = logits.topk(2, dim=1).values
    tie = (top2[:, 0] - top2[:, 1] <= TOL * logits.abs().max()).numpy()
    tie = np.stack([zoom(t, SIDE / PATCH, order=0) for t in tie])
    assert ((got == want) | tie).all()
    assert tie.mean() < 1e-3


def test_volume_spans(config):
    sd = weights_emcad.make_state_dict(config, 25, "cpu", calib_size=PATCH)
    vols = volumes.ct_volumes([DEPTH, 2], SIDE, 26, "cpu")
    predict = _predict(config, sd)
    spans = []
    with profiling.recording(lambda *s: spans.append(s)):
        for v in vols:
            predict(v)
    counts = {}
    for name, t0, t1, parent, key in spans:
        assert t0 <= t1
        counts[name, key] = counts.get((name, key), 0) + 1
        if name == "model.forward":
            assert parent == "volume.launch" and key is None
        else:
            assert parent is None, name
    chunks = [-(-v.shape[0] // CHUNK) for v in vols]
    want = {}
    for key, n in enumerate(chunks):
        want.update({("volume.zoom_in", key): 1, ("volume.zoom_out", key): 1,
                     ("volume.launch", key): n,
                     ("volume.copyout_wait", key): 1})
    want["model.forward", None] = sum(chunks)
    assert counts == want
    assert [s[0] for s in spans[:2 + 2 * chunks[0] + 1]] == [
        "volume.zoom_in", *["model.forward", "volume.launch"] * chunks[0],
        "volume.zoom_out", "volume.copyout_wait"]

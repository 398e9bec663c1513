"""Volume driver: the program's volumetric test path,
``train/multiclass.py::make_slice_predictor`` (the function ``test_volumes``
and ``cli/test_multiclass.py`` call), over seeded CT volumes, one caller,
closed loop: each volume is handed over whole and its labels wait for.

Traffic parameters: ``side`` (the slices' H = W), ``depths`` (one volume a
depth), ``sample`` (volumes whose labels are checked), ``trace_seconds``.
The configuration gives the model (``program``), its compute type
(``serve_dtype``), the patch (``input_size``), the combination (``mode``)
and ``chunk``.  The volumes are made on the card (``volumes.ct_volumes``)
and kept on the host; the window cycles them in an order drawn from the
seed.

Reports ``serve_img_per_s``: the slices of the volumes returned in the
window, over the time from its start to the last return.  The window's
``slices`` counts every slice handed over in it, the volume that returned
after the window's end too, as the program's spans cover it.

The check compares the labels the window returned for ``sample`` volumes
(the deepest and the shallowest returned, whose last chunks are padded,
then others drawn from the seed) with ``reference/volume.py``'s labels of
the same volumes.  Two numbers, in percent:

* ``label_mismatch_pct``: the worst slice's share of voxels whose label
  differs from the reference's, slice by slice so that a fault confined
  to a few slices (one chunk's rows, its padding) is not diluted by a
  volume's depth;
* ``label_foreign_pct``: the share, over every voxel of the sample, of
  voxels whose label no reference voxel within three patch pixels carries
  (ceil(3 side / patch) voxels each way in the slice).  Rounding moves
  labels across the boundaries of classes, to a class nearby, which this
  tolerates; a label that does not belong near the voxel at all (a class
  between two others, as a zoom back at order 1 makes along every
  boundary) it does not.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import volumes, weights, weights_emcad
from perfbench.reference import pranet
from perfbench.reference import volume as ref_volume


def setup(run):
    from pranet2_tpu_torch.models import get_model
    from pranet2_tpu_torch.train import multiclass

    t, cfg = run.traffic, run.config
    prog = cfg["program"]
    sd = weights_emcad.make_state_dict(cfg, run.seed, run.device)
    run.lap("set-up: weights")
    vols = volumes.ct_volumes(t["depths"], t["side"],
                              weights.subseed(run.seed, 4), run.device)
    order = np.random.default_rng(weights.subseed(run.seed, 3)).permutation(
        len(vols)).tolist()
    run.lap("set-up: traffic")
    model = get_model(prog["model"], device=run.device,
                      dtype=getattr(torch, cfg["serve_dtype"]),
                      **prog.get("model_kwargs", {}))
    model.load_state_dict(sd)
    model.eval()
    size = cfg["input_size"]
    predict = multiclass.make_slice_predictor(model, (size, size),
                                              cfg["mode"], cfg["chunk"])
    run.lap("set-up: program")
    # warm-up: a full and a padded chunk, both zooms at the traffic's side
    predict(vols[order[0]][:cfg["chunk"] + 1])
    run.sync()
    run.lap("set-up: warm-up")
    run.objects.update(model=model)
    run.state.update(sd=sd, vols=vols, order=order, predict=predict, n=0,
                     kept={})


def loop(run, seconds: float) -> dict:
    st = run.state
    vols, order, predict, kept = st["vols"], st["order"], st["predict"], \
        st["kept"]
    done = slices = handed = failed = 0
    t0 = time.perf_counter()
    deadline, last = t0 + seconds, t0
    while True:
        i = order[st["n"] % len(order)]
        st["n"] += 1
        vol = vols[i]
        labels = predict(vol)
        now = time.perf_counter()
        handed += vol.shape[0]
        if now > deadline:
            break  # returned after the window: not counted
        bad = labels.dtype != np.int32 or labels.shape != vol.shape
        failed += int(bad)
        done += 1
        slices += vol.shape[0]
        last = now
        if run.spans.phase != "trace" and not bad:
            kept.setdefault(i, labels)
    elapsed = last - t0
    return {"serve_img_per_s": slices / elapsed if done else 0.0,
            "attempted": done, "failed": failed, "slices": handed,
            "volumes": done, "elapsed_s": elapsed}


def _sample(run) -> list[int]:
    """The volumes to check among those the window returned: the deepest
    and the shallowest (the first of equals), then the rest in an order
    drawn from the seed, ``sample`` in all."""
    st = run.state
    kept = sorted(st["kept"])
    if not kept:
        return []
    depth = {i: st["vols"][i].shape[0] for i in kept}
    picked = [max(kept, key=lambda i: (depth[i], -i)),
              min(kept, key=lambda i: (depth[i], i))]
    picked = list(dict.fromkeys(picked))
    rest = [i for i in kept if i not in picked]
    rng = np.random.default_rng(weights.subseed(run.seed, 5))
    picked += rng.permutation(rest).tolist()
    return picked[:run.traffic["sample"]]


def mismatch_pct(got: np.ndarray, want: np.ndarray) -> float:
    """The worst slice's share of voxels whose labels differ, in %."""
    return float(100.0 * (got != want).mean(axis=(1, 2)).max())


def foreign_count(got: np.ndarray, want: np.ndarray, classes: int,
                  radius: int, device, rows: int = 16) -> int:
    """Voxels whose label in ``got`` no voxel of ``want`` within ``radius``
    (each way, in the slice) carries; a label outside [0, classes) is
    foreign everywhere."""
    count, k = 0, 2 * radius + 1
    for i in range(0, len(want), rows):
        w = torch.from_numpy(want[i:i + rows]).long().to(device)
        g = torch.from_numpy(got[i:i + rows]).long().to(device)
        near = F.max_pool2d(F.one_hot(w, classes).permute(0, 3, 1, 2)
                            .float(), k, 1, radius)
        valid = (g >= 0) & (g < classes)
        hit = near.gather(1, g.clamp(0, classes - 1)[:, None])[:, 0] > 0
        count += int((~(hit & valid)).sum())
    return count


def _compare(run, got: dict, want: dict) -> dict:
    if not want:
        return {"label_mismatch_pct": float("inf"),
                "label_foreign_pct": float("inf")}  # nothing to compare
    cfg, side = run.config, run.traffic["side"]
    radius = math.ceil(3 * side / cfg["input_size"])
    classes = cfg["program"]["model_kwargs"]["num_classes"]
    foreign = sum(foreign_count(got[i], want[i], classes, radius, run.device)
                  for i in want)
    return {"label_mismatch_pct": max(mismatch_pct(got[i], want[i])
                                      for i in want),
            "label_foreign_pct": 100.0 * foreign / sum(
                w.size for w in want.values())}


def _release(run):
    """Free the program's state before the reference runs."""
    run.state.pop("predict", None)
    run.objects.clear()
    run.sync()
    if run.cuda:
        torch.cuda.empty_cache()


def _reference_labels(run, idx, quant=pranet.identity, order_back=0,
                      vols=None) -> dict:
    st, cfg = run.state, run.config
    vols = st["vols"] if vols is None else vols
    ref = ref_volume.model(cfg, st["sd"], run.device, quant)
    return {i: ref_volume.labels(ref, vols[i], cfg["input_size"],
                                 run.device, cfg["chunk"], order_back)
            for i in idx}


def check(run) -> dict:
    _release(run)
    sample = _sample(run)
    want = _reference_labels(run, sample)
    return {**_compare(run, run.state["kept"], want),
            "failed": 0 if sample else 1}


def control(run) -> dict:
    """The same number with the reference in the program's place at the
    precision below the configuration's ``serve_dtype`` (fp8 for
    bfloat16)."""
    sample = _sample(run)
    want = _reference_labels(run, sample)
    got = _reference_labels(run, sample,
                            pranet.BELOW[run.config["serve_dtype"]])
    return _compare(run, got, want)


def faults(run) -> dict:
    """The check's numbers at the cell's size for three planted faults,
    made on the float32 reference's labels in the program's place: the
    zoom back at order 1, each chunk's rows shifted by one slice, and the
    last chunk's padding rows written into the volume (its real rows given
    the labels of a zero slice)."""
    sample, chunk = _sample(run), run.config["chunk"]
    want = _reference_labels(run, sample)
    order_1 = _reference_labels(run, sample, order_back=1)
    side = run.traffic["side"]
    zero = _reference_labels(run, [0], vols=[np.zeros((1, side, side),
                                                     np.float32)])[0][0]
    shifted, padded = {}, {}
    for i, w in want.items():
        shifted[i] = np.concatenate([np.roll(w[s:s + chunk], 1, axis=0)
                                     for s in range(0, len(w), chunk)])
        padded[i] = w.copy()
        padded[i][len(w) - len(w) % chunk if len(w) % chunk else
                  len(w):] = zero
    return {"zoom_out_order_1": _compare(run, order_1, want),
            "shift_rows": _compare(run, shifted, want),
            "padding_rows": _compare(run, padded, want)}

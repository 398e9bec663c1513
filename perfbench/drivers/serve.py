"""Serving driver: the program's ``BinaryPredictor`` over seeded RGB
frames at native sizes, closed loop.

Traffic parameters (``traffic/<name>.json``):

* ``mode``: ``stream`` (one caller pulls ``BinaryPredictor.stream`` over
  the pool, cycled, as fast as masks return; reports ``serve_img_per_s``)
  or ``frame`` (one caller hands one frame at a time to
  ``BinaryPredictor.__call__`` and waits for its mask; reports
  ``frame_ms_p95``);
* ``batch_size``, ``exact_postproc``: the predictor's (its compute type
  is the configuration's ``serve_dtype``);
* ``pool``: frames in the pool; ``sets``: its sizes, each set a share of
  the pool and either one ``size`` [h, w] or a ``size_range`` [[h0, w0],
  [h1, w1]] drawn from ``size_seed`` (the same sizes for every run seed;
  the seed only orders them and draws the pixels);
* ``sample``: masks held to the reference after the window: the largest
  frame, then the others drawn from the seed in turn from each batch slot
  (the pool index modulo ``batch_size``), so that every slot is checked
  once ``sample`` reaches ``batch_size`` + 1.

The check compares each sampled mask with the reference's mask of the
same frame (``reference/serve.py``): the number is the worst mean
absolute difference in levels.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from perfbench import images, weights
from perfbench.reference import pranet
from perfbench.reference import serve as ref_serve


def pool_sizes(traffic: dict) -> list[tuple[int, int]]:
    """The pool's (h, w) in a fixed order: each set's count by the largest
    remainder of its share, ranges drawn from ``size_seed``."""
    sets, n = traffic["sets"], traffic["pool"]
    total = sum(s["share"] for s in sets)
    exact = [n * s["share"] / total for s in sets]
    counts = [int(e) for e in exact]
    for i in sorted(range(len(sets)), key=lambda i: counts[i] - exact[i])[
            :n - sum(counts)]:
        counts[i] += 1
    rng = np.random.default_rng(traffic.get("size_seed", 0))
    out = []
    for s, c in zip(sets, counts):
        if "size" in s:
            out += [tuple(s["size"])] * c
        else:
            (h0, w0), (h1, w1) = s["size_range"]
            out += [(int(rng.integers(h0, h1 + 1)),
                     int(rng.integers(w0, w1 + 1))) for _ in range(c)]
    return out


def setup(run):
    from pranet2_tpu_torch import serve

    t, cfg = run.traffic, run.config
    sd = weights.make_state_dict(cfg, run.seed, run.device)
    run.lap("set-up: weights")
    sizes = pool_sizes(t)
    order = np.random.default_rng(weights.subseed(run.seed, 3)).permutation(
        len(sizes))
    pool = images.rgb_frames([sizes[i] for i in order],
                             weights.subseed(run.seed, 4), run.device)
    run.lap("set-up: traffic")
    pred = serve.BinaryPredictor(
        cfg["program"]["model"], sd, batch_size=t["batch_size"],
        testsize=cfg["input_size"], dtype=getattr(torch, cfg["serve_dtype"]),
        exact_postproc=t["exact_postproc"], device=run.device,
        model_kwargs=cfg["program"].get("model_kwargs"))
    run.lap("set-up: program")
    # warm-up: the forward at its one shape, then both host stages
    pred.warmup()
    warm = 2 * t["batch_size"]
    if t["mode"] == "stream":
        for _ in itertools.islice(pred.stream(itertools.cycle(pool)), warm):
            pass
    else:
        for i in range(warm):
            pred([pool[i % len(pool)]])
    run.sync()
    run.lap("set-up: warm-up")
    run.objects.update(predictor=pred, model=pred.model)
    run.state.update(sd=sd, pool=pool, pred=pred, n=0, kept={},
                     it=(pred.stream(itertools.cycle(pool))
                         if t["mode"] == "stream" else None))


def _take(run, mask):
    """Book one returned mask against the pool frame it answers."""
    st = run.state
    idx = st["n"] % len(st["pool"])
    st["n"] += 1
    want = st["pool"][idx].shape[:2]
    if mask.dtype != np.uint8 or mask.shape != want:
        return 1
    st["kept"].setdefault(idx, mask)
    return 0


def loop(run, seconds: float) -> dict:
    st = run.state
    failed = count = 0
    lat = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    if run.traffic["mode"] == "stream":
        for mask in st["it"]:
            if time.perf_counter() > deadline:
                _take(run, mask)   # returned after the window: not counted
                break
            failed += _take(run, mask)
            count += 1
        return {"serve_img_per_s": count / seconds, "attempted": count,
                "failed": failed, "images": count}
    pred, pool = st["pred"], st["pool"]
    while True:
        frame = pool[st["n"] % len(pool)]
        a = time.perf_counter()
        with run.spans.span("frame"):
            mask = pred([frame])[0]
        b = time.perf_counter()
        if b > deadline:
            _take(run, mask)
            break
        failed += _take(run, mask)
        lat.append(b - a)
        count += 1
    ms = np.asarray(lat) * 1e3
    return {"frame_ms_p95": float(np.percentile(ms, 95)) if count else 0.0,
            "frame_ms_p50": float(np.percentile(ms, 50)) if count else 0.0,
            "attempted": count, "failed": failed, "images": count}


def _sample(run) -> list[int]:
    """Pool indices to check among the masks the window returned: the
    largest frame, then the rest in an order drawn from the seed, taken in
    turn from each batch slot (a pool index's slot is its remainder by
    ``batch_size``: the window's stream starts at index 0, and the pool
    holds whole batches)."""
    st = run.state
    kept = sorted(st["kept"])
    if not kept:
        return []
    area = {i: st["pool"][i].shape[0] * st["pool"][i].shape[1] for i in kept}
    big = max(kept, key=lambda i: (area[i], -i))
    rng = np.random.default_rng(weights.subseed(run.seed, 5))
    slots: dict[int, list[int]] = {}
    for i in rng.permutation([i for i in kept if i != big]).tolist():
        slots.setdefault(i % run.traffic["batch_size"], []).append(i)
    turns = itertools.zip_longest(*(slots[s] for s in sorted(slots)))
    rest = [i for turn in turns for i in turn if i is not None]
    return [big] + sorted(rest[:run.traffic["sample"] - 1])


def _release(run):
    """Free the program's state before the reference runs."""
    st = run.state
    if st.get("it") is not None:
        st["it"].close()
    st["pred"].close()
    run.sync()
    for k in ("it", "pred"):
        st.pop(k, None)
    run.objects.clear()
    if run.cuda:
        torch.cuda.empty_cache()


def check(run) -> dict:
    st = run.state
    _release(run)
    sample = _sample(run)
    frames = [st["pool"][i] for i in sample]
    want = ref_serve.masks(run.config, st["sd"], frames, run.device)
    gaps = [ref_serve.mask_mad(st["kept"][i], w)
            for i, w in zip(sample, want)]
    return {"mask_mad": max(gaps) if gaps else float("inf"),
            "failed": 0 if sample else 1}


def control(run) -> dict:
    """The same number with the reference in the program's place at the
    precision below the configuration's ``serve_dtype`` (``pranet.BELOW``
    on every product's operands: fp8 for bfloat16)."""
    st = run.state
    sample = _sample(run)
    frames = [st["pool"][i] for i in sample]
    want = ref_serve.masks(run.config, st["sd"], frames, run.device)
    got = ref_serve.masks(run.config, st["sd"], frames, run.device,
                          quant=pranet.BELOW[run.config["serve_dtype"]])
    return {"mask_mad": max(ref_serve.mask_mad(g, w)
                            for g, w in zip(got, want))}

"""Training driver: the program's binary recipe, composed as its
``train()`` composes it (``BatchLoader``, ``DevicePrefetcher``,
``make_optimizer`` at the step-decay schedule, ``TrainState`` and one
``make_train_step`` per scale), on an in-memory seeded set of images and
masks, with one synchronise at the window's end.

The configuration's ``train_dtype`` is the step's precision; only
``float32`` is measured, with TF32 off in cuDNN and cuBLAS (the
reference's precision, and the control's TF32 the one below it).

Traffic parameters: ``batch_size``, ``trainsize``, ``rates``, ``lr``,
``clip``, ``decay_rate``, ``decay_epoch``, ``set_size`` (pairs in the
set), ``warm_batches`` (batches driven in set-up, the first of them
compared with the reference).  Reports ``train_img_per_s``: images times
scales of the steps enqueued in the window, over the window, as the
recipe logs them.

Set-up builds the one training object the window then drives: its first
batch goes through the window's own feed and step calls, and its first
``len(rates)`` updates are held to the reference's (``reference/
train.py``): each update's loss, each leaf's first clamped gradient norm
as Adam's second moment holds it after one update, and each leaf's change
after the last of them.
"""

from __future__ import annotations

import math
import threading
import time

import torch

from perfbench import images, weights
from perfbench.reference import serve as ref_serve
from perfbench.reference import train as ref_train


class Items:
    """The in-memory set; records the order in which items are fetched,
    so that the reference can take the rows of the first batch."""

    def __init__(self, items):
        self.items = items
        self.fetched: list[int] = []
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int):
        with self._lock:
            self.fetched.append(int(i))
        return self.items[i]


def _feed(run):
    """Batches on the device, NCHW, epoch after epoch."""
    from pranet2_tpu_torch.data import DevicePrefetcher

    st = run.state
    while True:
        for images_, gts in DevicePrefetcher(st["loader"], run.device):
            yield (images_.permute(0, 3, 1, 2).contiguous(),
                   gts.permute(0, 3, 1, 2).contiguous())


def setup(run):
    from pranet2_tpu_torch import parallel
    from pranet2_tpu_torch.data import BatchLoader
    from pranet2_tpu_torch.models import get_model
    from pranet2_tpu_torch.train.binary import make_train_step
    from pranet2_tpu_torch.train.optim import (make_optimizer,
                                               step_decay_schedule)
    from pranet2_tpu_torch.train.state import TrainState

    t, cfg = run.traffic, run.config
    prog = cfg["program"]
    if cfg["train_dtype"] != "float32":
        raise ValueError(f"train_dtype {cfg['train_dtype']!r}: only float32 "
                         "training is measured")
    # float32 is float32: PyTorch's own switches turn cuDNN's and cuBLAS's
    # TF32 products off for the program
    run.torch.backends.cudnn.allow_tf32 = False
    run.torch.backends.cuda.matmul.allow_tf32 = False
    sd = weights.make_state_dict(cfg, run.seed, run.device)
    run.lap("set-up: weights")
    data = Items(images.train_set(t["set_size"], t["trainsize"],
                                  weights.subseed(run.seed, 4), run.device))
    run.lap("set-up: traffic")
    model = get_model(prog["model"], device=run.device,
                      **prog.get("head_kwargs", {}),
                      **prog.get("model_kwargs", {}))
    model.load_state_dict(sd)
    net = parallel.data_parallel(model)
    loader = BatchLoader(data, t["batch_size"],
                         seed=weights.subseed(run.seed, 6) % 2 ** 32)
    per_epoch = len(loader) * len(t["rates"])
    schedule = step_decay_schedule(t["lr"], t["decay_rate"],
                                   t["decay_epoch"], per_epoch)
    state = TrainState(model, make_optimizer(model.parameters(), schedule,
                                             clip_value=t["clip"]))
    steps = [make_train_step(net,
                             target_size=ref_train.rate_size(t["trainsize"],
                                                             r),
                             rescale=r != 1.0, seed=run.seed % 2 ** 31)
             for r in t["rates"]]
    run.state.update(sd=sd, data=data, loader=loader, model=model,
                     state=state, steps=steps)
    run.state["feed"] = _feed(run)
    run.lap("set-up: program")
    run.objects.update(model=model)
    names = dict((p, n) for n, p in model.named_parameters())
    prog_out = {"losses": []}
    for b in range(t["warm_batches"]):
        images_, gts = next(run.state["feed"])
        for k, step in enumerate(steps):
            state, loss, _ = step(state, images_, gts)
            if b:
                continue
            prog_out["losses"].append(float(loss))
            if k == 0:
                prog_out["grad_norms"] = _adam_grad_norms(state, names)
        if b == 0:
            prog_out["change_norms"] = {
                n: float((p.detach() - sd[n]).norm())
                for n, p in model.named_parameters()}
            run.state["first_rows"] = list(data.fetched[:t["batch_size"]])
    run.state["program"] = prog_out
    run.lap("set-up: first batches (compared) and warm-up")


def _adam_grad_norms(state, names) -> dict:
    """Each leaf's first gradient as the optimizer got it (clamped), from
    Adam's second moment after one update: v = (1 - b2) g^2."""
    inner = state.optimizer.inner
    b2 = inner.param_groups[0]["betas"][1]
    out = {}
    for p, n in names.items():
        v = inner.state.get(p, {}).get("exp_avg_sq")
        out[n] = None if v is None else math.sqrt(float(v.sum()) / (1 - b2))
    return out


def loop(run, seconds: float) -> dict:
    st = run.state
    steps, feed = st["steps"], st["feed"]
    state = st["state"]
    losses = []
    n = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        with run.spans.span("loader_wait"):
            images_, gts = next(feed)
        for step in steps:
            with run.spans.span("step"):
                state, loss, _ = step(state, images_, gts)
            losses.append(loss)
            n += images_.shape[0]
    run.sync()
    elapsed = time.perf_counter() - t0
    bad = (int((~torch.isfinite(torch.stack(losses))).sum())
           if losses else 0)
    return {"train_img_per_s": n / elapsed, "attempted": len(losses),
            "batches": len(losses) // len(steps),
            "failed": bad, "passes": n, "elapsed_s": elapsed}


def _first_batch(run, rows=None):
    st = run.state
    rows = [st["data"].items[i] for i in st["first_rows"][:rows]]
    x = torch.stack([torch.from_numpy(r[0]) for r in rows])
    y = torch.stack([torch.from_numpy(r[1]) for r in rows])
    return (x.permute(0, 3, 1, 2).contiguous().to(run.device),
            y.permute(0, 3, 1, 2).contiguous().to(run.device))


def _reference(run, lower: bool = False, rows=None) -> dict:
    """The reference's first updates in float32, or with ``lower`` in the
    precision below it (TF32 products), the control; ``rows`` takes only
    the first rows of the batch (a planted fault)."""
    t = run.traffic
    x, y = _first_batch(run, rows)
    with ref_serve.tf32() if lower else ref_serve.no_tf32():
        return ref_train.steps(run.config, run.state["sd"], x, y, t["rates"],
                               t["trainsize"], t["lr"], t["clip"], run.device)


def check(run) -> dict:
    st = run.state
    feed = st.pop("feed", None)
    if feed is not None:
        feed.close()
    for k in ("model", "state", "steps", "loader"):
        st.pop(k, None)
    run.objects.clear()
    run.sync()
    if run.cuda:
        torch.cuda.empty_cache()
    return ref_train.compare(st["program"], _reference(run))


def control(run) -> dict:
    """The same numbers with the reference in TF32 (the precision below
    the configuration's float32) in the program's place."""
    return ref_train.compare(_reference(run, lower=True), _reference(run))


def faults(run) -> dict:
    """The numbers of the faults a training cell can have, planted in the
    reference put in the program's place: half of the batch left out (the
    mean taken over the rest), and a step that leaves its state unchanged
    (no update: every change is 0)."""
    want = _reference(run)
    half = _reference(run, rows=len(run.state["first_rows"]) // 2)
    still = dict(want, change_norms={n: 0.0 for n in want["change_norms"]})
    return {"half_batch": ref_train.compare(half, want),
            "state_unchanged": ref_train.compare(still, want)}

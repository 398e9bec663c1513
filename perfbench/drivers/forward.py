"""Forward driver: the program's model alone on batches already on the
card, forwards enqueued back to back under ``torch.inference_mode`` and
the window closed by one synchronise (the published FPS protocol,
``binary_seg/jittor/MyTest.py:63-123``, over the whole window).

Traffic parameters: ``batch_size``, ``batches`` (seeded batches kept on
the card and cycled); the model's compute type is the configuration's
``serve_dtype``.  Reports ``forward_img_per_s``.

The check holds the served logits (the sum of the four fg maps) of the
last forward of every batch to the float32 reference's: the number is
the worst relative L2 error of an image.
"""

from __future__ import annotations

import time

import torch

from perfbench import images, weights
from perfbench.reference import pranet
from perfbench.reference import serve as ref_serve


def setup(run):
    from pranet2_tpu_torch.models import get_model

    t, cfg = run.traffic, run.config
    prog = cfg["program"]
    sd = weights.make_state_dict(cfg, run.seed, run.device)
    run.lap("set-up: weights")
    model = get_model(prog["model"], device=run.device,
                      dtype=getattr(torch, cfg["serve_dtype"]),
                      **prog.get("head_kwargs", {}),
                      **prog.get("model_kwargs", {}))
    model.load_state_dict(sd)
    model.eval()
    run.lap("set-up: program")
    xs = images.image_batches(t["batches"], t["batch_size"],
                              cfg["input_size"], weights.subseed(run.seed, 4),
                              run.device)
    run.lap("set-up: traffic")
    with torch.inference_mode():
        for x in xs[:2]:
            model(x)
    run.sync()
    run.lap("set-up: warm-up")
    run.objects.update(model=model)
    run.state.update(sd=sd, model=model, xs=xs, i=0, kept={})


def loop(run, seconds: float) -> dict:
    st = run.state
    model, xs, kept = st["model"], st["xs"], st["kept"]
    n = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    with torch.inference_mode():
        while time.perf_counter() < deadline:
            i = st["i"] % len(xs)
            st["i"] += 1
            kept[i] = model(xs[i])
            n += 1
    run.sync()
    elapsed = time.perf_counter() - t0
    b = run.traffic["batch_size"]
    return {"forward_img_per_s": n * b / elapsed, "attempted": n,
            "failed": 0, "images": n * b,
            "elapsed_s": elapsed}


def _served(outs) -> torch.Tensor:
    return sum(o.float() for o in outs[:4])


def _rel_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per image ||got - want|| / ||want||."""
    d = (got.float() - want.float()).flatten(1).norm(dim=1)
    return d / want.float().flatten(1).norm(dim=1).clamp_min(1e-12)


def _reference(run, idx, quant=pranet.identity) -> dict:
    st = run.state
    ref = ref_serve.model(run.config, st["sd"], run.device, quant)
    out = {}
    with ref_serve.no_tf32(), torch.no_grad():
        for i in idx:
            out[i] = pranet.served_logits(ref(st["xs"][i]))
    return out


def check(run) -> dict:
    st = run.state
    got = {i: _served(o) for i, o in st["kept"].items()}
    st["kept"].clear()
    for k in ("model",):
        st.pop(k, None)
    run.objects.clear()
    run.sync()
    if run.cuda:
        torch.cuda.empty_cache()
    want = _reference(run, sorted(got))
    errs = torch.cat([_rel_errors(got[i], want[i]) for i in sorted(want)])
    bad = int((~torch.isfinite(errs)).sum())
    return {"logit_rel_err": float(errs.nan_to_num(float("inf")).max()),
            "failed": bad}


def control(run) -> dict:
    """The same number with the reference in the program's place at the
    precision below the configuration's ``serve_dtype`` (fp8 for
    bfloat16)."""
    idx = range(len(run.state["xs"]))
    want = _reference(run, idx)
    got = _reference(run, idx, pranet.BELOW[run.config["serve_dtype"]])
    errs = torch.cat([_rel_errors(got[i], want[i]) for i in sorted(want)])
    return {"logit_rel_err": float(errs.max())}

"""EMCAD forward driver: the program's multiclass model alone on
one-channel slices already on the card, forwards enqueued back to back
under ``torch.inference_mode`` and the window closed by one synchronise:
``drivers/forward.py``'s window, with EMCAD's weights, inputs and
reference.

Traffic parameters: ``batch_size``, ``batches`` (seeded batches of CT
slices, ``volumes.ct_batches``, kept on the card and cycled); the model's
compute type is the configuration's ``serve_dtype``.  Reports
``forward_img_per_s``.

The check holds the logits the volumetric test scores (the configuration's
``fg_only``: the sum of the four fg maps, in float32) of the last forward
of every batch to the float32 reference's (``reference/emcad.py``): the
number is the worst relative L2 error of an image.
"""

from __future__ import annotations

import torch

from perfbench import volumes, weights, weights_emcad
from perfbench.drivers.forward import _rel_errors, _served, loop  # noqa: F401
from perfbench.reference import emcad, pranet
from perfbench.reference import volume as ref_volume
from perfbench.reference.serve import no_tf32


def setup(run):
    from pranet2_tpu_torch.models import get_model

    t, cfg = run.traffic, run.config
    prog = cfg["program"]
    sd = weights_emcad.make_state_dict(cfg, run.seed, run.device)
    run.lap("set-up: weights")
    model = get_model(prog["model"], device=run.device,
                      dtype=getattr(torch, cfg["serve_dtype"]),
                      **prog.get("model_kwargs", {}))
    model.load_state_dict(sd)
    model.eval()
    run.lap("set-up: program")
    xs = volumes.ct_batches(t["batches"], t["batch_size"], cfg["input_size"],
                            weights.subseed(run.seed, 4), run.device)
    run.lap("set-up: traffic")
    with torch.inference_mode():
        for x in xs[:2]:
            model(x)
    run.sync()
    run.lap("set-up: warm-up")
    run.objects.update(model=model)
    run.state.update(sd=sd, model=model, xs=xs, i=0, kept={})


def _reference(run, idx, quant=pranet.identity) -> dict:
    st = run.state
    ref = ref_volume.model(run.config, st["sd"], run.device, quant)
    out = {}
    with no_tf32(), torch.no_grad():
        for i in idx:
            out[i] = emcad.served_logits(ref(st["xs"][i]))
    return out


def check(run) -> dict:
    st = run.state
    got = {i: _served(o) for i, o in st["kept"].items()}
    st["kept"].clear()
    st.pop("model", None)
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


def faults(run) -> dict:
    """The check's number at the cell's size for a planted fault made on
    the float32 reference in the program's place: each fg map in turn left
    out of the sum (``fg4`` the coarsest)."""
    st = run.state
    ref = ref_volume.model(run.config, st["sd"], run.device)
    errs = {k: [] for k in range(4)}
    with no_tf32(), torch.no_grad():
        for x in st["xs"]:
            maps = ref(x)
            want = emcad.served_logits(maps)
            for k in range(4):
                errs[k].append(_rel_errors(want - maps[k], want))
    return {f"fg{4 - k}_left_out": float(torch.cat(e).max())
            for k, e in errs.items()}

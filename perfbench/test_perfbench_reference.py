"""The benchmark's plain reference against the program, on the CPU at a
small size: the same seeded state dict gives the same logits, masks and
first training update (float32 on both sides)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench import images, weights  # noqa: E402
from perfbench.reference import pranet  # noqa: E402
from perfbench.reference import serve as ref_serve  # noqa: E402
from perfbench.reference import train as ref_train  # noqa: E402

CONFIGS = ("pranet_v2_res2net50", "pvt_pranet_v2_b2")
SIZE = 64


def config(name):
    with open(ROOT / "perfbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def program(cfg, sd, dtype=None):
    from pranet2_tpu_torch.models import get_model

    prog = cfg["program"]
    m = get_model(prog["model"], device="cpu", dtype=dtype,
                  **prog["head_kwargs"], **prog["model_kwargs"])
    m.load_state_dict(sd)
    return m.eval()


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CONFIGS)
def test_state_dict_matches_program(name):
    cfg = config(name)
    sd = weights.make_state_dict(cfg, 11, "cpu", calib_size=SIZE)
    want = program(cfg, sd).state_dict()
    assert list(sd) == list(want)
    assert all(sd[k].shape == want[k].shape for k in sd)
    # the running statistics were drawn, not left at BatchNorm's defaults
    var = [v for k, v in sd.items() if k.endswith("running_var")]
    assert all(not torch.equal(v, torch.ones_like(v)) for v in var)


@pytest.mark.parametrize("name", CONFIGS)
def test_logits_match_program(name):
    cfg = config(name)
    sd = weights.make_state_dict(cfg, 12, "cpu", calib_size=SIZE)
    ref = pranet.build(cfg)
    ref.load_state_dict(sd)
    x = images.image_batches(1, 2, SIZE, 13, "cpu")[0]
    with torch.no_grad():
        got = program(cfg, sd)(x)
        want = ref.eval()(x)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 1, SIZE, SIZE)
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()


def test_masks_match_program():
    from pranet2_tpu_torch.serve import BinaryPredictor

    cfg = config("pranet_v2_res2net50")
    cfg["input_size"] = SIZE
    sd = weights.make_state_dict(cfg, 14, "cpu")
    frames = images.rgb_frames([(40, 50), (77, 31), (64, 64)], 15, "cpu")
    pred = BinaryPredictor("pranet_v2", sd, batch_size=2, testsize=SIZE,
                           device="cpu", host_workers=0)
    got = pred(frames)
    want = ref_serve.masks(cfg, sd, frames, "cpu")
    for g, w, f in zip(got, want, frames):
        assert g.shape == w.shape == f.shape[:2] and g.dtype == np.uint8
        assert ref_serve.mask_mad(g, w) <= 0.01


def test_first_update_matches_program():
    """One update at float64 on both sides (float32 gradients of the
    stem differ by up to 1% here: near-ties in the max pool route them
    differently)."""
    from pranet2_tpu_torch.models import get_model
    from pranet2_tpu_torch.train.binary import make_train_step
    from pranet2_tpu_torch.train.optim import make_optimizer
    from pranet2_tpu_torch.train.state import TrainState

    f64 = torch.float64
    cfg = config("pranet_v2_res2net50")
    sd = {k: (v.to(f64) if v.is_floating_point() else v) for k, v in
          weights.make_state_dict(cfg, 16, "cpu", calib_size=SIZE).items()}
    rows = images.train_set(2, SIZE, 17, "cpu")
    x, y = (torch.stack([torch.from_numpy(r[i]) for r in rows])
            .permute(0, 3, 1, 2).contiguous().to(f64) for i in (0, 1))
    model = get_model("pranet_v2", device="cpu", num_class=1).to(f64)
    model.load_state_dict(sd)
    state = TrainState(model, make_optimizer(model.parameters(), 1e-4, 0.5))
    step = make_train_step(model, target_size=SIZE, rescale=False)
    _, loss, _ = step(state, x, y)
    ref = pranet.build(cfg).to(f64)
    ref.load_state_dict(sd)
    want = ref_train.loss(ref.train(), x, y)
    want.backward()
    want = float(want.detach())
    assert abs(float(loss) - want) <= 1e-9 * want
    grads = {n: p.grad.clamp(-0.5, 0.5).norm().item()
             for n, p in ref.named_parameters() if p.grad is not None}
    med = float(np.median(list(grads.values())))
    inner = state.optimizer.inner
    for n, p in model.named_parameters():
        v = inner.state.get(p, {}).get("exp_avg_sq")
        if n not in grads:
            assert v is None, n
            continue
        got = float((v.sum() / (1 - 0.999)).sqrt())
        assert abs(got - grads[n]) <= 1e-6 * max(grads[n], med), n

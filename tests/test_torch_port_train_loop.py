"""The port's binary training loop end to end on the CPU: the counterparts of
``tests/test_train_binary.py`` (step counts at one and three scales, the
in-loop evaluation, the uint8 export, bf16 with float32 parameters, the
checkpoint round trip, resume equal to an uninterrupted run), the cached
dataset's worker pool and the CLI.

The data is the JAX test's synthetic recipe (``synth_data``): 8 random
48 x 56 RGB images with blob masks, written as PNGs.  Everything runs with
``device="cpu"``, where the kernel wrappers take their plain versions.
"""

import copy
import os

import numpy as np
import pytest
import torch
from PIL import Image

from pranet2_tpu_torch import get_model
from pranet2_tpu_torch.cli import train_binary as cli
from pranet2_tpu_torch.data import CachedDataset, PolypDataset, PolypTestDataset
from pranet2_tpu_torch.evalx import BINARY_METRIC_NAMES
from pranet2_tpu_torch.train import TrainState, make_optimizer
from pranet2_tpu_torch.train.binary import (BinaryTrainConfig,
                                            make_predict_fn, make_train_step,
                                            predict_to_maps, train)
from pranet2_tpu_torch.train.binary import test_with_eval as eval_datasets_fn
from pranet2_tpu_torch.utils.checkpoint import (restore_params,
                                                restore_state, save_params,
                                                save_state)

SIZE = 64


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs files in parallel workers, and
    each worker's default of one thread a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synth_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("polyp")
    for split in ("TrainDataset", "TestDataset/DS1"):
        img_dir = root / split / "images"
        msk_dir = root / split / "masks"
        img_dir.mkdir(parents=True)
        msk_dir.mkdir(parents=True)
        rng = np.random.default_rng(0)
        for i in range(8):
            img = (rng.random((48, 56, 3)) * 255).astype(np.uint8)
            yy, xx = np.mgrid[:48, :56]
            cy, cx = rng.integers(12, 36), rng.integers(12, 44)
            mask = ((yy - cy) ** 2 + (xx - cx) ** 2 < 100).astype(
                np.uint8) * 255
            Image.fromarray(img).save(img_dir / f"{i}.png")
            Image.fromarray(mask).save(msk_dir / f"{i}.png")
    return str(root)


def _cfg(synth_data, **kw):
    return BinaryTrainConfig(**{
        "batch_size": 8, "trainsize": SIZE, "log_every": 1000,
        "train_path": os.path.join(synth_data, "TrainDataset"),
        "device": "cpu", **kw})


@pytest.fixture(scope="module")
def multiscale_run(synth_data):
    cfg = _cfg(synth_data, epochs=2, size_rates=(0.75, 1.0, 1.25))
    return train(cfg, log=lambda s: None)


@pytest.mark.parametrize("rates,epochs,steps", [((1.0,), 3, 2),
                                                ((0.75, 1.0, 1.25), 2, 3)],
                         ids=["one_scale", "three_scales"])
def test_train_takes_the_expected_steps(synth_data, multiscale_run, rates,
                                        epochs, steps):
    """The reference's range(1, epochs): epochs - 1 epochs of one batch of
    8, each batch one step a scale."""
    if len(rates) == 3:
        state, best, history = multiscale_run
    else:
        state, best, history = train(
            _cfg(synth_data, epochs=epochs, size_rates=rates),
            log=lambda s: None)
    assert state.step == steps and state.optimizer.count == steps
    assert best is None and len(history) == epochs - 1
    assert all(np.isfinite(h["loss"]) for h in history)
    for p in state.model.parameters():
        assert p.dtype == torch.float32 and bool(torch.isfinite(p).all())


def test_eval_gives_every_metric_finite(synth_data, multiscale_run):
    state = multiscale_run[0]
    res = eval_datasets_fn(state.model, os.path.join(synth_data,
                                                     "TestDataset"),
                           ["DS1"], testsize=SIZE, batch_size=8)
    assert set(res["DS1"]) == set(BINARY_METRIC_NAMES)
    assert all(np.isfinite(v) for v in res["DS1"].values())


def test_train_keeps_best_and_snapshots(synth_data, tmp_path):
    """With an eval_fn the run keeps the best epoch's variables (a copy),
    and snapshots every snapshot_every epochs."""
    scores = iter([0.2, 0.5, 0.1])
    seen = []

    def eval_fn(model, state):
        seen.append(state.step)
        return next(scores)

    cfg = _cfg(synth_data, epochs=4, size_rates=(1.0,),
               save_dir=str(tmp_path / "snap"), snapshot_every=2)
    state, best, _ = train(cfg, eval_fn=eval_fn, log=lambda s: None)
    assert seen == [1, 2, 3] and sorted(os.listdir(tmp_path / "snap")) == [
        "epoch_2.pt"]
    model = get_model("pranet_v2", device="cpu", num_class=1)
    restored = restore_state(
        str(tmp_path / "snap" / "epoch_2.pt"),
        TrainState(model, make_optimizer(model.parameters(), 1e-4)))
    assert restored.step == 2
    for k, v in restored.model.state_dict().items():
        torch.testing.assert_close(v, best[k], rtol=0, atol=0)
    assert any(not torch.equal(v, best[k])
               for k, v in state.variables.items())


def test_predict_export_uint8(synth_data):
    model = get_model("pranet_v2", device="cpu", num_class=1)
    fwd = make_predict_fn(model)
    ds = PolypTestDataset(
        os.path.join(synth_data, "TestDataset/DS1/images"),
        os.path.join(synth_data, "TestDataset/DS1/masks"), SIZE)
    outs = list(predict_to_maps(fwd, ds, batch_size=3))
    assert len(outs) == len(ds) == 8
    for name, pred, gt in outs:
        assert pred.dtype == np.uint8 and pred.shape == gt.shape == (48, 56)
        assert name.endswith(".png")
    assert not model.training


STEP_SIZE = 32  # the fixed-batch steps: 2 images of 32 x 32


def _fixed_batch(seed=0):
    rng = np.random.default_rng(seed)
    shape = (2, 1, STEP_SIZE, STEP_SIZE)
    imgs = torch.from_numpy(rng.standard_normal((2, 3, *shape[2:]),
                                                dtype=np.float32))
    gts = torch.from_numpy((rng.random(shape) > 0.5).astype(np.float32))
    return imgs, gts


def test_bf16_train_step_sane():
    """bf16 compute under autocast: the parameters stay float32 and the
    loss falls over 4 steps on a fixed batch."""
    model = get_model("pranet_v2", device="cpu", num_class=1)
    state = TrainState(
        model, make_optimizer(model.parameters(), 1e-4, clip_value=0.5))
    step = make_train_step(model, target_size=STEP_SIZE, rescale=False,
                           compute_dtype=torch.bfloat16)
    imgs, gts = _fixed_batch()
    losses = []
    for _ in range(4):
        state, loss, parts = step(state, imgs, gts)
        losses.append(loss.item())
        assert loss.dtype == torch.float32 and parts.shape == (4,)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_checkpoint_roundtrip(tmp_path):
    model = get_model("pranet_v2", device="cpu", num_class=1)
    state = TrainState(model, make_optimizer(model.parameters(),
                                                     1e-4))
    step = make_train_step(model, target_size=STEP_SIZE, rescale=False)
    state, _, _ = step(state, *_fixed_batch())
    want = {k: v.clone() for k, v in state.variables.items()}
    save_state(str(tmp_path / "ckpt.pt"), state)
    save_params(str(tmp_path / "params.pt"), state.variables)
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    state.step = state.optimizer.count = 0
    restored = restore_state(str(tmp_path / "ckpt.pt"), state)
    assert restored.step == 1 and restored.optimizer.count == 1
    params = restore_params(str(tmp_path / "params.pt"))
    got = restored.variables
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
        torch.testing.assert_close(params[k], v, rtol=0, atol=0)


def test_resume_equals_uninterrupted(tmp_path):
    """2 steps, save, restore into a fresh state, 2 more: bit for bit the
    4 uninterrupted steps (the parameters, the BatchNorm buffers and the
    optimizer's moments and count)."""
    imgs, gts = _fixed_batch(1)
    init = get_model("pranet_v2", device="cpu", num_class=1,
                     generator=torch.Generator().manual_seed(3))

    def fresh():
        model = copy.deepcopy(init)
        state = TrainState(model, make_optimizer(
            model.parameters(), 1e-4, clip_value=0.5))
        return state, make_train_step(model, target_size=STEP_SIZE,
                                      rescale=False)

    s, step = fresh()
    for _ in range(4):
        s, _, _ = step(s, imgs, gts)
    r, step = fresh()
    for _ in range(2):
        r, _, _ = step(r, imgs, gts)
    save_state(str(tmp_path / "ck.pt"), r)
    resumed, step = fresh()
    restore_state(str(tmp_path / "ck.pt"), resumed)
    assert resumed.step == 2
    for _ in range(2):
        resumed, _, _ = step(resumed, imgs, gts)
    assert resumed.step == 4
    got = resumed.variables
    for k, v in s.variables.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    a, b = s.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert a["count"] == b["count"] == 4
    for i, st in a["inner"]["state"].items():
        for key, t in st.items():
            torch.testing.assert_close(b["inner"]["state"][i][key], t,
                                       rtol=0, atol=0)


def test_cached_dataset_workers_give_the_items(synth_data, tmp_path):
    """More than 8 items go through the spawned process pool; each equals
    a direct read."""
    src = os.path.join(synth_data, "TrainDataset")
    for sub in ("images", "masks"):
        os.makedirs(tmp_path / sub)
        for i in range(10):
            os.symlink(os.path.join(src, sub, f"{i % 8}.png"),
                       tmp_path / sub / f"{i}.png")
    ds = PolypDataset(str(tmp_path / "images"), str(tmp_path / "masks"), 32)
    cached = CachedDataset(ds, num_procs=2)
    assert len(cached) == len(ds) == 10
    for i in (0, 9):
        for got, want in zip(cached[i], ds[i]):
            np.testing.assert_array_equal(got, want)


def test_cli_trains_one_epoch_on_the_cpu(synth_data, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ["--epoch", "2", "--batchsize", "8", "--trainsize", str(SIZE),
            "--train_path", os.path.join(synth_data, "TrainDataset"),
            "--test_root", os.path.join(synth_data, "TestDataset"),
            "--eval_datasets", "DS1", "--train_save", "run",
            "--snapshot_every", "1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(args)
    cli.main(args + ["--device", "cpu"])
    out = tmp_path / "snapshots" / "run"
    assert sorted(os.listdir(out)) == ["best.pt", "epoch_1.pt", "last.pt"]
    last = torch.load(out / "last.pt", weights_only=True)
    assert last["step"] == 3 and last["optimizer"]["count"] == 3
    best = restore_params(str(out / "best.pt"))
    for k, v in best.items():
        torch.testing.assert_close(last["model"][k], v, rtol=0, atol=0)

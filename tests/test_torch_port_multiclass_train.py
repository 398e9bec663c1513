"""The port's multiclass recipe against the JAX package's, on the CPU: the
train step, volumetric inference, the train loop and both multiclass CLIs.

Weights are drawn as in ``test_torch_port_pranet.random_variables`` and
carried into the port by ``state_dict_from_jax``; data is numpy from a
seed, synthetic Synapse and ACDC files written by the tests.  EMCAD runs
on its ResNet-18 encoder: the encoder without drop path, so that a train
step can be held against JAX's (PVTv2 draws its drop path masks from
another generator; its training is held to "finite and learning").

* The train step in float64 (JAX under x64), two AdamW steps on one batch
  of 2 at 64 x 64: each loss within 1e-9 relative; every parameter within
  1e-8 + 1e-6 relative and every BatchNorm statistic within 1e-9 + 1e-8
  relative of JAX's after the second (measured: 2e-10 and 6e-10 at most).
  One parameter is held to 1e-6 instead: the grayscale stem's conv bias,
  whose gradient is zero in exact arithmetic (BatchNorm follows) and is
  float64 noise of about 1e-10 on each side, which Adam scales by
  1 / (|g| + 1e-8) into updates of up to 1e-6 a step (a hundredth of the
  1e-4 step); it moved 8.5e-9 apart here.  The stem BatchNorm's running
  mean carries a tenth of that bias's first update (momentum 0.1): 1e-7.
* ``test_volumes`` in its three modes on a ragged volume at chunk 4 and a
  32 x 32 patch: the same predictions, so metrics equal within 1e-12.
* The test CLI on the same reference-style ``.pth`` and volumes as JAX's:
  the same printed lines.  Both CLIs parse the same arguments to the same
  values (JAX's parsed without running it: its training needs a batch
  divisible by the 8 virtual devices); the train CLI prints JAX's lines,
  numbers aside (the two draw their initial weights differently).
"""

import argparse
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pranet2_tpu.cli import test_multiclass as jax_test_cli
from pranet2_tpu.cli import train_multiclass as jax_train_cli
from pranet2_tpu.models import get_model as jax_get_model
from pranet2_tpu.train import multiclass as jax_mc
from pranet2_tpu.train.optim import make_optimizer as jax_make_optimizer
from pranet2_tpu.train.state import TrainState as JaxTrainState
from pranet2_tpu.utils.torch_convert import convert_state_dict, emcad_key_map
from pranet2_tpu_torch import get_model, list_models
from pranet2_tpu_torch.cli import test_multiclass as port_test_cli
from pranet2_tpu_torch.cli import train_multiclass as port_train_cli
from pranet2_tpu_torch.train import TrainState, make_optimizer
from pranet2_tpu_torch.train import multiclass as port_mc
from pranet2_tpu_torch.utils.convert import load_jax_variables
from test_torch_port_pranet import random_variables

SIZE, BATCH, NC = 64, 2, 4
PATCH = 32
ENC = "resnet18"
STEP_TOL = {"params": dict(atol=1e-8, rtol=1e-6),
            "batch_stats": dict(atol=1e-9, rtol=1e-8)}
# Adam on a gradient that is zero in exact arithmetic (see the docstring)
NOISE_TOL = {"['stem_conv']['bias']": dict(atol=1e-6, rtol=0),
             "['stem_bn']['mean']": dict(atol=1e-7, rtol=0)}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs files in parallel workers, and
    each worker's default of one thread a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port(v, dual=True, dtype=None):
    model = get_model("emcad", device="cpu", num_classes=NC, encoder=ENC,
                      dual=dual)
    if dtype is not None:
        model = model.to(dtype)
    return load_jax_variables(model, v)


def _tree_to_np(tree, dtype=np.float64):
    return jax.tree.map(lambda a: np.array(a, dtype), tree)


# ------------------------------------------------------------ train step


@pytest.fixture(scope="module")
def step_pair():
    """Two float64 train steps on one batch on each side, from the same
    weights: (JAX's losses and variables, the port's)."""
    rng = np.random.default_rng(0)
    images = rng.standard_normal((BATCH, SIZE, SIZE, 1))
    labels = rng.integers(0, NC, (BATCH, SIZE, SIZE))
    cfg = port_mc.MulticlassTrainConfig(num_classes=NC, batch_size=BATCH,
                                        img_size=SIZE)
    with jax.enable_x64(True):
        model = jax_get_model("emcad", num_classes=NC, encoder=ENC)
        v = _tree_to_np(random_variables(model, jnp.zeros((1, SIZE, SIZE, 1)),
                                         seed=1))
        tx = jax_make_optimizer(cfg.lr, clip_value=None,
                                weight_decay=cfg.weight_decay)
        params = jax.tree.map(jnp.asarray, v["params"])
        state = JaxTrainState(step=0, params=params,
                              batch_stats=jax.tree.map(jnp.asarray,
                                                       v["batch_stats"]),
                              opt_state=tx.init(params), tx=tx)
        step = jax_mc.make_multiclass_train_step(
            model, jax_mc.MulticlassTrainConfig(num_classes=NC))
        losses = []
        for _ in range(2):
            state, loss = step(state, jnp.asarray(images),
                               jnp.asarray(labels))
            losses.append(float(loss))
        want = (losses, _tree_to_np(state.variables))

    port = _port(v, dtype=torch.float64)
    pstate = TrainState(port, make_optimizer(
        port.parameters(), cfg.lr, clip_value=None,
        weight_decay=cfg.weight_decay))
    pstep = port_mc.make_multiclass_train_step(port, cfg)
    x = torch.from_numpy(images.transpose(0, 3, 1, 2).copy())
    y = torch.from_numpy(labels)
    plosses = []
    for _ in range(2):
        pstate, loss = pstep(pstate, x, y)
        assert loss.dtype == torch.float64
        plosses.append(loss.item())
    assert pstate.step == 2
    with jax.enable_x64(True):
        got = _tree_to_np(convert_state_dict(
            {k: t.numpy() for k, t in port.state_dict().items()},
            emcad_key_map(ENC)))
    return want, (plosses, got)


def test_train_step_loss_matches_jax_f64(step_pair):
    (want, _), (got, _) = step_pair
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-9 * abs(w), (got, want)
    assert got[1] < got[0]  # two steps on one batch learn it


@pytest.mark.parametrize("part", ["params", "batch_stats"])
def test_train_step_variables_match_jax_f64(step_pair, part):
    (_, want), (_, got) = step_pair
    g = jax.tree_util.tree_leaves_with_path(got[part])
    w = jax.tree_util.tree_leaves_with_path(want[part])
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(a, b, **NOISE_TOL.get(key,
                                                         STEP_TOL[part]),
                                   err_msg=key)


def test_remat_raises():
    model = get_model("emcad", device="cpu", num_classes=NC, encoder=ENC)
    with pytest.raises(NotImplementedError):
        port_mc.make_multiclass_train_step(
            model, port_mc.MulticlassTrainConfig(remat=True))


# ------------------------------------------------------ volume inference


class _Volumes:
    """One ragged volume: 6 slices of 40 x 44 (zoomed to the 32 x 32
    patch and back), labels 0..3."""

    def __len__(self):
        return 1

    def case_name(self, i):
        return "case0"

    def __getitem__(self, i):
        rng = np.random.default_rng(2)
        vol = rng.standard_normal((6, 40, 44)).astype(np.float32)
        lab = rng.integers(0, NC, (6, 40, 44)).astype(np.int32)
        lab[:, 8:30, 10:34] = 2
        return vol, lab


@pytest.fixture(scope="module")
def emcad_trees():
    """A flax tree of the dual and the single EMCAD-ResNet-18."""
    x = jnp.zeros((1, PATCH, PATCH, 1))
    return {dual: random_variables(jax_get_model(
        "emcad", num_classes=NC, encoder=ENC, dual=dual), x, seed=3)
        for dual in (True, False)}


@pytest.mark.parametrize("mode", ["fg_minus_bg", "fg_only", "single"])
def test_test_volumes_matches_jax(emcad_trees, mode):
    dual = mode != "single"
    v = emcad_trees[dual]
    model = jax_get_model("emcad", num_classes=NC, encoder=ENC, dual=dual)
    want, wnames = jax_mc.test_volumes(model, v, _Volumes(), NC,
                                       patch_size=(PATCH, PATCH), mode=mode,
                                       chunk=4)
    port = _port(v, dual)
    got, names = port_mc.test_volumes(port, _Volumes(), NC,
                                      patch_size=(PATCH, PATCH), mode=mode,
                                      chunk=4)
    assert names == wnames == ["case0"] and got.shape == (1, NC - 1, 4)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # the predictor alone, and the dice-only metrics
    vol = _Volumes()[0][0]
    pred = port_mc.make_slice_predictor(port, (PATCH, PATCH), mode, 4)(vol)
    assert pred.shape == vol.shape and pred.dtype == np.int32
    dice, _ = port_mc.test_volumes(port, _Volumes(), NC, (PATCH, PATCH), mode,
                                   full_metrics=False, chunk=4)
    np.testing.assert_array_equal(dice[..., 0], got[..., 0])


def test_combined_logits_modes():
    outs = [torch.full((1, 2, 1, 1), float(i)) for i in range(8)]
    assert port_mc.combined_logits(outs, "fg_minus_bg").flatten()[0] == -16
    assert port_mc.combined_logits(outs, "fg_only").flatten()[0] == 6
    assert port_mc.combined_logits(outs, "single").flatten()[0] == 28
    with pytest.raises(ValueError):
        port_mc.combined_logits(outs, "bg_only")
    with pytest.raises(ValueError):
        port_mc.make_slice_predictor(torch.nn.Conv2d(1, 1, 1), (4, 4), "x")


# ------------------------------------------------------------ train loop


class _Slices:
    """Train or ACDC-'valid' style slices: (1, S, S) image, (S, S) label."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.items = [(rng.standard_normal((1, PATCH, PATCH)).astype(
            np.float32), rng.integers(0, NC, (PATCH, PATCH)).astype(np.int32))
            for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def case_name(self, i):
        return f"slice{i}"

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("dtype,threshold", [("float32", 0.0),
                                             ("float32", 1.01),
                                             ("bfloat16", 0.0)],
                         ids=["best_kept", "best_gated", "bf16"])
def test_train_multiclass_two_epochs(dtype, threshold):
    """Two epochs of 2 steps, validation from epoch 1 (eval_from_frac
    0.5), the best kept only past ``best_threshold``; bf16 trains under
    autocast with float32 parameters and validates a bf16 copy."""
    model = get_model("emcad", device="cpu", num_classes=NC,
                      encoder="pvt_v2_b0" if dtype == "bfloat16" else ENC,
                      generator=torch.Generator().manual_seed(4))
    cfg = port_mc.MulticlassTrainConfig(
        num_classes=NC, max_epochs=2, batch_size=BATCH, img_size=PATCH,
        best_threshold=threshold, dtype=dtype, seed=5)
    logs = []
    state, best, history = port_mc.train_multiclass(
        model, cfg, _Slices(4, 6), _Slices(2, 7), log=logs.append,
        num_threads=2)
    assert state.step == 4 and [h["epoch"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) and 0 <= h["val_dice"] <= 1
               for h in history)
    assert (best is None) == (threshold > 1)
    if best is not None:
        assert best.keys() == model.state_dict().keys()
    assert all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
               for p in model.parameters())
    assert sum("val mean-dice" in ln for ln in logs) == 2


# ----------------------------------------------------------------- CLIs


def _write_sets(root):
    """Synapse train .npz slices and test .npy.h5 volumes, ACDC test .npz
    volumes, each with its list file."""
    import h5py

    rng = np.random.default_rng(8)
    for d in ("syn_train", "syn_test", "acdc", "lists_syn", "lists_acdc"):
        (root / d).mkdir()
    train, syn, acdc = [], [], []
    for i in range(4):
        np.savez(root / "syn_train" / f"case{i}_slice0.npz",
                 image=rng.random((40, 40)).astype(np.float32),
                 label=rng.integers(0, 14, (40, 40)).astype(np.uint8))
        train.append(f"case{i}_slice0")
    for i in range(2):
        with h5py.File(root / "syn_test" / f"case{i}.npy.h5", "w") as f:
            f["image"] = rng.random((3, 40, 40)).astype(np.float32)
            lab = np.zeros((3, 40, 40), np.uint8)
            lab[:, 5:25, 8:30] = 1 + i
            lab[1:, 20:35, 20:38] = 8
            f["label"] = lab
        syn.append(f"case{i}")
        vol = rng.random((5, 36, 40)).astype(np.float32)
        lab = np.zeros((5, 36, 40), np.int64)
        lab[:, 4:20, 6:30] = 1
        lab[2:, 15:33, 10:36] = 3
        np.savez(root / "acdc" / f"patient{i}.npz", img=vol, label=lab)
        acdc.append(f"patient{i}.npz")
    (root / "lists_syn" / "train.txt").write_text("\n".join(train) + "\n")
    (root / "lists_syn" / "test_vol.txt").write_text("\n".join(syn) + "\n")
    (root / "lists_acdc" / "test.txt").write_text("\n".join(acdc) + "\n")


def _run_jax_cli(module, argv, monkeypatch, capsys):
    """JAX's CLI ``main`` in this process on ``argv``; its printed lines.
    The test CLI sets JAX's matmul precision: restored after."""
    precision = jax.config.jax_default_matmul_precision
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    capsys.readouterr()
    try:
        module.main()
    finally:
        jax.config.update("jax_default_matmul_precision", precision)
    return capsys.readouterr().out.splitlines()


class _Parsed(Exception):
    pass


def _parsed_args(module, argv, monkeypatch):
    """The namespace a CLI's ``main`` parses from ``argv``, stopping it
    there."""
    parse = argparse.ArgumentParser.parse_args

    def stop(self, args=None, namespace=None):
        raise _Parsed(parse(self, args, namespace))

    with monkeypatch.context() as m:
        m.setattr(sys, "argv", [module.__name__, *argv])
        m.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(_Parsed) as got:
            module.main() if module.__name__.startswith("pranet2_tpu.") \
                else module.main(argv)
    return vars(got.value.args[0])


@pytest.mark.parametrize("cli", ["train", "test"])
@pytest.mark.parametrize("argv", [[], ["--dataset", "acdc", "--no-dual",
                                       "--encoder", "resnet50"]],
                         ids=["defaults", "flags"])
def test_cli_flags_and_defaults_are_jax(monkeypatch, cli, argv):
    """Every flag of JAX's CLI, parsed to the same value by the port's,
    which adds ``--device`` only."""
    jax_mod, port_mod = {"train": (jax_train_cli, port_train_cli),
                         "test": (jax_test_cli, port_test_cli)}[cli]
    required = (["--root_path", "r", "--list_dir", "l"] if cli == "train"
                else ["--volume_path", "v", "--list_dir", "l",
                      "--checkpoint", "c.pth"])
    want = _parsed_args(jax_mod, required + argv, monkeypatch)
    got = _parsed_args(port_mod, required + argv, monkeypatch)
    assert got.pop("device") is None
    assert got == want


@pytest.mark.parametrize("dataset,classes,volumes,lists", [
    ("acdc", NC, "acdc", "lists_acdc"), ("synapse", 9, "syn_test",
                                          "lists_syn")])
def test_test_cli_prints_jax_lines(tmp_path, monkeypatch, capsys, dataset,
                                   classes, volumes, lists):
    """A reference EMCAD ``.pth`` (``module.`` keys in a ``state_dict``
    container): the port's CLI and JAX's print the same per-case,
    per-class and mean lines on the same volumes."""
    _write_sets(tmp_path)
    sd = get_model("emcad", device="cpu", num_classes=classes, encoder=ENC,
                   generator=torch.Generator().manual_seed(9)).state_dict()
    torch.save({"state_dict": {f"module.{k}": t for k, t in sd.items()}},
               tmp_path / "emcad.pth")
    argv = ["--dataset", dataset, "--volume_path", str(tmp_path / volumes),
            "--list_dir", str(tmp_path / lists), "--checkpoint",
            str(tmp_path / "emcad.pth"), "--encoder", ENC, "--img_size",
            str(PATCH)]
    want = _run_jax_cli(jax_test_cli, argv, monkeypatch, capsys)
    metrics, names = port_test_cli.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert len(got) == 2 + classes - 1 + 1 and metrics.shape == (
        2, classes - 1, 4)


def _shape(lines):
    """Printed lines with every number replaced, the save path cut."""
    return [re.sub(r"-?\d+\.\d+", "#", ln.split(" in ")[0]) for ln in lines]


def test_train_cli_prints_jax_lines(tmp_path, capsys):
    """One epoch on 4 Synapse slices, validated on 2 test volumes (each
    epoch from ``eval_from_frac``): JAX's lines, numbers aside
    (``pranet2_tpu/cli/train_multiclass.py`` and ``train/multiclass.py``
    print them); ``last.pt`` holds the full train state."""
    _write_sets(tmp_path)
    port_train_cli.main([
        "--model", "emcad", "--encoder", ENC, "--dataset", "synapse",
        "--root_path", str(tmp_path / "syn_train"), "--list_dir",
        str(tmp_path / "lists_syn"), "--val_root", str(tmp_path / "syn_test"),
        "--val_split", "test_vol", "--max_epochs", "1", "--batch_size", "2",
        "--img_size", str(PATCH), "--save_dir", str(tmp_path / "out"),
        "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert _shape(got) == ["epoch 1/1 loss # (#s)", "epoch 1 val mean-dice #",
                           "done; snapshots"]
    saved = torch.load(tmp_path / "out" / "last.pt", weights_only=True)
    assert saved["step"] == 2 and sorted(saved) == ["model", "optimizer",
                                                    "step"]
    get_model("emcad", device="cpu", num_classes=9,
              encoder=ENC).load_state_dict(saved["model"])


@pytest.mark.parametrize("cli", ["train", "test"])
@pytest.mark.parametrize("model", ["merit", "merit_parallel", "mist"])
def test_cli_builds_every_model_as_jax(monkeypatch, cli, model):
    """Both CLIs build MERIT, MERIT-parallel and MIST from JAX's flags and
    defaults as JAX's ``build_model`` does: the same registry model, the
    dataset's classes, dual heads (8 maps), the same settings (the port's
    model on the meta device, no weights drawn).  The port's registry holds
    JAX's twelve names."""
    from pranet2_tpu.models import list_models as jax_list_models
    from pranet2_tpu.models import merit as jax_merit
    from pranet2_tpu.models.backbones import maxvit as jax_maxvit

    required = (["--root_path", "r", "--list_dir", "l"] if cli == "train"
                else ["--volume_path", "v", "--list_dir", "l",
                      "--checkpoint", "c.pth"])
    jax_mod, port_mod = {"train": (jax_train_cli, port_train_cli),
                         "test": (jax_test_cli, port_test_cli)}[cli]
    argv = required + ["--model", model]
    jargs = argparse.Namespace(**_parsed_args(jax_mod, argv, monkeypatch))
    pargs = argparse.Namespace(**_parsed_args(port_mod, argv, monkeypatch))
    want = jax_train_cli.build_model(model, 9, jargs)
    with torch.device("meta"):
        got = port_train_cli.build_model(model, 9, pargs, device="meta",
                                         img_size=224)
    assert type(got).__name__ == type(want).__name__
    assert got.dual is want.dual is True
    assert got.decoder.use_softmax is want.use_softmax is True
    assert got.img_size_s1 == tuple(want.img_size_s1)
    backbones = ["maxxvit_rmlp_small_rw_256"]
    if hasattr(want, "img_size_s2"):
        assert got.img_size_s2 == tuple(want.img_size_s2)
        backbones = jax_merit._SCALE_BACKBONES[want.model_scale]
    for i, name in enumerate(backbones, start=1):
        cfg = jax_maxvit.MAXVIT_CONFIGS[name]
        bb = getattr(got, f"backbone{i}")
        assert bb.stem.conv1.out_channels == cfg["stem_width"][0]
        assert [len(st.blocks) for st in bb.stages] == list(cfg["depths"])
        assert bb.norm.normalized_shape == (cfg["embed_dim"][-1],)
    heads = [m for n, m in got.named_modules()
             if n.endswith(("ConvBlock1_fg.conv", "out_head4_fg"))]
    assert [h.out_channels for h in heads] == [want.num_classes] == [9]
    assert list_models() == sorted(jax_list_models()) and len(
        list_models()) == 12

"""The port's V1 serving, prediction and the binary inference CLIs
(``test_binary``, ``eval_binary``, ``benchmark``) against the JAX
package's, on the CPU.

Weights are drawn as in ``test_torch_port_pranet.random_variables``.  In
this file every Res2Net encoder has one block a stage, on both sides (JAX's
``_make_backbone`` and the port's ``_BACKBONES`` patched for the module),
the models both CLIs build by name included; PraNet-V1 at full depth is
held against JAX in ``test_torch_port_v1.py``.  The card's V1 forwards are
held against the CPU in ``test_torch_port_kernels.py``, which imports no
JAX.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pranet2_tpu.cli import eval_binary as jax_eval_cli
from pranet2_tpu.cli import test_binary as jax_test_cli
from pranet2_tpu.models import get_model as jax_get_model
from pranet2_tpu.models import pranet as jax_pranet
from pranet2_tpu.models.backbones.res2net import Res2Net as JaxRes2Net
from pranet2_tpu.serve import BinaryPredictor as JaxPredictor
from pranet2_tpu.train.binary import make_predict_fn as jax_make_predict_fn
from pranet2_tpu_torch import get_model
from pranet2_tpu_torch.cli import benchmark as port_bench_cli
from pranet2_tpu_torch.cli import eval_binary as port_eval_cli
from pranet2_tpu_torch.cli import test_binary as port_test_cli
from pranet2_tpu_torch.models import pranet as port_pranet
from pranet2_tpu_torch.models.backbones.res2net import Res2Net
from pranet2_tpu_torch.serve import BinaryPredictor, head_kwargs, is_v2
from pranet2_tpu_torch.train.binary import make_predict_fn
from pranet2_tpu_torch.utils.convert import (load_jax_variables,
                                            state_dict_from_jax)
from test_torch_port_pranet import random_variables

TESTSIZE, BATCH = 64, 2
ONE = (1, 1, 1, 1)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs files in parallel workers, and
    each worker's default of one thread a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def one_block_res2net():
    """Res2Net-50 with one block a stage in both packages, for the module."""
    mp = pytest.MonkeyPatch()
    widths = (512, 1024, 2048)
    make = jax_pranet._make_backbone
    mp.setattr(jax_pranet, "_make_backbone", lambda kind, dt: (
        (JaxRes2Net(layers=ONE, dtype=dt, name="backbone"), widths)
        if kind == "res2net50" else make(kind, dt)))
    mp.setitem(port_pranet._BACKBONES, "res2net50", (
        lambda **kw: Res2Net(**{"layers": ONE, **kw}), widths))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def reduced_v1():
    """A flax tree of pranet_v1 and the port's model holding it."""
    v = random_variables(jax_get_model("pranet_v1"),
                         jnp.zeros((1, TESTSIZE, TESTSIZE, 3)), seed=5)
    port = load_jax_variables(get_model("pranet_v1", device="cpu"), v)
    return v, port


def _images(n):
    rng = np.random.default_rng(4)
    return [(rng.random((40 + 7 * i, 50 + 3 * i, 3)) * 255).astype(np.uint8)
            for i in range(n)]


def _at_most_one_level_apart(got, want):
    # f32 logits agree to ~1e-6 relative; a pixel on a uint8 quantisation
    # boundary may land one level apart
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("exact_postproc", [True, False])
def test_v1_predictor_matches_jax(reduced_v1, exact_postproc):
    """V1: no ``num_class``, the finest map ``outs[3]``; three images at
    batch 2 (a padded partial batch)."""
    v, port = reduced_v1
    images = _images(3)
    pred = BinaryPredictor("pranet_v1", port.state_dict(), batch_size=BATCH,
                           testsize=TESTSIZE, exact_postproc=exact_postproc,
                           device="cpu", model_kwargs={"layers": ONE})
    assert not pred.v2
    got = pred(images)
    pred.close()
    want = JaxPredictor("pranet_v1", v, batch_size=BATCH, testsize=TESTSIZE,
                        exact_postproc=exact_postproc)(images)
    assert len(got) == len(want) == 3
    for im, g, w in zip(images, got, want):
        assert g.shape == im.shape[:2]
        _at_most_one_level_apart(g, w)


def test_predictor_serves_v1_finest_and_v2_summed_maps():
    """The logits the predictor serves: V1's ``outs[3]``, V2's sum of its
    four fg maps (unchanged); ``num_class`` is given to V2 models only."""
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (BATCH, 3, TESTSIZE, TESTSIZE)).astype(np.float32))
    for name, pick in (("pranet_v1", lambda o: o[3]),
                       ("pranet_v2", lambda o: o[0] + o[1] + o[2] + o[3])):
        model = get_model(name, device="cpu").eval()
        pred = BinaryPredictor(name, model.state_dict(), batch_size=BATCH,
                               testsize=TESTSIZE, device="cpu",
                               host_workers=0, model_kwargs={"layers": ONE})
        with torch.no_grad():
            want = pick(model(x))
        torch.testing.assert_close(pred._forward(x), want, rtol=0, atol=0)
        assert pred.v2 == is_v2(name) == (name == "pranet_v2")
    assert head_kwargs("pvt_pranet_v1") == {}
    assert head_kwargs("pranet_v1_resnet") == {}
    assert head_kwargs("pvt_pranet_v2") == {"num_class": 1}


def test_v1_make_predict_fn_matches_jax(reduced_v1):
    v, port = reduced_v1
    x = np.random.default_rng(7).standard_normal(
        (BATCH, TESTSIZE, TESTSIZE, 3)).astype(np.float32)
    want = np.asarray(jax_make_predict_fn(jax_get_model("pranet_v1"), v,
                                          v2=False)(jnp.asarray(x)))
    got = make_predict_fn(port, v2=False)(
        torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tuple(got.shape) == (BATCH, 1, TESTSIZE, TESTSIZE)
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-5


def test_v1_test_with_eval_matches_jax(reduced_v1, tmp_path):
    """``test_with_eval(v2=False)``: the metric suite over a set of three
    images (a padded batch), from masks within one uint8 level of JAX's."""
    from pranet2_tpu.train.binary import test_with_eval as jax_test_with_eval
    from pranet2_tpu_torch.train.binary import test_with_eval

    v, port = reduced_v1
    _write_set(tmp_path / "SET", 3, seed=3)
    kw = dict(testsize=TESTSIZE, batch_size=BATCH, v2=False)
    want = jax_test_with_eval(jax_get_model("pranet_v1"), v, str(tmp_path),
                              ["SET"], **kw)["SET"]
    got = test_with_eval(port, str(tmp_path), ["SET"], **kw)["SET"]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=5e-3, err_msg=k)


def test_train_refuses_v1_as_jax_does(tmp_path):
    """The binary recipe trains V2 only, in both packages."""
    from pranet2_tpu.train.binary import BinaryTrainConfig as JaxConfig
    from pranet2_tpu.train.binary import train as jax_train
    from pranet2_tpu_torch.train.binary import BinaryTrainConfig, train

    with pytest.raises(TypeError):
        jax_train(JaxConfig(model="pranet_v1",
                            train_path=str(tmp_path / "none")))
    with pytest.raises(TypeError, match="V2"):
        train(BinaryTrainConfig(model="pranet_v1", device="cpu",
                                train_path=str(tmp_path / "none")))


# ------------------------------------------------------------------ CLIs


def _write_set(root, n, seed):
    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir()
    for i in range(n):
        h, w = 50 + 9 * i, 70 - 5 * i
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        mask = ((rng.random((h, w)) > 0.6) * 255).astype(np.uint8)
        Image.fromarray(img).save(root / "images" / f"{i}.jpg")
        Image.fromarray(mask).save(root / "masks" / f"{i}.png")


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """pranet_v1 as a reference-style .pth (a ``state_dict``
    container, ``module.`` keys, a stray ``resnet.fc``), two sets of two
    images, and both CLIs' exports of them."""
    root = tmp_path_factory.mktemp("cli")
    data = root / "TestDataset"
    for k, ds in enumerate(("SETA", "SETB")):
        _write_set(data / ds, 2, seed=k)
    v = random_variables(jax_get_model("pranet_v1"),
                         jnp.zeros((1, TESTSIZE, TESTSIZE, 3)), seed=9)
    sd = state_dict_from_jax(v, encoder="resnet")
    sd["resnet.fc.weight"] = torch.zeros((3, 2048))
    pth = root / "ref.pth"
    torch.save({"state_dict": {f"module.{k}": t for k, t in sd.items()}},
               pth)
    common = ["--model", "pranet_v1", "--checkpoint", str(pth),
              "--testsize", str(TESTSIZE), "--batchsize", str(BATCH),
              "--data_root", str(data), "--datasets", "SETA", "SETB"]
    written = port_test_cli.main(common + [
        "--save_root", str(root / "port"), "--device", "cpu"])
    mp = pytest.MonkeyPatch()
    try:  # JAX's CLI reads sys.argv; 'default' leaves its precision alone
        mp.setattr(sys, "argv", ["test_binary"] + common + [
            "--save_root", str(root / "jax"), "--precision", "default"])
        jax_test_cli.main()
    finally:
        mp.undo()
    return root, written


def test_test_binary_cli_writes_jax_pngs(cli_run):
    root, written = cli_run
    assert written == {"SETA": 2, "SETB": 2}
    for ds in ("SETA", "SETB"):
        for i in range(2):
            rel = f"pranet_v1/{ds}/{i}.png"
            got = np.array(Image.open(root / "port" / rel))
            want = np.array(Image.open(root / "jax" / rel))
            gt = np.array(Image.open(root / "TestDataset" / ds / "masks"
                                     / f"{i}.png"))
            assert got.shape == gt.shape
            _at_most_one_level_apart(got, want)


def test_eval_binary_cli_gives_jax_numbers(cli_run, tmp_path, capsys):
    """Both packages' eval over the same PNGs (the JAX CLI's export): the
    same rows, the same CSV lines, and the table printed."""
    root, _ = cli_run
    args = dict(pred_root=str(root / "jax" / "pranet_v1"),
                gt_root=str(root / "TestDataset"), datasets=["SETA", "SETB"],
                metrics=port_eval_cli.DEFAULT_METRICS)
    want = jax_eval_cli.evaluate_pred_dirs(
        **args, result_path=str(tmp_path / "jax"))
    rows = port_eval_cli.main([
        "--pred_root", args["pred_root"], "--gt_root", args["gt_root"],
        "--datasets", "SETA", "SETB", "--result_path", str(tmp_path / "port")])
    assert [r[0] for r in rows] == ["SETA", "SETB"]
    for r, w in zip(rows, want):
        assert r[0] == w[0]
        np.testing.assert_array_equal(np.asarray(r[1:], np.float64),
                                      np.asarray(w[1:], np.float64))
    for ds in ("SETA", "SETB"):
        name = f"result_{ds}.csv"
        assert ((tmp_path / "port" / name).read_text()
                == (tmp_path / "jax" / name).read_text())
    out = capsys.readouterr().out
    assert "meanDic" in out and "SETB" in out


def test_benchmark_cli_prints_table_and_fails_loudly(capsys):
    """Tiny size on the CPU: the table for the models that ran, a FAILED
    line for one that did not, and exit code 1; 0 when all ran."""
    argv = ["--device", "cpu", "--testsize", "32", "--iters", "1",
            "--windows", "1", "--models", "pranet_v1"]
    assert port_bench_cli.main(argv + ["no_such_model",
                                       "--batch_sizes", "1", "2"]) == 1
    out = capsys.readouterr().out
    assert "no_such_model: FAILED (KeyError" in out
    lines = [ln.split() for ln in out.splitlines()
             if ln.startswith("pranet_v1 ")]
    assert [ln[1] for ln in lines] == ["1", "2"]
    assert all(float(ln[2]) > 0 and float(ln[4]) > 0 for ln in lines)
    assert lines[0][-2] == "32"  # the reference's column at batch 1
    assert port_bench_cli.main(argv + ["--batch_sizes", "1"]) == 0


def test_profiling_helpers_on_the_cpu():
    """``cost_analysis``: the FLOPs of a batch-1 forward, the same under
    no_grad (the count always takes the module chain); ``fence`` and
    ``device_peak_tflops`` on the CPU."""
    from pranet2_tpu_torch.utils import profiling

    model = get_model("pranet_v1_resnet", device="cpu", layers=ONE).eval()
    x = torch.zeros((3, 3, 32, 32))
    flops = profiling.cost_analysis(model, x)["flops"]
    conv1 = 2 * 64 * 3 * 49 * 16 * 16  # the 7x7/2 stem conv alone
    assert flops > conv1
    with torch.no_grad():
        assert profiling.cost_analysis(model, x)["flops"] == flops
    outs = {"maps": [x, (x,)]}
    assert profiling.fence(outs) is outs  # nothing on a card to wait for
    assert profiling.device_peak_tflops("cpu") == ("cpu", None)

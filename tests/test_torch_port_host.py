"""The port's last host modules against the JAX package's, on the CPU:
``data/preprocess.py``, ``utils/logging_utils.py`` and
``cli/reproduce_baseline.py``.

The preprocessing and the meters are copies, held to JAX's outputs on the
same inputs.  ``reproduce_baseline`` runs as a user runs it, on a synthetic
mini TestDataset (two sets of two images) at ``--testsize 64`` with a
PraNet-V2 whose Res2Net has one block a stage in both packages (JAX's
``_make_backbone`` and the port's ``_BACKBONES`` patched for the module, as
``tests/test_torch_port_v1_cli.py`` does): the same ``.pth`` (``module.``
keys in a ``state_dict`` container) gives the same table rows, within the
metric tolerance of ``test_torch_port_v1_cli.py`` (5e-3: a pixel on a uint8
boundary may land one level apart), and the verdict passes and fails as
JAX's.
"""

import logging
import subprocess
import sys

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pranet2_tpu.cli import reproduce_baseline as jax_rb
from pranet2_tpu.data import preprocess as jax_pre
from pranet2_tpu.models import get_model as jax_get_model
from pranet2_tpu.models import pranet as jax_pranet
from pranet2_tpu.models.backbones.res2net import Res2Net as JaxRes2Net
from pranet2_tpu.utils import logging_utils as jax_log
from pranet2_tpu_torch import data as port_data
from pranet2_tpu_torch import get_model
from pranet2_tpu_torch.cli import reproduce_baseline as rb
from pranet2_tpu_torch.models import pranet as port_pranet
from pranet2_tpu_torch.models.backbones.res2net import Res2Net
from pranet2_tpu_torch.utils import logging_utils as port_log
from pranet2_tpu_torch.utils.checkpoint import save_params
from pranet2_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_pranet import random_variables

TESTSIZE, ONE, METRIC_TOL = 64, (1, 1, 1, 1), 5e-3
SETS = ("CVC-300", "Kvasir")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- preprocess


def test_tif_to_png_as_jax(tmp_path):
    rng = np.random.default_rng(0)
    src = tmp_path / "src"
    src.mkdir()
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
                        ).save(src / f"{i}.tif")
    (src / "notes.txt").write_text("not an image")
    assert port_data.tif_to_png(str(src), str(tmp_path / "port")) == 2
    assert jax_pre.tif_to_png(str(src), str(tmp_path / "jax")) == 2
    for i in range(2):
        got = np.array(Image.open(tmp_path / "port" / f"{i}.png"))
        want = np.array(Image.open(tmp_path / "jax" / f"{i}.png"))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.array(Image.open(
            src / f"{i}.tif")))


@pytest.mark.parametrize("seed", [0, 3])
def test_random_split_as_jax(seed):
    names = [f"{i}.png" for i in range(20)]
    assert (port_data.random_split(names, 12, seed)
            == jax_pre.random_split(names, 12, seed))


def test_ct_window_and_synapse_export_as_jax(tmp_path):
    """The HU window and both export layouts: the same ``.npz`` slices and
    ``.npy.h5`` volume, array for array."""
    rng = np.random.default_rng(1)
    image = rng.uniform(-1000, 1000, (3, 8, 8))
    label = rng.integers(0, 9, (3, 8, 8)).astype(np.uint8)
    np.testing.assert_array_equal(port_data.preprocess_ct_volume(image),
                                  jax_pre.preprocess_ct_volume(image))
    for split in ("train", "test"):
        got = port_data.export_synapse_case(image, label, "case0001",
                                            str(tmp_path / "port" / split),
                                            split)
        want = jax_pre.export_synapse_case(image, label, "case0001",
                                           str(tmp_path / "jax" / split),
                                           split)
        assert got == want
    for name in [f"case0001_slice{i:03d}" for i in range(3)]:
        a = np.load(tmp_path / "port" / "train" / f"{name}.npz")
        b = np.load(tmp_path / "jax" / "train" / f"{name}.npz")
        assert sorted(a) == sorted(b) == ["image", "label"]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    with h5py.File(tmp_path / "port" / "test" / "case0001.npy.h5") as a, \
            h5py.File(tmp_path / "jax" / "test" / "case0001.npy.h5") as b:
        assert sorted(a) == sorted(b) == ["image", "label"]
        for k in a:
            np.testing.assert_array_equal(a[k][()], b[k][()])
            assert a[k].dtype == b[k].dtype


# ---------------------------------------------------------------- logging


def test_avg_meter_as_jax():
    port, jax_m = port_log.AvgMeter(num=3), jax_log.AvgMeter(num=3)
    for i, v in enumerate([0.5, 2.0, 1.25, 4.0, 0.75]):
        port.update(v, n=i + 1)
        jax_m.update(v, n=i + 1)
        assert (port.val, port.avg, port.sum, port.count, port.show()) == (
            jax_m.val, jax_m.avg, jax_m.sum, jax_m.count, jax_m.show())
    port.reset()
    assert (port.count, port.losses, port.show()) == (0, [], 0.0)


def test_setup_logging_tees_to_file(tmp_path, capsys):
    logger = port_log.setup_logging(str(tmp_path / "logs"))
    assert logger.name == "pranet2_tpu_torch"
    assert port_log.setup_logging(str(tmp_path / "logs")) is logger
    assert len(logger.handlers) == 2  # set up again: the old ones cleared
    logger.info("epoch 1 loss 0.5")
    for h in logger.handlers:
        h.flush()
    assert "epoch 1 loss 0.5" in capsys.readouterr().out
    assert "epoch 1 loss 0.5" in (tmp_path / "logs" / "log.txt").read_text()
    assert port_log.setup_logging(name="other").level == logging.INFO
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()


# ----------------------------------------------------- reproduce_baseline


def test_constants_are_jax():
    assert rb.DEFAULT_DATASETS == jax_rb.DEFAULT_DATASETS
    assert rb.CKPT_ALIASES == jax_rb.CKPT_ALIASES
    assert rb.EXPECTED_MDICE == jax_rb.EXPECTED_MDICE


def test_verdict_rows_as_jax():
    metrics = ["meanDic", "mae"]
    rows = [["pranet_v2", "CVC-300", 0.8985, 0.01],       # +0.02 pp
            ["pranet_v2", "Kvasir", 0.8990, 0.01],        # -0.80 pp
            ["pranet_v2", "CVC-ColonDB", 0.85, 0.01]]     # no published row
    got, ok = rb.verdict_rows(rows, metrics, rb.EXPECTED_MDICE, 0.4)
    assert (got, ok) == jax_rb.verdict_rows(rows, metrics,
                                            jax_rb.EXPECTED_MDICE, 0.4)
    assert not ok and [r[-1] for r in got] == ["PASS", "FAIL", "n/a"]
    assert rb.verdict_rows(rows[:1], metrics, rb.EXPECTED_MDICE, 0.4)[1]


def test_find_checkpoint_layouts(tmp_path):
    """JAX's ``.pth`` layouts, and the port's parameter files in place of
    JAX's orbax directories."""
    assert rb.find_checkpoint(str(tmp_path), "pranet_v2") is None
    (tmp_path / "PraNet-V2").mkdir()
    (tmp_path / "PraNet-V2" / "pranet_v2.pt").write_bytes(b"x")
    assert rb.find_checkpoint(str(tmp_path), "pranet_v2") == str(
        tmp_path / "PraNet-V2" / "pranet_v2.pt")
    (tmp_path / "pranet_v2.pt").write_bytes(b"x")
    assert rb.find_checkpoint(str(tmp_path), "pranet_v2") == str(
        tmp_path / "pranet_v2.pt")
    (tmp_path / "RES-V2.pth").write_bytes(b"x")
    assert rb.find_checkpoint(str(tmp_path), "pranet_v2") == str(
        tmp_path / "RES-V2.pth")
    (tmp_path / "PVT-PraNet-V2").mkdir()
    (tmp_path / "PVT-PraNet-V2" / "PVT-V2.pth").write_bytes(b"x")
    for model in ("pranet_v2", "pvt_pranet_v2", "pranet_v1"):
        assert (rb.find_checkpoint(str(tmp_path), model)
                == jax_rb.find_checkpoint(str(tmp_path), model))
    # a directory alone is JAX's orbax layout, not a port checkpoint
    (tmp_path / "pranet_v1").mkdir()
    assert rb.find_checkpoint(str(tmp_path), "pranet_v1") is None


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
def baseline(tmp_path_factory):
    """Two sets of two images, ``pranet_v2`` as a reference ``.pth``, and
    JAX's table of them (its printed rows)."""
    root = tmp_path_factory.mktemp("baseline")
    rng = np.random.default_rng(0)
    for ds in SETS:
        (root / "data" / ds / "images").mkdir(parents=True)
        (root / "data" / ds / "masks").mkdir()
        for j in range(2):
            img = (rng.random((40, 48, 3)) * 255).astype(np.uint8)
            m = (rng.random((40, 48)) > 0.5).astype(np.uint8) * 255
            Image.fromarray(img).save(root / "data" / ds / "images" / f"{j}.png")
            Image.fromarray(m).save(root / "data" / ds / "masks" / f"{j}.png")
    v = random_variables(jax_get_model("pranet_v2", num_class=1),
                         jnp.zeros((1, TESTSIZE, TESTSIZE, 3)), seed=11)
    sd = state_dict_from_jax(v)
    # the grayscale stem, which JAX's RGB tree lacks and a reference
    # checkpoint holds
    stem = get_model("pranet_v2", device="cpu", num_class=1).state_dict()
    sd.update({k: t for k, t in stem.items() if k.startswith("conv.")})
    (root / "ckpt").mkdir()
    torch.save({"state_dict": {f"module.{k}": t for k, t in sd.items()}},
               root / "ckpt" / "RES-V2.pth")
    mp = pytest.MonkeyPatch()
    try:  # JAX's CLI reads sys.argv; 'default' leaves its precision alone
        mp.setattr(sys, "argv", ["reproduce_baseline", *_argv(root, "jax"),
                                 "--precision", "default"])
        from io import StringIO
        out = StringIO()
        mp.setattr(sys, "stdout", out)
        jax_rb.main()
    finally:
        mp.undo()
    rows = [ln.split() for ln in out.getvalue().splitlines()
            if ln.startswith("pranet_v2 ")]
    return root, sd, rows


def _argv(root, tag, ckpt="ckpt"):
    return ["--data_root", str(root / "data"), "--ckpt_dir",
            str(root / ckpt), "--models", "pranet_v2", "--datasets", *SETS,
            "--testsize", str(TESTSIZE), "--batchsize", "2", "--save_root",
            str(root / tag)]


def _assert_rows_are_jax(got, want):
    assert [r[:2] for r in got] == [w[:2] for w in want] == [
        ["pranet_v2", ds] for ds in SETS]
    for r, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(r[2:], np.float64),
                                   np.asarray(w[2:], np.float64),
                                   rtol=0, atol=METRIC_TOL, err_msg=r[1])


def test_main_gives_jax_table_on_the_same_pth(baseline, capsys):
    """The port's command on JAX's ``.pth``: JAX's rows and PNGs (one
    uint8 level), the table printed, TF32 flags restored."""
    root, _, want = baseline
    flags = torch.backends.cudnn.allow_tf32
    rows = rb.main([*_argv(root, "port"), "--device", "cpu"])
    assert torch.backends.cudnn.allow_tf32 == flags
    out = capsys.readouterr().out
    assert "pranet_v2/CVC-300: 2 maps" in out and "meanDic" in out
    printed = [ln.split() for ln in out.splitlines()
               if ln.startswith("pranet_v2 ")]
    _assert_rows_are_jax(printed, want)
    _assert_rows_are_jax(rows, want)
    for ds in SETS:
        for j in range(2):
            a = np.array(Image.open(root / "port" / "pranet_v2" / ds /
                                    f"{j}.png")).astype(np.int32)
            b = np.array(Image.open(root / "jax" / "pranet_v2" / ds /
                                    f"{j}.png")).astype(np.int32)
            assert a.shape == (40, 48) and np.abs(a - b).max() <= 1


def test_main_on_a_port_checkpoint_and_the_verdict(baseline, tmp_path,
                                                   capsys):
    """A port parameter file (``save_params``) gives the same table; the
    verdict passes at a wide tolerance and exits 1 at an unmeetable one."""
    root, sd, want = baseline
    model = get_model("pranet_v2", device="cpu", num_class=1)
    model.load_state_dict(sd)
    save_params(str(root / "port_ckpt" / "pranet_v2.pt"), model.state_dict())
    expect = tmp_path / "expect.json"
    expect.write_text('{"pranet_v2": {"CVC-300": 50.0}}')
    argv = [*_argv(root, "port_pt", "port_ckpt"), "--device", "cpu",
            "--expect_json", str(expect)]
    rows = rb.main(argv + ["--tol_pp", "100"])
    out = capsys.readouterr().out
    assert "predicting with" in out and "pranet_v2.pt" in out
    assert "parity verdict: PASS" in out
    assert "n/a" in out  # Kvasir has no expectation in the file
    _assert_rows_are_jax(rows, want)
    expect.write_text('{"pranet_v2": {"CVC-300": 99.9}}')
    with pytest.raises(SystemExit) as ei:
        rb.main(argv + ["--tol_pp", "0.1"])
    assert ei.value.code == 1
    assert "parity verdict: FAIL" in capsys.readouterr().out


def test_help():
    r = subprocess.run([sys.executable, "-m",
                        "pranet2_tpu_torch.cli.reproduce_baseline", "--help"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "--expect" in r.stdout and "--device" in r.stdout

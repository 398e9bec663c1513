"""The port's data parallelism on the CPU: gloo ranks against one process.

The counterpart of ``tests/test_parallel.py`` (JAX's 8-device mesh step
equal to its 1-device step) and of JAX's mesh predictor
(``tests/test_serve.py``).  The ranks are spawned processes
(``tests/torch_parallel_ranks.py``: spawn start method, one intra-op thread
each, a file store under ``tmp_path``, a 60 s timeout on every collective
and a limit on the whole launch); the world-1 reference runs the same
function in this process, without a group.  Everything is float64.

Tolerances: ``SyncBatchNorm`` against ``nn.BatchNorm2d`` within 1e-12
(float64 summation order); a train step's loss within 1e-9 relative, its
gradients within atol 1e-8 and rtol 1e-6, the BatchNorm statistics within
atol 1e-10 and rtol 1e-8, the parameters after clip + Adam within atol
5e-9 and rtol 1e-8 (``tests/test_torch_port_train_step.py``'s, where Adam's
g / (|g| + 1e-8) near |g| ~ 1e-8 turns ordering noise into such updates);
the ranks' copies within 1e-12 relative of each other (gloo's all-reduce
may sum in another order on each rank); the predictors at most one uint8
level apart (a batch of another size can take other CPU convolution
kernels).
"""

import os
import re
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from PIL import Image
from torch import nn

import torch_parallel_ranks as ranks
from pranet2_tpu_torch import get_model, parallel
from pranet2_tpu_torch.data import BatchLoader
from pranet2_tpu_torch.nn import DropPath, Dropout, _drop, drop_path_seeder
from pranet2_tpu_torch.parallel import SyncBatchNorm, convert_sync_batchnorm
from pranet2_tpu_torch.serve import BinaryPredictor

LOSS_RTOL = 1e-9
GRAD_TOL = dict(atol=1e-8, rtol=1e-6)
STATS_TOL = dict(atol=1e-10, rtol=1e-8)
PARAM_TOL = dict(atol=5e-9, rtol=1e-8)
RANKS_RTOL = 1e-12  # gloo may sum in another order on each rank


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this process (the ranks take one each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def one_block(monkeypatch):
    table, key, entry = ranks.one_block_res2net()
    monkeypatch.setitem(table, key, entry)


def _close(got, want, what, **tol):
    for k, w in want.items():
        if w is None:
            assert got[k] is None, f"{what} {k}: a gradient where none"
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                   err_msg=f"{what} {k}", **tol)


# ----------------------------------------------------------- SyncBatchNorm


def test_sync_batchnorm_four_ranks_equal_global_batchnorm(tmp_path):
    """Four ranks of 2 rows against ``nn.BatchNorm2d`` on all 8: output,
    dx, the weight's and bias's gradients (each rank's own sums, which DDP
    averages: summed here), running mean and variance (n / (n - 1) of the
    global count), ``num_batches_tracked``; eval mode sends nothing."""
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal((8, 5, 6, 7)) * 3 + 2)
          for _ in range(2)]
    dy = torch.from_numpy(rng.standard_normal((8, 5, 6, 7)))
    w, b = (torch.from_numpy(rng.standard_normal(5)) for _ in range(2))
    got = ranks.launch(ranks.syncbn_rank, 4, tmp_path, xs, dy, w, b)
    want = ranks.syncbn_rank(xs, dy, w, b)
    assert want["kind"] == "BatchNorm2d"
    assert {r["kind"] for r in got} == {"SyncBatchNorm"}
    tol = dict(rtol=0, atol=1e-12)
    for k in ("y", "dx", "y_eval"):
        torch.testing.assert_close(torch.cat([r[k] for r in got]), want[k],
                                   **tol)
    for k in ("dw", "db"):
        torch.testing.assert_close(sum(r[k] for r in got), want[k], **tol)
    for r in got:
        torch.testing.assert_close(r["mean"], want["mean"], **tol)
        torch.testing.assert_close(r["var"], want["var"], **tol)
        assert r["tracked"] == want["tracked"] == 2
        assert r["eval_reduces"] == 0


def test_sync_batchnorm_without_group_is_batchnorm():
    """World 1, no group: ``SyncBatchNorm`` is ``nn.BatchNorm2d`` bit for
    bit, forward, backward and running statistics."""
    assert not dist.is_initialized()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 4, 5, 5)))
    plain = nn.BatchNorm2d(4).double()
    sync = convert_sync_batchnorm(nn.BatchNorm2d(4).double())
    assert type(sync) is SyncBatchNorm
    outs = []
    for bn in (plain, sync):
        xi = x.clone().requires_grad_()
        y = bn(xi)
        y.square().sum().backward()
        outs.append((y, xi.grad, bn.weight.grad, bn.running_var))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_convert_swaps_batchnorms_only():
    """MaxViT (its MbConv and stem BatchNorms, its LayerNorms): every
    ``nn.BatchNorm2d`` becomes a ``SyncBatchNorm`` holding the same tensors;
    no other module changes, the ``state_dict`` keeps its keys."""
    from pranet2_tpu_torch.models.backbones.maxvit import maxvit

    model = maxvit("maxvit_dryrun", img_size=64)
    before = {k: v.data_ptr() for k, v in model.state_dict().items()}
    kinds = [type(m) for m in model.modules()]
    n_bn = sum(k is nn.BatchNorm2d for k in kinds)
    assert convert_sync_batchnorm(model) is model
    after = [type(m) for m in model.modules()]
    assert n_bn > 3 and sum(k is SyncBatchNorm for k in after) == n_bn
    assert [k for k in after if k is not SyncBatchNorm] == [
        k for k in kinds if k is not nn.BatchNorm2d]
    assert {k: v.data_ptr() for k, v in model.state_dict().items()} == before


# ------------------------------------------------------- world 1, no group


def test_world_one_wraps_nothing(monkeypatch):
    """No torchrun environment (or a world of 1): no group, rank 0 of 1,
    ``data_parallel`` returns the model itself and the masks are drawn
    for the local batch alone."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.init_from_env("cpu") == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert parallel.init_from_env("cpu") == (0, 1)
    assert not dist.is_initialized()
    assert (parallel.rank(), parallel.world(), parallel.is_main()) == (
        0, 1, True)
    model = nn.Sequential(nn.Conv2d(1, 2, 1), nn.BatchNorm2d(2), DropPath(.5))
    assert parallel.data_parallel(model) is model
    assert type(model[1]) is nn.BatchNorm2d
    drop_path_seeder(model, 0)(0)
    assert model[2].shard == (0, 1)
    x = torch.ones(3)
    assert parallel.all_mean(x) is x and parallel.gather_rows(x) is x
    assert parallel.broadcast_object({"a": 1}) == {"a": 1}


def test_masks_are_the_global_batch_rows():
    """A rank's drop-path and dropout masks are its rows of the mask the
    whole batch draws from the same generator; a dropout over a tensor
    with no batch rows draws the one mask on every rank."""
    x = torch.ones((4, 3, 2, 2), dtype=torch.float64)
    full = _drop(torch.ones((16, 3, 2, 2), dtype=torch.float64), 0.5,
                 (16, 1, 1, 1), torch.Generator().manual_seed(3))
    for r in range(4):
        got = _drop(x, 0.5, (4, 1, 1, 1), torch.Generator().manual_seed(3),
                    (r, 4))
        torch.testing.assert_close(got, full[4 * r:4 * (r + 1)], rtol=0,
                                   atol=0)
    elem = _drop(torch.ones((8, 5)), 0.3, (8, 5),
                 torch.Generator().manual_seed(1))
    torch.testing.assert_close(
        _drop(torch.ones((4, 5)), 0.3, (4, 5),
              torch.Generator().manual_seed(1), (1, 2)), elem[4:])
    model = nn.Sequential(nn.Linear(2, 2), DropPath(.1), Dropout(.1),
                          Dropout(.1, batch=False))
    drop_path_seeder(model, 0, (1, 4))(0)
    assert [m.shard for m in model[1:]] == [(1, 4), (1, 4), (0, 1)]


def test_uneven_batches_raise():
    """As JAX's sharding: a batch that does not split over the ranks or
    the devices raises, in the loader and the predictor."""
    with pytest.raises(ValueError, match="not divisible over 2 ranks"):
        parallel.shard_rows(5, 0, 2)
    assert parallel.shard_rows(6, 1, 3) == slice(2, 4)
    ds = [(np.zeros(2), np.zeros(1))] * 6
    with pytest.raises(ValueError, match="not divisible"):
        BatchLoader(ds, 3, rank=0, world=2)
    loader = BatchLoader(ds, 4, rank=1, world=2, drop_last=False)
    assert [b[0].shape[0] for b in loader] == [2, 1]
    loader = BatchLoader(ds + ds[:1], 4, rank=1, world=2, drop_last=False)
    with pytest.raises(ValueError, match="batch of 3 rows"):
        list(loader)
    sd = get_model("pranet_v1_resnet", device="cpu").state_dict()
    with pytest.raises(ValueError,
                       match="batch_size 4 not divisible by the 3-device"):
        BinaryPredictor("pranet_v1_resnet", sd, batch_size=4, testsize=32,
                        devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="not both"):
        BinaryPredictor("pranet_v1_resnet", sd, batch_size=4, testsize=32,
                        device="cpu", devices=["cpu"])


# ------------------------------------------------------------ train steps


def _binary_batch(n):
    rng = np.random.default_rng(42)
    x = rng.standard_normal((n, 64, 64, 3))
    gts = (rng.random((n, 64, 64, 1)) > 0.6).astype(np.float64)
    return x, gts


def test_binary_step_eight_ranks_equal_one(tmp_path, one_block):
    """PraNet-V2 (one block a stage) at 64 x 64, global batch 8: 8 ranks
    of 1 row against 1 process, two clip + Adam steps (mirrors
    ``tests/test_parallel.py:52-85``).  The grayscale stem, which an RGB
    batch does not reach, has no gradient on either side."""
    x, gts = _binary_batch(8)
    got = ranks.launch(ranks.binary_steps, 8, tmp_path, x, gts, 2, True)
    want = ranks.binary_steps(x, gts, 2, False)
    assert want["kind"] == "PraNetV2"
    assert {r["kind"] for r in got} == {"DistributedDataParallel"}
    g = got[0]
    np.testing.assert_allclose(g["losses"], want["losses"], rtol=LOSS_RTOL)
    stem = [k for k, v in want["grads"].items() if v is None]
    assert stem == ["conv.0.weight", "conv.0.bias", "conv.1.weight",
                    "conv.1.bias"]
    _close(g["grads"], want["grads"], "grad", **GRAD_TOL)
    stats = {k: v for k, v in want["first"].items() if "running" in k}
    assert len(stats) > 100
    _close(g["first"], stats, "batch stat", **STATS_TOL)
    _close(g["last"], want["last"], "param after 2 steps", **PARAM_TOL)
    for r in got[1:]:
        np.testing.assert_allclose(r["losses"], g["losses"], rtol=RANKS_RTOL)
        torch.testing.assert_close(r["last"], ranks.digest(g["last"]),
                                   rtol=RANKS_RTOL, atol=0)


def _emcad_batch():
    rng = np.random.default_rng(7)
    images = rng.standard_normal((4, 1, 64, 64))
    labels = rng.integers(0, 4, (4, 64, 64))
    return images, labels


def _merit_batch():
    rng = np.random.default_rng(1)
    images = rng.standard_normal((8, 1, 32, 32))
    labels = rng.integers(0, 4, (8, 32, 32))
    return images, labels


@pytest.fixture(scope="module")
def emcad_steps(tmp_path_factory):
    """EMCAD's steps on 4 ranks (each with its per-rank-mask negative
    control, from the same launch) and in 1 process."""
    batch = _emcad_batch()
    got = ranks.launch(ranks.multiclass_and_fault, 4,
                       tmp_path_factory.mktemp("emcad"), ranks.EMCAD, *batch,
                       2, "per_rank_masks")
    return got, ranks.multiclass_steps(ranks.EMCAD, *batch, 2)


@pytest.fixture(scope="module")
def merit_steps(tmp_path_factory):
    """MERIT's steps on 4 ranks (each with its sharded-table negative
    control, from the same launch) and in 1 process."""
    batch = _merit_batch()
    got = ranks.launch(ranks.multiclass_and_fault, 4,
                       tmp_path_factory.mktemp("merit"), ranks.MERIT, *batch,
                       2, "shard_table")
    return got, ranks.multiclass_steps(ranks.MERIT, *batch, 2)


def _worst_grad(got, want):
    return max(np.abs(got[k].numpy() - w.numpy()).max()
               for k, w in want.items() if w is not None)


def _held_to_one_rank(got, want):
    g = got[0]
    np.testing.assert_allclose(g["losses"], want["losses"], rtol=LOSS_RTOL)
    _close(g["grads"], want["grads"], "grad", **GRAD_TOL)
    _close(g["last"], want["last"], "variable after 2 steps", **PARAM_TOL)
    for r in got[1:]:
        np.testing.assert_allclose(r["losses"], g["losses"], rtol=RANKS_RTOL)
        torch.testing.assert_close(r["last"], ranks.digest(g["last"]),
                                   rtol=RANKS_RTOL, atol=0)


def test_emcad_step_four_ranks_equal_one(emcad_steps):
    """EMCAD on PVTv2-b0 with drop path 0.1, global batch 4 at 64 x 64: 4
    ranks of 1 row against 1 process, two AdamW steps.  Every rank
    computes the Dice over the gathered global batch and draws the masks
    over it, so the loss, the gradients and the update are the 1-process
    ones."""
    got, want = emcad_steps
    _held_to_one_rank([r[0] for r in got], want)


def test_emcad_masks_drawn_per_rank_break_equality(emcad_steps):
    """Negative control: the same 4 ranks with each mask drawn for the
    rank's own row alone train otherwise than 1 process does."""
    got, want = emcad_steps
    worst = _worst_grad(got[0][1]["grads"], want["grads"])
    assert worst > 1e3 * GRAD_TOL["atol"], worst


def test_merit_step_four_ranks_equal_one(merit_steps):
    """MERIT (cascaded, dual, dryrun widths, backbones at 64 and 32) with
    its relative-position dropout, global batch 8 at 32 x 32: 4 ranks of 2
    rows against 1 process, two AdamW steps (mirrors
    ``tests/test_parallel.py``'s MERIT step).  The dropout masks MaxViT's
    shared coordinate table, which has no batch rows: every rank draws the
    one mask the 1-process run draws."""
    got, want = merit_steps
    _held_to_one_rank([r[0] for r in got], want)


def test_merit_table_mask_sharded_breaks_equality(merit_steps):
    """Negative control: the same 4 ranks with the coordinate table's
    dropout drawn as if its rows were the batch's (each rank keeps its own
    rows of a 4x larger draw) train otherwise than 1 process does."""
    got, want = merit_steps
    worst = _worst_grad(got[0][1]["grads"], want["grads"])
    assert worst > 1e3 * GRAD_TOL["atol"], worst


# ------------------------------------------------------------- train loop


@pytest.fixture(scope="module")
def polyps(tmp_path_factory):
    """8 synthetic 48 x 56 polyp images with blob masks."""
    root = tmp_path_factory.mktemp("polyp") / "TrainDataset"
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        img = (rng.random((48, 56, 3)) * 255).astype(np.uint8)
        yy, xx = np.mgrid[:48, :56]
        cy, cx = rng.integers(12, 36), rng.integers(12, 44)
        mask = ((yy - cy) ** 2 + (xx - cx) ** 2 < 100).astype(np.uint8) * 255
        Image.fromarray(img).save(root / "images" / f"{i}.png")
        Image.fromarray(mask).save(root / "masks" / f"{i}.png")
    return str(root)


def _numbers_cut(lines):
    return [re.sub(r"\d+\.\d+s \(.*", "#", ln) for ln in lines]


def test_train_two_ranks_equal_one(tmp_path, polyps):
    """``train.binary.train`` (float64, one block a stage, 64 x 64, global
    batch 4, three scales, one epoch of 6 steps) over 2 ranks against 1
    process: the same ``best`` and history; rank 0 alone logs (the same
    lines), evaluates and writes the snapshot; rank 1 is silent."""
    args = (polyps, str(tmp_path / "snap"), 4, 64, 2)
    got = ranks.launch(ranks.binary_train, 2, tmp_path / "ranks", *args)
    want = ranks.binary_train(polyps, str(tmp_path / "snap1"), 4, 64, 2)
    r0, r1 = got
    assert r0["step"] == r1["step"] == want["step"] == 6
    _close(r0["best"], want["best"], "best", **PARAM_TOL)
    torch.testing.assert_close(r1["best"], ranks.digest(r0["best"]),
                               rtol=RANKS_RTOL, atol=0)
    np.testing.assert_allclose([h["loss"] for h in r0["history"]],
                               [h["loss"] for h in want["history"]],
                               rtol=LOSS_RTOL)
    assert _numbers_cut(r0["lines"]) == _numbers_cut(want["lines"])
    assert len(r0["lines"]) == 5 and r1["lines"] == []
    assert r0["evals"] == want["evals"] == [6] and r1["evals"] == []
    assert [os.path.basename(p) for p in r0["saves"]] == ["epoch_1.pt"]
    assert r1["saves"] == [] and os.listdir(tmp_path / "snap") == [
        "epoch_1.pt"]


@pytest.mark.parametrize("cli", ["train_binary", "train_multiclass"])
def test_cli_leaves_the_group_on_error(tmp_path, monkeypatch, cli):
    """Both training CLIs join the group from the environment and leave it
    when training raises."""
    import importlib

    mod = importlib.import_module(f"pranet2_tpu_torch.cli.{cli}")
    init = tmp_path / "store"

    def join(device=None):
        dist.init_process_group("gloo", init_method=f"file://{init}",
                                rank=0, world_size=1)
        return 0, 1

    def fail(*a, **k):
        assert dist.is_initialized()
        raise RuntimeError("planted")

    monkeypatch.setattr(parallel, "init_from_env", join)
    target = ("pranet2_tpu_torch.train.binary.train" if cli == "train_binary"
              else "pranet2_tpu_torch.train.multiclass.train_multiclass")
    monkeypatch.setattr(target, fail)
    argv = (["--device", "cpu", "--train_path", str(tmp_path)]
            if cli == "train_binary" else
            ["--device", "cpu", "--root_path", str(tmp_path), "--list_dir",
             str(tmp_path), "--encoder", "pvt_v2_b0", "--no-cache"])
    if cli == "train_multiclass":
        monkeypatch.setattr("pranet2_tpu_torch.data.SynapseDataset",
                            lambda *a, **k: types.SimpleNamespace())
    with pytest.raises(RuntimeError, match="planted"):
        mod.main(argv)
    assert not dist.is_initialized()


# ---------------------------------------------------------------- serving


@pytest.mark.parametrize("exact_postproc", [True, False])
def test_predictor_replicas_equal_one_device(exact_postproc):
    """``devices=["cpu"] * 4``: four replicas, each batch of 4 split in
    rows of 1, against ``device="cpu"``; warmup runs every replica."""
    sd = get_model("pranet_v2", device="cpu", num_class=1).state_dict()
    rng = np.random.default_rng(4)
    images = [(rng.random((40 + 7 * i, 50 + 3 * i, 3)) * 255).astype(
        np.uint8) for i in range(6)]
    kw = dict(batch_size=4, testsize=64, exact_postproc=exact_postproc,
              host_workers=0)
    one = BinaryPredictor("pranet_v2", sd, device="cpu", **kw)
    four = BinaryPredictor("pranet_v2", sd, devices=["cpu"] * 4, **kw)
    assert len(four.models) == 4 and four.model is four.models[0]
    assert len({id(m) for m in four.models}) == 4
    four.warmup()
    want, got = one(images), four(images)
    assert len(got) == len(want) == 6
    for im, g, w in zip(images, got, want):
        assert g.shape == im.shape[:2] and g.dtype == np.uint8
        diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
        assert diff.max() <= 1 and (diff != 0).mean() < 1e-2

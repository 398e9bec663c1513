"""Rematerialised training (the trainers' ``remat``) on the CPU, the
profiling helpers and Res2Net-101.

``remat`` checkpoints each backbone block (``nn.remat``,
``nn.checkpointed``); the step keeps one forward's BatchNorm update
(``nn.keep_batchnorm_stats``).  JAX's ``jax.checkpoint`` does not change
values, so a remat step must be the plain step: here bit for bit in
float64 (the losses, the first step's gradients, every parameter and
BatchNorm buffer, ``num_batches_tracked`` included, after two steps) on
models that draw masks: EMCAD on PVTv2-b0 with drop path 0.1 and MERIT at
the dryrun widths (one MaxViT block a stage) with its relative-position
dropout; under bf16 autocast on one-block PraNet-V2, finite and equal.
The steps against JAX's are in ``test_torch_port_train_step.py`` and
``test_torch_port_multiclass_train.py``, beside the fixtures that compile
JAX's.  A negative control drops the masks' replay, and two gloo ranks
with remat are held to one process without it at
``test_torch_port_parallel.py``'s tolerances.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import pranet2_tpu_torch.nn as pnn
import torch_parallel_ranks as ranks
from pranet2_tpu.models.backbones import res2net101_v1b as jax_res2net101
from pranet2_tpu.utils.torch_convert import (convert_state_dict,
                                             res2net_key_map)
from pranet2_tpu_torch import get_model
from pranet2_tpu_torch.models.backbones import (res2net50_v1b,
                                                res2net101_v1b)
from pranet2_tpu_torch.models.backbones.resnet import resnet
from pranet2_tpu_torch.train import TrainState, make_optimizer
from pranet2_tpu_torch.train.binary import make_train_step
from pranet2_tpu_torch.utils import profiling

GRAD_TOL = dict(atol=1e-8, rtol=1e-6)
STATS_TOL = dict(atol=1e-10, rtol=1e-8)
PARAM_TOL = dict(atol=5e-9, rtol=1e-8)
RANKS_RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def one_block(monkeypatch):
    table, key, entry = ranks.one_block_res2net()
    monkeypatch.setitem(table, key, entry)


@pytest.fixture
def checkpoints(monkeypatch):
    """Counts the checkpointed calls ``nn.checkpointed`` makes."""
    calls = []
    real = pnn.checkpoint

    def counted(*args, **kwargs):
        calls.append(type(args[0]).__name__)
        return real(*args, **kwargs)

    monkeypatch.setattr(pnn, "checkpoint", counted)
    return calls


def _equal(got, want, what):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert (g is None) == (w is None), f"{what} {k}"
        if w is not None:
            assert torch.equal(g, w), f"{what} {k}"


# ------------------------------------------------- remat against plain


def _emcad_batch():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((2, 1, 64, 64)),
            rng.integers(0, 4, (2, 64, 64)))


def _merit_batch():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((2, 1, 32, 32)),
            rng.integers(0, 4, (2, 32, 32)))


CASES = {"emcad_pvt_drop_path": (ranks.EMCAD, _emcad_batch, "Block", 8),
         "merit_maxvit_dropout": (ranks.MERIT, _merit_batch, "MaxxVitBlock",
                                  8)}


@pytest.fixture(scope="module")
def plain_steps():
    """Each case's two plain float64 steps, once."""
    return {name: ranks.multiclass_steps(kw, *batch(), 2)
            for name, (kw, batch, _, _) in CASES.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_equals_plain_f64(plain_steps, checkpoints, case):
    """Two AdamW steps with ``remat`` equal the plain steps bit for bit,
    masks drawn, ``num_batches_tracked`` included: each block was
    checkpointed (8 a forward: PVTv2-b0's 2+2+2+2, two MaxViTs of 4)."""
    kw, batch, block, per_step = CASES[case]
    got = ranks.multiclass_steps(kw, *batch(), 2, remat=True)
    want = plain_steps[case]
    assert checkpoints == [block] * (2 * per_step)
    assert got["losses"] == want["losses"]
    _equal(got["grads"], want["grads"], "grad")
    _equal(got["last"], want["last"], "variable after 2 steps")
    assert any(k.endswith("num_batches_tracked") for k in got["last"])


def test_remat_without_mask_replay_differs(plain_steps, monkeypatch):
    """Negative control: the recompute drawing from the generator where
    the forward left it (no state set back) masks other samples, and the
    gradients are wrong with no error."""
    monkeypatch.setattr(pnn, "_mask_generators", lambda block: [])
    kw, batch, _, _ = CASES["emcad_pvt_drop_path"]
    got = ranks.multiclass_steps(kw, *batch(), 1, remat=True)
    want = plain_steps["emcad_pvt_drop_path"]
    assert got["losses"][0] == want["losses"][0]
    worst = max((got["grads"][k] - w).abs().max().item()
                for k, w in want["grads"].items() if w is not None)
    assert worst > 1e3 * GRAD_TOL["atol"], worst


def _binary_step(compute, remat):
    """One step of one-block ``pranet_v2`` (float32 parameters) on a
    seeded 64 x 64 batch of 2: the loss, gradients and ``state_dict``."""
    model = get_model("pranet_v2", device="cpu", num_class=1,
                      generator=torch.Generator().manual_seed(3))
    state = TrainState(model, make_optimizer(model.parameters(), 1e-4,
                                             clip_value=0.5))
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64, 64),
                                             dtype=np.float32))
    gts = torch.from_numpy((rng.random((2, 1, 64, 64)) > 0.6)
                           .astype(np.float32))
    step = make_train_step(model, target_size=64, rescale=False,
                           remat=remat, compute_dtype=compute)
    model.zero_grad()
    state, loss, _ = step(state, x, gts)
    grads = {k: None if p.grad is None else p.grad.clone()
             for k, p in model.named_parameters()}
    return loss, grads, model.state_dict()


def test_remat_bf16_autocast_equals_plain(one_block, checkpoints):
    """Under bf16 autocast, which the recompute takes over: the remat
    step is finite and equal to the plain step (the loss, the
    gradients, the update, the BatchNorm buffers)."""
    loss, grads, sd = _binary_step(torch.bfloat16, remat=True)
    assert checkpoints == ["Bottle2neck"] * 4
    want = _binary_step(torch.bfloat16, remat=False)
    assert torch.isfinite(loss) and loss == want[0]
    assert all(torch.isfinite(g).all() for g in grads.values()
               if g is not None)
    _equal(grads, want[1], "grad")
    _equal(sd, want[2], "variable")


def test_remat_only_in_training_with_autograd(checkpoints):
    """``checkpointed`` checkpoints only under ``remat``, in training,
    with autograd on; without ``keep_batchnorm_stats`` the recompute
    counts each BatchNorm's batch twice."""
    model = resnet("resnet18")
    bn = model.layer4[1].bn2
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    model(x)
    with pnn.remat():
        with torch.no_grad():
            model(x)
        model.eval()
        model(x)
    assert checkpoints == [] and int(bn.num_batches_tracked) == 2
    model.train()
    with pnn.remat():
        out = model(x)
    assert checkpoints == ["Block"] * 8
    with pnn.keep_batchnorm_stats(model):
        sum(o.sum() for o in out).backward()
    assert int(bn.num_batches_tracked) == 3
    with pnn.remat():
        out = model(x)
    sum(o.sum() for o in out).backward()
    assert int(bn.num_batches_tracked) == 5


def test_remat_two_ranks_equal_one_process(tmp_path, one_block):
    """Two gloo ranks of 2 rows with ``remat`` (``SyncBatchNorm`` and DDP
    around checkpointed blocks; each rank recomputes, and reduces, the
    same blocks in the same order) against one process without it:
    one-block PraNet-V2 at 64 x 64, two clip + Adam steps."""
    rng = np.random.default_rng(42)
    x = rng.standard_normal((4, 64, 64, 3))
    gts = (rng.random((4, 64, 64, 1)) > 0.6).astype(np.float64)
    got = ranks.launch(ranks.binary_steps, 2, tmp_path, x, gts, 2, True,
                       None, True)
    want = ranks.binary_steps(x, gts, 2, False)
    assert {r["kind"] for r in got} == {"DistributedDataParallel"}
    g = got[0]
    np.testing.assert_allclose(g["losses"], want["losses"], rtol=1e-9)
    for k, w in want["grads"].items():
        if w is None:
            assert g["grads"][k] is None, k
        else:
            np.testing.assert_allclose(g["grads"][k].numpy(), w.numpy(),
                                       err_msg=k, **GRAD_TOL)
    for k, w in want["first"].items():
        if "running" in k:
            np.testing.assert_allclose(g["first"][k].numpy(), w.numpy(),
                                       err_msg=k, **STATS_TOL)
        elif k.endswith("num_batches_tracked"):
            assert int(g["first"][k]) == int(w), k
    for k, w in want["last"].items():
        np.testing.assert_allclose(g["last"][k].numpy(), w.numpy(),
                                   err_msg=k, **PARAM_TOL)
    np.testing.assert_allclose(got[1]["losses"], g["losses"],
                               rtol=RANKS_RTOL)
    torch.testing.assert_close(got[1]["last"], ranks.digest(g["last"]),
                               rtol=RANKS_RTOL, atol=0)


# ------------------------------------------------------------ profiling


def test_throughput_runs():
    x = torch.ones((8, 32))
    ips = profiling.throughput(lambda a: a * 2, (x,), batch_size=8, iters=5,
                               warmup=1)
    assert ips > 0


def test_count_params():
    assert profiling.count_params(nn.Linear(3, 4)) == 16
    shared = nn.Linear(2, 2, bias=False)
    assert profiling.count_params(nn.Sequential(shared, shared)) == 4


def test_timer_measures_each_call():
    timer = profiling.Timer()
    for _ in range(3):
        with timer.measure() as out:
            out["result"] = torch.ones(4) * 2
    assert len(timer.times) == 3 and timer.mean > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tb")):
        torch.ones((16, 16)).matmul(torch.ones((16, 16)))
    files = os.listdir(tmp_path / "tb")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert os.path.getsize(tmp_path / "tb" / files[0]) > 0


# ------------------------------------------------------------ Res2Net-101


def test_res2net101_keys_round_trip_to_jax():
    """``res2net101_v1b``: 3, 4, 23 and 3 blocks; its ``state_dict``
    through the JAX package's ``res2net_key_map`` is the tree of JAX's
    ``res2net101_v1b`` in names and shapes (``eval_shape`` of the init,
    nothing compiled).  ``res2net50_v1b`` keeps PraNet's 3, 4, 6, 3."""
    model = res2net101_v1b()
    assert [len(getattr(model, f"layer{i}")) for i in range(1, 5)] == [
        3, 4, 23, 3]
    assert [len(getattr(res2net50_v1b(), f"layer{i}"))
            for i in range(1, 5)] == [3, 4, 6, 3]
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    got = convert_state_dict(sd, res2net_key_map)
    jax_model = jax_res2net101()
    want = jax.eval_shape(lambda k, x: jax_model.init(k, x, False),
                          jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    shapes = lambda t: {jax.tree_util.keystr(p): tuple(a.shape)
                        for p, a in jax.tree_util.tree_leaves_with_path(t)}
    assert set(got) == set(want) == {"params", "batch_stats"}
    for part in ("params", "batch_stats"):
        assert shapes(got[part]) == shapes(want[part]), part

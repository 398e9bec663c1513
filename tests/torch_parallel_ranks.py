"""Ranks of a gloo process group on the CPU, for the port's data-parallel
tests, and the work each rank does.  Imports no JAX: the ranks are spawned
processes that import this module afresh.

``launch(fn, world, tmp_dir, *args)`` is the port's
``parallel.spawn.launch`` with one intra-op thread a rank: ``world``
processes started with the ``spawn`` start method (a pytest worker has JAX
loaded, and forking a process that holds JAX's threads can deadlock), a
gloo group joined through a file store under ``tmp_dir`` (no port to
collide on between test workers), ``fn(*args)`` on each.  Each rank's
collectives time out after ``RANK_TIMEOUT_S`` and the parent waits at most
``LAUNCH_TIMEOUT_S`` for all of them: a rank that hangs or dies fails the
test instead of hanging the suite.

The same functions run in the test process itself, without a group, as
the world-1 reference: there ``parallel.world()`` is 1 and nothing is
wrapped.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from pranet2_tpu_torch.parallel import spawn

RANK_TIMEOUT_S = 60
LAUNCH_TIMEOUT_S = 180
LR, CLIP = 1e-4, 0.5
ONE = (1, 1, 1, 1)


def launch(fn, world: int, tmp_dir, *args):
    """``fn(*args)`` on ``world`` spawned gloo ranks of one intra-op thread
    each; their results in rank order."""
    return spawn.launch(fn, world, tmp_dir, *args, threads=1,
                        timeout=LAUNCH_TIMEOUT_S, rank_timeout=RANK_TIMEOUT_S)


def _rows(n: int) -> slice:
    from pranet2_tpu_torch import parallel

    return parallel.shard_rows(n, parallel.rank(), parallel.world())


def digest(state_dict) -> torch.Tensor:
    """Each entry's sum, in float64: enough to see that the ranks hold the
    same weights without sending every rank's copy back."""
    return torch.stack([torch.zeros((), dtype=torch.float64) if v is None
                        else v.double().sum() for v in state_dict.values()])


def _rank0_full(result: dict, heavy) -> dict:
    """``result`` on rank 0 (and without a group); elsewhere its ``heavy``
    entries replaced by their digests."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        return result
    return {k: digest(v) if k in heavy else v for k, v in result.items()}


def one_block_res2net():
    """(dict, key, entry): the port's Res2Net-50 with one block a stage, as
    ``tests/test_torch_port_v1_cli.py`` patches it."""
    from pranet2_tpu_torch.models import pranet as port_pranet
    from pranet2_tpu_torch.models.backbones.res2net import Res2Net

    return (port_pranet._BACKBONES, "res2net50",
            (lambda **kw: Res2Net(**{"layers": ONE, **kw}),
             (512, 1024, 2048)))


# ------------------------------------------------------------ SyncBatchNorm


def syncbn_rank(xs, dy, weight, bias):
    """Two train-mode forwards of ``SyncBatchNorm`` on this rank's rows of
    the global float64 batches ``xs`` (the second differentiated against
    its rows of ``dy``), then one eval forward with ``all_reduce`` counted.
    Without a group: a plain ``nn.BatchNorm2d`` on the whole batch, the
    reference."""
    from pranet2_tpu_torch.parallel import convert_sync_batchnorm

    bn = nn.BatchNorm2d(weight.shape[0], eps=1e-5, momentum=0.1).double()
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    if dist.is_initialized():
        bn = convert_sync_batchnorm(bn)
    rows = _rows(xs[0].shape[0])
    bn(xs[0][rows])
    x = xs[1][rows].clone().requires_grad_()
    y = bn(x)
    y.backward(dy[rows])
    calls = []
    reduce = dist.all_reduce
    dist.all_reduce = lambda *a, **k: calls.append(1) or reduce(*a, **k)
    try:
        bn.eval()
        y_eval = bn(xs[1][rows])
    finally:
        dist.all_reduce = reduce
    return dict(y=y.detach(), dx=x.grad, dw=bn.weight.grad,
                db=bn.bias.grad, mean=bn.running_mean.clone(),
                var=bn.running_var.clone(),
                tracked=int(bn.num_batches_tracked), y_eval=y_eval,
                eval_reduces=len(calls), kind=type(bn).__name__)


# ------------------------------------------------------- binary train step


class _Spy:
    """Records the gradients each ``apply_gradients`` is given."""

    def __init__(self):
        self.grads = []

    def install(self, state):
        apply = state.apply_gradients

        def spy():
            self.grads.append({
                k: None if p.grad is None else p.grad.detach().clone()
                for k, p in state.model.named_parameters()})
            apply()

        state.apply_gradients = spy


def binary_steps(x, gts, n_steps: int, one_block: bool,
                 state_dict=None):
    """``n_steps`` float64 train steps of ``pranet_v2`` (clip + Adam,
    ``make_train_step`` at the batch's size) on this rank's rows of the
    global NHWC batch ``x``/``gts``.  Returns each step's loss averaged
    over the ranks, the first step's gradients, the ``state_dict`` after
    the first step and after the last."""
    from pranet2_tpu_torch import get_model, parallel
    from pranet2_tpu_torch.train import TrainState, make_optimizer
    from pranet2_tpu_torch.train.binary import make_train_step

    if one_block:
        table, key, entry = one_block_res2net()
        table[key] = entry
    model = get_model("pranet_v2", device="cpu", num_class=1,
                      generator=torch.Generator().manual_seed(3)).double()
    if state_dict is not None:
        model.load_state_dict(state_dict)
    net = parallel.data_parallel(model)
    state = TrainState(model, make_optimizer(model.parameters(), LR,
                                             clip_value=CLIP))
    spy = _Spy()
    spy.install(state)
    step = make_train_step(net, target_size=x.shape[1], rescale=False)
    rows = _rows(x.shape[0])
    to_t = lambda a: torch.from_numpy(
        np.ascontiguousarray(a[rows].transpose(0, 3, 1, 2)))
    losses, first = [], None
    for i in range(n_steps):
        state, loss, _ = step(state, to_t(x), to_t(gts))
        losses.append(float(parallel.all_mean(loss)))
        if i == 0:
            first = {k: v.clone() for k, v in model.state_dict().items()}
    return _rank0_full(dict(losses=losses, grads=spy.grads[0], first=first,
                            last=model.state_dict(),
                            kind=type(net).__name__),
                       heavy=("grads", "first", "last"))


# ---------------------------------------------------- multiclass train step


EMCAD = dict(name="emcad", num_classes=4, encoder="pvt_v2_b0")
MERIT = dict(name="merit_cascaded", num_classes=4, model_scale="dryrun",
             img_size_s1=(64, 64), img_size_s2=(32, 32), img_size=32)


def multiclass_steps(model_kw: dict, images, labels, n_steps: int,
                     fault: str | None = None):
    """``n_steps`` float64 train steps (4 classes, AdamW) of the model
    ``model_kw`` names (EMCAD on PVTv2-b0 with drop path 0.1, or MERIT at
    the dryrun widths with its relative-position dropout) on this rank's
    rows of the global batch; each step's loss, the first step's gradients
    and the final ``state_dict``.

    ``fault``, for the negative controls: ``"per_rank_masks"`` draws every
    mask for this rank's rows alone; ``"shard_table"`` treats MaxViT's
    relative-position table as batch rows, so each rank masks it with
    its own rows of a larger draw."""
    import pranet2_tpu_torch.train.multiclass as tm
    from pranet2_tpu_torch import get_model, parallel
    from pranet2_tpu_torch.nn import Dropout
    from pranet2_tpu_torch.train import TrainState, make_optimizer

    kw = dict(model_kw)
    model = get_model(kw.pop("name"), device="cpu",
                      generator=torch.Generator().manual_seed(5),
                      **kw).double()
    seeder = tm.drop_path_seeder
    if fault == "per_rank_masks":
        tm.drop_path_seeder = lambda m, seed, shard: seeder(m, seed)
    elif fault == "shard_table":
        tables = [m for m in model.modules()
                  if isinstance(m, Dropout) and not m.batch]
        assert tables
        for m in tables:
            m.batch = True
    cfg = tm.MulticlassTrainConfig(num_classes=4, img_size=images.shape[-1],
                                   batch_size=images.shape[0])
    net = parallel.data_parallel(model)
    state = TrainState(model, make_optimizer(
        model.parameters(), cfg.lr, clip_value=None,
        weight_decay=cfg.weight_decay))
    spy = _Spy()
    spy.install(state)
    try:
        step = tm.make_multiclass_train_step(net, cfg)
    finally:
        tm.drop_path_seeder = seeder
    rows = _rows(images.shape[0])
    x = torch.from_numpy(images[rows].copy())
    y = torch.from_numpy(labels[rows].copy())
    losses = []
    for _ in range(n_steps):
        state, loss = step(state, x, y)
        losses.append(float(parallel.all_mean(loss)))
    return _rank0_full(dict(losses=losses, grads=spy.grads[0],
                            last=model.state_dict()),
                       heavy=("grads", "last"))


def multiclass_and_fault(model_kw: dict, images, labels, n_steps: int,
                         fault: str):
    """``multiclass_steps`` as it is, then one step with ``fault``: the
    step and its negative control from one launch of the ranks."""
    return (multiclass_steps(model_kw, images, labels, n_steps),
            multiclass_steps(model_kw, images, labels, 1, fault))


# ------------------------------------------------------------ train() loop


class Float64Dataset:
    """A dataset's (image, mask) pairs as float64."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        return tuple(a.astype(np.float64) for a in self.dataset[i])


def _score(model, state) -> float:
    """An epoch's score for the loop tests: the update count, so that the
    last epoch is the best."""
    return float(state.step)


def binary_train(train_path: str, save_dir: str, batch: int, size: int,
                 epochs: int):
    """``train.binary.train`` in float64 on one-block ``pranet_v2`` (as a
    rank or alone); returns its log lines, the snapshot files it saved,
    how many times it evaluated, its ``best`` and its history."""
    import pranet2_tpu_torch.train.binary as tb
    from pranet2_tpu_torch.data import PolypDataset

    table, key, entry = one_block_res2net()
    saved_entry = table[key]
    table[key] = entry
    get_model, save_state = tb.get_model, tb.save_state
    saves, evals, lines = [], [], []
    tb.get_model = lambda *a, **k: get_model(*a, **k).double()
    tb.save_state = lambda path, state: (saves.append(path),
                                         save_state(path, state))

    def eval_fn(model, state):
        evals.append(state.step)
        return _score(model, state)

    try:
        ds = Float64Dataset(PolypDataset(f"{train_path}/images",
                                         f"{train_path}/masks", size))
        cfg = tb.BinaryTrainConfig(
            epochs=epochs, batch_size=batch, trainsize=size, log_every=1,
            snapshot_every=1, save_dir=save_dir, cache_dataset=False,
            device="cpu")
        state, best, history = tb.train(cfg, dataset=ds, eval_fn=eval_fn,
                                        log=lines.append)
    finally:
        tb.get_model, tb.save_state = get_model, save_state
        table[key] = saved_entry
    return _rank0_full(dict(lines=lines, saves=saves, evals=evals,
                            best=best, history=history, step=state.step),
                       heavy=("best",))

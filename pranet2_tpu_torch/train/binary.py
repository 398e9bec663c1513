"""PraNet-V2 binary training, on one device or data-parallel, and PraNet
inference loops.

Port of ``pranet2_tpu/train/binary.py``.  The recipe reproduces
``binary_seg/MyTrain_med.py``: multi-scale training at rates 0.75, 1 and
1.25 of ``trainsize`` (each rate an independent forward, backward and
update on the same batch, rescaled by bilinear ``align_corners=True``;
``bg = 1 - gts``), the 4 structure losses summed, Adam with a +/-0.5 value
clip and step LR decay, and an in-memory evaluation each epoch on held-out
datasets that keeps ``best`` by the caller's score (the reference: summed
meanDice, ``MyTrain_med.py:152-172``).

The train forward is the module chain (the kernels are forward only, as
JAX trains on its module path): the Res2Net stem pools with
``F.max_pool2d`` and each DSRA gate runs ``ops.dsra_gate``, whose forward is
the hand-written kernel on the card and whose backward differentiates its
plain math.  The evaluation is the serving path (eval, inference mode): on
the card the stem and decoder kernels (``stem_pool``, ``dsra_level``).

``dtype="bfloat16"`` keeps the parameters, the BatchNorm statistics and
Adam in float32 and runs the forward under ``torch.autocast`` in bf16; the
losses promote to float32.  Its evaluation serves a bf16 copy of the
weights (``get_model(..., dtype=torch.bfloat16)``): the kernel wrappers
take one element type, which autocast's mixed types would break.

Data parallel (a process group, ``parallel.init_from_env``): as JAX's
mesh, ``cfg.batch_size`` is the global batch, split in contiguous rows
over the ranks (a batch that does not split raises); each rank decodes its
own rows, the model is wrapped by ``parallel.data_parallel``
(synchronized BatchNorm, averaged gradients), the structure losses are
means over images, so the average of the ranks' losses is the global
batch's, and drop path draws its masks over the global batch.  Rank 0
alone logs (the loss averaged over the ranks), saves and evaluates; the
score goes to every rank, which keep the same ``best``.  Without a group
nothing is wrapped.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections.abc import Sequence

import numpy as np
import torch
from scipy.special import expit
from torch import nn

from pranet2_tpu_torch import parallel
from pranet2_tpu_torch.data import (BatchLoader, CachedDataset,
                                    DevicePrefetcher, PolypDataset,
                                    PolypTestDataset)
from pranet2_tpu_torch.device import resolve
from pranet2_tpu_torch.evalx import (aggregate_dataset_metrics,
                                     binary_image_metrics)
from pranet2_tpu_torch.losses import structure_loss
from pranet2_tpu_torch.losses.binary import _boundary_weight
from pranet2_tpu_torch.models import get_model
from pranet2_tpu_torch.nn import (drop_path_seeder, keep_batchnorm_stats,
                                  remat as remat_scope)
from pranet2_tpu_torch.ops import resize_bilinear, resize_bilinear_np
from pranet2_tpu_torch.serve import is_v2, served_logits
from pranet2_tpu_torch.train.optim import make_optimizer, step_decay_schedule
from pranet2_tpu_torch.train.state import TrainState
from pranet2_tpu_torch.utils.checkpoint import save_state
from pranet2_tpu_torch.utils.profiling import span

COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class BinaryTrainConfig:
    model: str = "pranet_v2"          # or 'pvt_pranet_v2'
    epochs: int = 30
    lr: float = 1e-4
    batch_size: int = 8
    trainsize: int = 352
    clip: float = 0.5
    decay_rate: float = 0.1
    decay_epoch: int = 50
    size_rates: tuple[float, ...] = (0.75, 1.0, 1.25)
    seed: int = 0
    train_path: str = "./data/TrainDataset"
    test_root: str = "./data/TestDataset"
    eval_datasets: tuple[str, ...] = ("CVC-300", "CVC-ClinicDB")
    save_dir: str = "./snapshots/pranet_v2"
    snapshot_every: int = 10
    log_every: int = 20
    dtype: str = "float32"             # 'bfloat16' for bf16 compute
    remat: bool = False                # memory<->FLOPs: checkpointed blocks
    cache_dataset: bool = True         # preload+RAM-cache the (small) train set
    device: str | None = None          # the card unless given ('cpu')


def _rate_size(trainsize: int, rate: float) -> int:
    return int(round(trainsize * rate / 32) * 32)


def dtype_of(name: str) -> torch.dtype | None:
    """The compute type of a config's ``dtype`` name (None: float32)."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"dtype must be one of {sorted(COMPUTE_DTYPES)}, "
                         f"got {name!r}")
    return COMPUTE_DTYPES[name]


def train_loss(model: nn.Module, images: torch.Tensor, gts: torch.Tensor,
               compute_dtype: torch.dtype | None = None):
    """The recipe's loss on one NCHW batch: the 4 structure losses of the
    model's (fg, bg) map pairs against ``gts`` and ``1 - gts``, the
    boundary weight computed once.  Returns (sum, [4 losses])."""
    bg = 1.0 - gts
    autocast = (torch.autocast(images.device.type, dtype=compute_dtype)
                if compute_dtype is not None else contextlib.nullcontext())
    with autocast:
        outs = model(images)
    weit = _boundary_weight(gts.to(torch.promote_types(gts.dtype,
                                                       torch.float32)))
    losses = [structure_loss(f, b, gts, bg, weit=weit)
              for f, b in zip(outs[:4], outs[4:])]
    return sum(losses), losses


def make_train_step(model: nn.Module, *, target_size: int, rescale: bool,
                    remat: bool = False,
                    compute_dtype: torch.dtype | None = None, seed: int = 0):
    """The train step at one scale: ``step(state, images, gts)`` takes NCHW
    images and masks on the model's device, updates ``state`` in place and
    returns ``(state, loss, losses)``.  ``model`` is the state's model or
    its ``parallel.data_parallel`` wrapper; in a process group the images
    are this rank's rows and the loss is this rank's.

    The model's ``DropPath`` modules draw from one generator on its device,
    seeded from ``seed`` and the state's step before each forward, as JAX
    folds its dropout key by the step.

    ``remat``: JAX's ``jax.checkpoint`` of the forward.  Here the backbone
    checkpoints each block (``nn.remat``, ``nn.checkpointed``), which
    computes the same values and is what saves memory in eager mode (a
    checkpoint of the whole forward would rebuild every activation before
    the backward); the decoder keeps its activations.  The loss, the
    gradients, the update and the BatchNorm statistics are the plain
    step's (``nn.keep_batchnorm_stats``); a second forward through the
    backbone's blocks is the cost.

    Spans (``utils.profiling.span``, recorded only while recording is on):
    ``train.forward`` (the rescale and the loss; the model's
    ``model.forward`` inside it), ``train.backward`` (``zero_grad`` and the
    backward), ``train.update`` (the clamp and Adam's update).
    """
    reseed = drop_path_seeder(model, seed,
                              (parallel.rank(), parallel.world()))

    def step(state: TrainState, images: torch.Tensor, gts: torch.Tensor):
        with span("train.forward"):
            if rescale:
                size = (target_size, target_size)
                images = resize_bilinear(images, size, align_corners=True)
                gts = resize_bilinear(gts, size, align_corners=True)
            model.train()
            reseed(state.step)  # the steps of other scales share the modules
            with remat_scope(remat):
                loss, losses = train_loss(model, images, gts, compute_dtype)
        with span("train.backward"):
            state.optimizer.zero_grad()
            with keep_batchnorm_stats(model, remat):
                loss.backward()
        with span("train.update"):
            state.apply_gradients()
        return state, loss.detach(), torch.stack(losses).detach()

    return step


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2).contiguous()


def train(cfg: BinaryTrainConfig, dataset=None, eval_fn=None, log=print):
    """Full training run.  Returns the final ``TrainState``, the best
    epoch's variables (a detached copy of the model's ``state_dict``; None
    without ``eval_fn``) and the per-epoch history.

    ``eval_fn(model, state)`` scores an epoch (higher is better); ``model``
    holds the state's weights in the run's compute type.  The epoch loop
    keeps the reference's ``range(1, epochs)``: ``epochs - 1`` epochs.

    The recipe trains PraNet-V2 models only, as the JAX package's (whose
    ``get_model(name, num_class=1)`` refuses a V1 model): a V1 name raises
    ``TypeError`` before any data is read.

    In a process group (see the module's docstring) every rank calls it;
    ``log``, ``eval_fn`` and the snapshots run on rank 0 only.
    """
    if not is_v2(cfg.model):
        raise TypeError(f"{cfg.model}: the binary recipe trains PraNet-V2 "
                        f"models only (pranet_v2, pvt_pranet_v2)")
    rank, world = parallel.rank(), parallel.world()
    parallel.shard_rows(cfg.batch_size, rank, world)  # raises if uneven
    main = rank == 0
    log = parallel.main_only(log)
    dev = resolve(cfg.device)
    compute = dtype_of(cfg.dtype)
    dataset = dataset or PolypDataset(
        os.path.join(cfg.train_path, "images"),
        os.path.join(cfg.train_path, "masks"), cfg.trainsize)
    if cfg.cache_dataset:
        dataset = CachedDataset(dataset)
    model = get_model(cfg.model, device=dev, num_class=1,
                      generator=torch.Generator().manual_seed(cfg.seed))
    net = parallel.data_parallel(model)
    loader = BatchLoader(dataset, cfg.batch_size, seed=cfg.seed, rank=rank,
                         world=world)
    steps_per_epoch = len(loader) * len(cfg.size_rates)
    schedule = step_decay_schedule(cfg.lr, cfg.decay_rate, cfg.decay_epoch,
                                   steps_per_epoch)
    state = TrainState(model, make_optimizer(model.parameters(), schedule,
                                             clip_value=cfg.clip))
    steps = {rate: make_train_step(net,
                                   target_size=_rate_size(cfg.trainsize, rate),
                                   rescale=rate != 1.0, remat=cfg.remat,
                                   compute_dtype=compute, seed=cfg.seed)
             for rate in cfg.size_rates}
    eval_model = None
    best_score, best = -1.0, None
    history = []
    for epoch in range(1, cfg.epochs):
        t0 = time.time()
        n_img = 0
        loss = None
        for i, (images, gts) in enumerate(DevicePrefetcher(loader, dev),
                                          start=1):
            images, gts = _nchw(images), _nchw(gts)
            for rate in cfg.size_rates:
                state, loss, _ = steps[rate](state, images, gts)
            n_img += images.shape[0] * world
            if i % cfg.log_every == 0:
                log(f"epoch {epoch} step {i}/{len(loader)} "
                    f"loss {float(parallel.all_mean(loss)):.4f}")
        if n_img == 0:
            raise RuntimeError(
                f"epoch {epoch}: training dataset produced no batches "
                f"(check train_path / batch_size)")
        # a device sync: the epoch's time includes its work
        loss = float(parallel.all_mean(loss))
        dt = time.time() - t0
        history.append(dict(epoch=epoch, sec=dt, loss=loss,
                            img_per_sec=n_img * len(cfg.size_rates) / dt))
        log(f"epoch {epoch}: {dt:.1f}s ({history[-1]['img_per_sec']:.1f} "
            f"train img/s incl. {len(cfg.size_rates)} scales)")

        if main and cfg.snapshot_every and epoch % cfg.snapshot_every == 0:
            save_state(os.path.join(cfg.save_dir, f"epoch_{epoch}.pt"), state)
            log(f"epoch {epoch}: snapshot saved")

        if eval_fn is not None:
            score = None
            if main:
                if compute is None:
                    target = model
                else:
                    if eval_model is None:
                        eval_model = get_model(cfg.model, device=dev,
                                               dtype=compute, num_class=1)
                    eval_model.load_state_dict(state.variables)
                    target = eval_model
                score = eval_fn(target, state)
            score = parallel.broadcast_object(score)
            if score > best_score:
                best_score = score
                best = {k: v.detach().clone()
                        for k, v in state.variables.items()}
                log(f"epoch {epoch}: new best score {score:.4f}")
    return state, best, history


# ---------------------------------------------------------------------------
# inference / prediction export (MyTest_med.py equivalents)
# ---------------------------------------------------------------------------


def make_predict_fn(model: nn.Module, v2: bool = True):
    """Batched eval forward -> summed fg logits (V2; V1: ``outs[3]``, the
    finest map, as the reference uses res2) at test resolution.  Takes an
    NCHW batch of any strides on any device; runs on the model's."""
    dev = next(model.parameters()).device

    def fwd(images: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            # contiguous NCHW: the stem and decoder kernels take no other
            return served_logits(model(images.to(dev).contiguous()), v2)

    return fwd


def predict_to_maps(fwd, test_ds: PolypTestDataset, batch_size: int = 16):
    """Yield (name, uint8 prediction at native GT size, native gt) per image.

    Post-processing matches ``MyTest_med.py:104-111``: bilinear resize to GT
    size (align_corners=False) -> sigmoid -> min-max normalize -> uint8, on
    the host, one image at a time (the sizes vary).
    """
    for images, gts, names, real in test_ds.batches(batch_size):
        logits = fwd(torch.from_numpy(images).permute(0, 3, 1, 2))
        logits = logits.float().cpu().numpy()[:real]
        for logit, gt, name in zip(logits, gts[:real], names[:real]):
            yield name, _postprocess(logit, gt.shape), gt


def _postprocess(logit_1hw: np.ndarray, gt_shape) -> np.ndarray:
    x = resize_bilinear_np(np.asarray(logit_1hw), tuple(gt_shape))[0]
    x = expit(x)
    x = (x - x.min()) / (x.max() - x.min() + 1e-8)
    return (x * 255).astype(np.uint8)


def test_with_eval(model: nn.Module, test_root: str,
                   datasets: Sequence[str], testsize: int = 352,
                   batch_size: int = 16, v2: bool = True):
    """In-memory evaluation across datasets (``MyTest_med.py:15-46``).

    Returns {dataset: {metric: value}} using the full metric suite.
    """
    fwd = make_predict_fn(model, v2=v2)
    results = {}
    for ds_name in datasets:
        ds = PolypTestDataset(os.path.join(test_root, ds_name, "images"),
                              os.path.join(test_root, ds_name, "masks"),
                              testsize)
        per_image = [binary_image_metrics(pred, _norm_gt(gt))
                     for _, pred, gt in predict_to_maps(fwd, ds, batch_size)]
        results[ds_name] = aggregate_dataset_metrics(per_image)
    return results



def _norm_gt(gt: np.ndarray) -> np.ndarray:
    gt = np.asarray(gt, np.float32)
    return gt / (gt.max() + 1e-8)

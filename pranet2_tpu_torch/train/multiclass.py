"""Multiclass (Synapse/ACDC) training, on one device or data-parallel, and
volumetric inference.

Port of ``pranet2_tpu/train/multiclass.py``.  The recipe reproduces the
reference trainers (``multiclass_seg/EMCAD/trainer.py:48-200``,
``multiclass_seg/MERIT/train_ACDC.py:240-350``): MUTATION powerset
supervision (dual: 0.5*CE + 0.7*Dice + 0.3*bg-BCE; single: 0.3*CE +
0.7*Dice), AdamW (lr 1e-4, weight decay 1e-4) at a constant rate with no
clip, per-epoch slice-wise validation (``val_single_volume``) from
``eval_from_frac`` of the epochs on, and a best checkpoint gated by
``best_threshold``.

Volumetric inference (``test_single_volume``,
``MERIT/utils/utils.py:172-264``) loops over slices at batch 1 in the
reference; here the volume is copied to the model's device once and its
slices zoomed to the patch size there (``ops.volume_zoom.zoom_slices``:
scipy's order-3 zoom, a kernel on the card, its plain version on the CPU),
the device runs a chunked forward (the last chunk padded to ``chunk``, as
the JAX package pads it), combines the maps by ``mode`` and takes the
argmax over the classes, zooms the labels back (``zoom_labels``: scipy's
order 0) and copies them out in one copy: the same per-slice results.
The forward runs in eval under ``torch.inference_mode()``, so a bf16
model's kernels fire.  The dual combination is per family
(``combined_logits``, the one place it lives):

* 'fg_minus_bg': MERIT's test and every validation (the sum of fg_i - bg_i)
* 'fg_only': MIST's and EMCAD's ``test_single_volume`` (the sum of fg_i)
* 'single': models without dual heads (the sum of the maps)

Spans (``utils.profiling.span``, recorded only while recording is on), each
keyed by the predictor's volume number: ``volume.zoom_in`` around a
volume's copy in and the launch of its zoom to the patch, ``volume.launch``
around each chunk's forward, combination, argmax and cast,
``volume.zoom_out`` around the launch of the labels' zoom back, and
``volume.copyout_wait`` around the one wait for the volume's labels on the
host.  On a card only the copy in (from pageable memory) and
``volume.copyout_wait`` wait for the device.

The port's functions take the model with its weights where the JAX
package's take the flax module and its ``variables``.  The train forward
is the module chain (every kernel is forward only), but for the DSRA
gates, whose autograd Function runs the gate kernel forward on the card.
``dtype="bfloat16"`` trains under ``torch.autocast`` with float32
parameters (the JAX package's ``--dtype bfloat16`` model) and validates a
bf16 copy of the weights, as ``train.binary`` does.

Data parallel (a process group, as ``train.binary``): ``cfg.batch_size``
is the global batch, split in contiguous rows over the ranks; the model is
wrapped by ``parallel.data_parallel`` and drop path draws its masks over
the global batch.  The Dice loss sums over the whole batch, so it is not a
mean of per-rank terms: every rank gathers the global batch's maps and
labels (``parallel.gather_rows``, differentiable) and computes the global
loss, as JAX's step over the mesh does.  Validation and ``test_volumes``
stay single-device, as in JAX: rank 0 validates and sends the score to
every rank.  The volume augmenters draw from one stateful RNG per process
(``data/volumes.py``), so a loop with augmentation trains on other
samples at another world size; a step on the same batch is the same.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import time

import numpy as np
import torch
from torch import nn

from pranet2_tpu_torch import parallel
from pranet2_tpu_torch.data import BatchLoader, DevicePrefetcher
from pranet2_tpu_torch.evalx.volumetric import (calculate_dice_percase,
                                                calculate_metric_percase)
from pranet2_tpu_torch.losses import mutation_loss
from pranet2_tpu_torch.nn import (drop_path_seeder, keep_batchnorm_stats,
                                  remat as remat_scope, set_compute_dtype)
from pranet2_tpu_torch.ops import volume_zoom
from pranet2_tpu_torch.train.binary import dtype_of
from pranet2_tpu_torch.train.optim import make_optimizer
from pranet2_tpu_torch.train.state import TrainState
from pranet2_tpu_torch.utils.profiling import span

MODES = ("fg_minus_bg", "fg_only", "single")


# ---------------------------------------------------------------------------
# volumetric inference
# ---------------------------------------------------------------------------


def combined_logits(outs, mode: str) -> torch.Tensor:
    """The logits a multiclass model is scored by: 'fg_minus_bg' sums
    fg_i - bg_i over a dual model's 4 level pairs (``outs[:4]`` fg,
    ``outs[4:]`` bg), 'fg_only' its 4 fg maps, 'single' every map."""
    if mode == "fg_minus_bg":
        return sum(f - b for f, b in zip(outs[:4], outs[4:]))
    if mode == "fg_only":
        return sum(outs[:4])
    if mode == "single":
        return sum(outs)
    raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def _volume_tensor(volume) -> torch.Tensor:
    """A (D, H, W) volume as a CPU tensor of its float32 or float64 values
    (any other type as float32), sharing the array's memory where it can."""
    v = np.ascontiguousarray(volume)
    if v.dtype not in (np.float32, np.float64):
        v = v.astype(np.float32)
    return torch.from_numpy(v)


def zoom_to_patch(volume: np.ndarray, patch_size) -> np.ndarray:
    """A (D, H, W) volume's slices zoomed to ``patch_size`` (order 3), as a
    (D, 1, ph, pw) float32 batch; unzoomed where they already fit.  On the
    host, through ``ops.volume_zoom``'s plain version."""
    v = _volume_tensor(volume)
    if tuple(v.shape[1:]) == tuple(patch_size):
        return v.numpy().astype(np.float32)[:, None]
    return volume_zoom.zoom_slices(v, patch_size).numpy()


def make_slice_predictor(model: nn.Module, patch_size, mode: str,
                         chunk: int = 16):
    """``predict(volume (D, H, W) float32) -> (D, H, W) int32 labels`` on
    the model's device: the volume copied there and zoomed to the patch
    (order 3), a forward of ``chunk`` slices at a time, ``combined_logits``
    and the argmax, the labels zoomed back (order 0) and copied out in
    one copy; no zoom runs where the slices already fit the patch."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    dev = next(model.parameters()).device
    ph, pw = patch_size
    volumes = itertools.count()  # the spans' keys

    def predict(volume: np.ndarray) -> np.ndarray:
        key = next(volumes)
        d, x, y = volume.shape
        zoomed = (x, y) != (ph, pw)
        model.eval()
        with torch.inference_mode():
            with span("volume.zoom_in", key):
                vol = _volume_tensor(volume).to(dev)
                slices = (volume_zoom.zoom_slices(vol, (ph, pw)) if zoomed
                          else vol.float()[:, None])
            preds = torch.empty((d, ph, pw), dtype=torch.int32, device=dev)
            for start in range(0, d, chunk):
                with span("volume.launch", key):
                    batch = slices[start:start + chunk]
                    real = batch.shape[0]
                    if real < chunk:
                        batch = torch.cat([batch, batch.new_zeros(
                            (chunk - real, 1, ph, pw))])
                    # softmax is monotonic: the argmax of the logits
                    preds[start:start + real] = combined_logits(
                        model(batch), mode).argmax(1)[:real]
            if zoomed:
                with span("volume.zoom_out", key):
                    preds = volume_zoom.zoom_labels(preds, (x, y))
            with span("volume.copyout_wait", key):
                return preds.cpu().numpy()

    return predict


def test_volumes(model: nn.Module, dataset, num_classes: int,
                 patch_size=(224, 224), mode: str = "fg_minus_bg",
                 full_metrics: bool = True, chunk: int = 16):
    """Per-volume per-class metrics over a test dataset.

    Returns (metrics (n_vols, num_classes - 1, 4, or 1 without
    ``full_metrics``), case names).  A dataset item is a (D, H, W) volume,
    a (1, H, W) slice (ACDC 'valid') or a bare (H, W) slice.
    """
    predict = make_slice_predictor(model, tuple(patch_size), mode, chunk)
    rows, names = [], []
    for i in range(len(dataset)):
        image, label = dataset[i]
        if image.ndim == 2:
            image = image[None]
        if label.ndim == 2:
            label = label[None]
        pred = predict(image)
        per_class = []
        for c in range(1, num_classes):
            if full_metrics:
                per_class.append(calculate_metric_percase(pred == c,
                                                          label == c))
            else:
                per_class.append((calculate_dice_percase(pred == c,
                                                         label == c),))
        rows.append(per_class)
        names.append(dataset.case_name(i))
    return np.asarray(rows, np.float64), names


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MulticlassTrainConfig:
    num_classes: int = 9
    max_epochs: int = 300
    batch_size: int = 6
    img_size: int = 224
    lr: float = 1e-4
    weight_decay: float = 1e-4
    dual: bool = True
    loss_weights: tuple[float, float, float] = (0.5, 0.7, 0.3)
    single_weights: tuple[float, float] = (0.3, 0.7)
    seed: int = 2222
    eval_from_frac: float = 0.5     # start validating at this fraction of epochs
    best_threshold: float = 0.80    # min val mean-dice to save best
    remat: bool = False             # rematerialize the forward
    supervision: str = "mutation"   # 'mutation' | 'deep_supervision' | 'last_layer'
    dtype: str = "float32"          # 'bfloat16': autocast, float32 parameters


def make_multiclass_train_step(model: nn.Module, cfg: MulticlassTrainConfig):
    """``step(state, images, labels) -> (state, loss)``: NCHW images and
    (N, H, W) integer labels on the model's device; one forward in train
    mode, the MUTATION loss, its backward and one optimizer update of
    ``state`` in place.  Drop path draws from ``cfg.seed`` and the step.
    ``model`` is the state's model or its ``parallel.data_parallel``
    wrapper; in a process group the images and labels are this rank's
    rows and the loss is the global batch's.  ``cfg.remat`` checkpoints
    each encoder block, as ``train.binary.make_train_step`` does: the
    plain step's values, less memory, a second encoder forward."""
    compute = dtype_of(cfg.dtype)
    reseed = drop_path_seeder(model, cfg.seed,
                              (parallel.rank(), parallel.world()))

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        model.train()
        reseed(state.step)
        autocast = (torch.autocast(images.device.type, dtype=compute)
                    if compute is not None else contextlib.nullcontext())
        with autocast, remat_scope(cfg.remat):
            outs = model(images)
        outs = [parallel.gather_rows(o) for o in outs]
        labels = parallel.gather_rows(labels)
        if cfg.dual:
            loss = mutation_loss(list(outs[:4]), labels, cfg.num_classes,
                                 list(outs[4:]), weights=cfg.loss_weights,
                                 supervision=cfg.supervision)
        else:
            loss = mutation_loss(list(outs), labels, cfg.num_classes,
                                 single_weights=cfg.single_weights,
                                 supervision=cfg.supervision)
        state.optimizer.zero_grad()
        with keep_batchnorm_stats(model, cfg.remat):
            loss.backward()
        state.apply_gradients()
        return state, loss.detach()

    return step


def train_multiclass(model: nn.Module, cfg: MulticlassTrainConfig,
                     train_dataset, val_dataset=None, log=print,
                     num_threads: int = 8):
    """Train ``model`` (its weights and device are the start) for
    ``cfg.max_epochs``.  Returns the final ``TrainState``, the best
    epoch's variables (a detached copy of the model's ``state_dict``; None
    when no validation passed ``best_threshold``) and the per-epoch
    history.  In a process group every rank calls it; ``log`` and the
    validation run on rank 0 only."""
    rank, world = parallel.rank(), parallel.world()
    main = rank == 0
    log = parallel.main_only(log)
    dev = next(model.parameters()).device
    compute = dtype_of(cfg.dtype)
    loader = BatchLoader(train_dataset, cfg.batch_size, seed=cfg.seed,
                         num_threads=num_threads, rank=rank, world=world)
    net = parallel.data_parallel(model)
    state = TrainState(model, make_optimizer(
        model.parameters(), cfg.lr, clip_value=None,
        weight_decay=cfg.weight_decay))
    step_fn = make_multiclass_train_step(net, cfg)
    # the kernel wrappers take one element type, which autocast's mixed
    # types would break: a bf16 run validates a bf16 copy of the weights
    validates = main and val_dataset is not None
    eval_model = (set_compute_dtype(copy.deepcopy(model), compute)
                  if compute is not None and validates else model)

    best_dice, best = -1.0, None
    history = []
    eval_from = int(cfg.max_epochs * cfg.eval_from_frac)
    for epoch in range(1, cfg.max_epochs + 1):
        t0 = time.time()
        total, nsteps = 0.0, 0
        for images, labels in DevicePrefetcher(loader, dev):
            state, loss = step_fn(state, images, labels)
            total += float(loss)
            nsteps += 1
        dt = time.time() - t0
        mean_loss = total / max(nsteps, 1)
        history.append(dict(epoch=epoch, loss=mean_loss, sec=dt,
                            img_per_sec=nsteps * cfg.batch_size / dt))
        log(f"epoch {epoch}/{cfg.max_epochs} loss {mean_loss:.4f} "
            f"({dt:.1f}s)")

        if val_dataset is not None and epoch >= eval_from:
            dice = None
            if validates:
                if eval_model is not model:
                    eval_model.load_state_dict(state.variables)
                dice = validate(eval_model, val_dataset, cfg)
            dice = parallel.broadcast_object(dice)
            history[-1]["val_dice"] = dice
            log(f"epoch {epoch} val mean-dice {dice:.4f}")
            if dice > best_dice and dice >= cfg.best_threshold:
                best_dice = dice
                best = {k: v.detach().clone()
                        for k, v in state.variables.items()}
                log(f"epoch {epoch}: new best {dice:.4f}")
    return state, best, history


def validate(model: nn.Module, val_dataset, cfg: MulticlassTrainConfig
             ) -> float:
    """Slice-wise validation (``val_single_volume``: fg - bg for dual):
    the mean dice over the cases and the foreground classes."""
    mode = "fg_minus_bg" if cfg.dual else "single"
    metrics, _ = test_volumes(model, val_dataset, cfg.num_classes,
                              patch_size=(cfg.img_size, cfg.img_size),
                              mode=mode, full_metrics=False)
    return float(metrics[..., 0].mean())

"""Multiclass training CLI (equivalent of ``EMCAD/train_synapse.py``,
``MERIT/train_ACDC.py``, ``MIST/Synapse_train.py``).

Port of ``pranet2_tpu/cli/train_multiclass.py``, with ``--device`` (the
CUDA card unless given; ``--device cpu`` to run on the CPU).  Example:

    python -m pranet2_tpu_torch.cli.train_multiclass --model emcad \\
        --dataset synapse --root_path ./data/synapse/train_npz \\
        --list_dir ./lists/lists_Synapse

The model starts from random weights drawn from ``--seed``.  Snapshots go
to ``--save_dir``: ``last.pt`` (the full train state) and ``best.pt`` (the
best validated epoch's weights, when one passed the best threshold).
``--dtype bfloat16`` trains under autocast with float32 parameters.
``--model``: ``emcad`` (its encoder and decoder by the EMCAD flags),
``merit`` (``merit_cascaded``), ``merit_parallel`` or ``mist``
(``mist_cam``), each dual unless ``--no-dual``, as the JAX package builds
them.

Data parallel over several cards (or CPU processes), as JAX's mesh:
``torchrun --nproc_per_node 4 -m pranet2_tpu_torch.cli.train_multiclass
...``; ``--batch_size`` stays the global batch; rank 0 logs, validates and
saves.  Without torchrun it trains on one device.
"""

from __future__ import annotations

import argparse
import os

import torch

# the CLIs' model names -> the registry's
MODELS = {"emcad": "emcad", "merit": "merit_cascaded",
          "merit_parallel": "merit_parallel", "mist": "mist_cam"}


def build_model(name: str, num_classes: int, args, device=None,
                dtype: torch.dtype | None = None,
                generator: torch.Generator | None = None,
                img_size: int | None = None):
    """The model ``name`` of the multiclass CLIs (``MODELS``), from their
    flags: EMCAD's from the EMCAD flags, the others from ``--dual``;
    MERIT's from the input side it will serve, ``img_size``, too (its
    backbones swap scales at a multiple of 14)."""
    from pranet2_tpu_torch.models import get_model

    kw = {}
    if name == "emcad":
        kw = dict(encoder=args.encoder, kernel_sizes=tuple(args.kernel_sizes),
                  expansion_factor=args.expansion_factor,
                  lgag_ks=args.lgag_ks, activation=args.activation_mscb)
    elif name == "merit" and img_size is not None:
        kw = dict(img_size=img_size)
    return get_model(MODELS[name], device=device, dtype=dtype,
                     generator=generator, num_classes=num_classes,
                     dual=args.dual, **kw)


def add_model_flags(p: argparse.ArgumentParser) -> None:
    """The flags that build the model, shared by both multiclass CLIs."""
    p.add_argument("--model", default="emcad", choices=list(MODELS))
    p.add_argument("--dataset", default="synapse", choices=["synapse", "acdc"])
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--img_size", type=int, default=None)
    p.add_argument("--dual", action=argparse.BooleanOptionalAction,
                   default=True)
    # EMCAD-specific
    p.add_argument("--encoder", default="pvt_v2_b2")
    p.add_argument("--kernel_sizes", type=int, nargs="+", default=[1, 3, 5])
    p.add_argument("--expansion_factor", type=int, default=2)
    p.add_argument("--lgag_ks", type=int, default=3)
    p.add_argument("--activation_mscb", default="relu6")
    p.add_argument("--device", default=None,
                   help="torch device; the CUDA card unless given")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_model_flags(p)
    p.add_argument("--root_path", required=True)
    p.add_argument("--list_dir", required=True)
    p.add_argument("--val_root", default=None)
    p.add_argument("--val_split", default=None,
                   help="e.g. val_vol (Synapse) or valid (ACDC)")
    p.add_argument("--max_epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--base_lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=2222)
    p.add_argument("--supervision", default="mutation",
                   choices=["mutation", "deep_supervision", "last_layer"])
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute type (autocast); parameters, loss and "
                        "optimizer state stay float32")
    p.add_argument("--save_dir", default="./model_out")
    p.add_argument("--cache", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="RAM-cache the decoded train slices; random "
                        "augmentation still applies per epoch")
    args = p.parse_args(argv)

    from pranet2_tpu_torch import parallel

    parallel.init_from_env(args.device)
    try:
        _train(args)
    finally:
        parallel.destroy()


def _train(args) -> None:
    from pranet2_tpu_torch import parallel

    # dataset defaults (EMCAD/train_synapse.py:85-93, MERIT/train_ACDC.py)
    if args.dataset == "synapse":
        num_classes = args.num_classes or 9
        img_size = args.img_size or 224
        batch_size = args.batch_size or 6
        max_epochs = args.max_epochs or 300
    else:
        num_classes = args.num_classes or 4
        img_size = args.img_size or 256
        batch_size = args.batch_size or 4
        max_epochs = args.max_epochs or 400

    from pranet2_tpu_torch.data import (ACDCDataset, AugmentedView,
                                        CachedDataset, RandomGenerator,
                                        RandomGeneratorACDC, SynapseDataset)
    from pranet2_tpu_torch.train.multiclass import (MulticlassTrainConfig,
                                                    train_multiclass)
    from pranet2_tpu_torch.utils.checkpoint import save_params, save_state

    cfg = MulticlassTrainConfig(
        num_classes=num_classes, max_epochs=max_epochs,
        batch_size=batch_size, img_size=img_size, lr=args.base_lr,
        dual=args.dual, seed=args.seed, supervision=args.supervision,
        dtype=args.dtype)
    model = build_model(args.model, num_classes, args, device=args.device,
                        generator=torch.Generator().manual_seed(args.seed),
                        img_size=img_size)

    def with_cache(raw_ds, transform):
        def adapter(image, label):
            img, lab = transform(image, label)
            return img[None].astype("float32"), lab

        return AugmentedView(CachedDataset(raw_ds), adapter)

    if args.dataset == "synapse":
        transform = RandomGenerator((img_size, img_size), seed=args.seed)
        if args.cache:
            raw = SynapseDataset(args.root_path, args.list_dir, "train",
                                 nclass=num_classes, raw=True)
            train_ds = with_cache(raw, transform)
        else:
            train_ds = SynapseDataset(args.root_path, args.list_dir, "train",
                                      nclass=num_classes,
                                      transform=transform)
        val_ds = (SynapseDataset(args.val_root or args.root_path,
                                 args.list_dir, args.val_split,
                                 nclass=num_classes)
                  if args.val_split else None)
    else:
        transform = RandomGeneratorACDC((img_size, img_size), seed=args.seed)
        if args.cache:
            raw = ACDCDataset(args.root_path, args.list_dir, "train",
                              raw=True)
            train_ds = with_cache(raw, transform)
        else:
            train_ds = ACDCDataset(args.root_path, args.list_dir, "train",
                                   transform=transform)
        val_ds = (ACDCDataset(args.root_path, args.list_dir, args.val_split)
                  if args.val_split else None)

    state, best, _ = train_multiclass(model, cfg, train_ds, val_ds)
    if parallel.is_main():
        save_state(os.path.join(args.save_dir, "last.pt"), state)
        if best is not None:
            save_params(os.path.join(args.save_dir, "best.pt"), best)
        print("done; snapshots in", args.save_dir)


if __name__ == "__main__":
    main()

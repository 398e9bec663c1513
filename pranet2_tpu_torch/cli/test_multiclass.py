"""Multiclass volumetric test CLI (``EMCAD/test_synapse.py``,
``MERIT/test_ACDC.py``).

Port of ``pranet2_tpu/cli/test_multiclass.py``, with ``--device`` (the
CUDA card unless given).  Per-volume, per-class Dice, HD95, Jaccard and ASD,
printed by case and averaged.  The dual-output combination follows the
reference families: ``fg_only`` for EMCAD and MIST, ``fg_minus_bg`` for
MERIT, ``single`` without ``--dual``.  Example:

    python -m pranet2_tpu_torch.cli.test_multiclass --dataset synapse \\
        --volume_path ./data/synapse/test_vol_h5 \\
        --list_dir ./lists/lists_Synapse --checkpoint EMCAD_Synapse.pth

``--model``: ``emcad``, ``merit``, ``merit_parallel`` or ``mist``, built as
the train CLI builds them.  ``--checkpoint``: a reference ``.pth``
(containers and ``module.`` prefixes unwrapped; MIST's packed attention
in-projections as they are; the keys the JAX package's key maps drop
dropped and reported: classifier heads, MIST's dead ``conv3``), or a port
checkpoint (``utils.checkpoint.save_params``, e.g. the train CLI's
``best.pt``).
"""

from __future__ import annotations

import argparse

import torch


def default_mode(model: str, dual: bool) -> str:
    """The reference family's combination of the maps at test time."""
    if not dual:
        return "single"
    return "fg_minus_bg" if model.startswith("merit") else "fg_only"


def main(argv=None):
    from pranet2_tpu_torch.cli.train_multiclass import add_model_flags

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_model_flags(p)
    p.add_argument("--volume_path", required=True)
    p.add_argument("--list_dir", required=True)
    p.add_argument("--split", default=None, help="default: test_vol / test")
    p.add_argument("--checkpoint", required=True,
                   help="a reference .pth, or a port checkpoint")
    p.add_argument("--mode", default=None,
                   choices=[None, "fg_only", "fg_minus_bg", "single"])
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute type of the convolutions (bfloat16 for fast "
                        "eval; float32 for checkpoint parity)")
    p.add_argument("--precision", default="highest",
                   choices=["default", "high", "highest"],
                   help="float32 convolutions and products: 'highest' and "
                        "'high' keep them float32 (TF32 off in cuDNN and "
                        "cuBLAS); 'default' leaves PyTorch's flags")
    args = p.parse_args(argv)

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    if args.precision != "default":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _test(args)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def _test(args):
    """Build and load the model, score every volume and print the lines;
    returns (metrics, case names)."""
    from pranet2_tpu_torch.cli.train_multiclass import build_model
    from pranet2_tpu_torch.data import ACDCDataset, SynapseDataset
    from pranet2_tpu_torch.train.multiclass import test_volumes
    from pranet2_tpu_torch.utils.checkpoint import restore_params
    from pranet2_tpu_torch.utils.convert import (load_reference,
                                                load_reference_state_dict)

    synapse = args.dataset == "synapse"
    num_classes = args.num_classes or (9 if synapse else 4)
    img_size = args.img_size or (224 if synapse else 256)
    mode = args.mode or default_mode(args.model, args.dual)
    model = build_model(args.model, num_classes, args, device=args.device,
                        dtype=torch.bfloat16 if args.dtype == "bfloat16"
                        else None, img_size=img_size)
    if args.checkpoint.endswith(".pth"):
        dropped = load_reference(model,
                                 load_reference_state_dict(args.checkpoint))
        if dropped:
            print(f"dropped {len(dropped)} checkpoint keys the model does "
                  f"not hold: {dropped}")
    else:
        model.load_state_dict(restore_params(args.checkpoint, device="cpu"))

    ds = (SynapseDataset(args.volume_path, args.list_dir,
                         args.split or "test_vol", nclass=num_classes)
          if synapse else ACDCDataset(args.volume_path, args.list_dir,
                                      args.split or "test"))
    metrics, names = test_volumes(model, ds, num_classes,
                                  patch_size=(img_size, img_size), mode=mode)
    for name, m in zip(names, metrics):
        print(f"{name}: mean_dice {m[:, 0].mean():.4f} "
              f"mean_hd95 {m[:, 1].mean():.4f}")
    mean = metrics.mean(axis=0)  # (classes - 1, 4)
    for c in range(mean.shape[0]):
        print(f"class {c + 1}: dice {mean[c, 0]:.4f} hd95 {mean[c, 1]:.4f} "
              f"jaccard {mean[c, 2]:.4f} asd {mean[c, 3]:.4f}")
    print(f"mean dice {mean[:, 0].mean():.4f} mean hd95 "
          f"{mean[:, 1].mean():.4f} mean jaccard {mean[:, 2].mean():.4f} "
          f"mean asd {mean[:, 3].mean():.4f}")
    return metrics, names


if __name__ == "__main__":
    main()

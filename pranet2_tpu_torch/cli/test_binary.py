"""Binary inference + PNG export CLI (equivalent of ``binary_seg/MyTest_med.py``).

Port of ``pranet2_tpu/cli/test_binary.py``, with ``--device`` (the CUDA
card unless given) and ``--dtype``.  Runs the model over the polyp test
sets and writes min-max normalized uint8 prediction PNGs under
``results/<model>/<dataset>/``, which ``cli.eval_binary`` (or the
reference's eval.py) scores.  V2 models export the sum of their four fg
maps, V1 models their finest map.  Example:

    python -m pranet2_tpu_torch.cli.test_binary --model pranet_v1 \\
        --checkpoint PraNet-19.pth --data_root ./data/TestDataset

``--checkpoint``: a reference ``.pth`` (containers and ``module.``
prefixes unwrapped; classifier keys dropped and reported), or a port
checkpoint (``utils.checkpoint.save_params``, e.g. a trainer's
``best.pt``).
"""

from __future__ import annotations

import argparse
import os

import torch

DEFAULT_DATASETS = [
    "CVC-300", "CVC-ClinicDB", "Kvasir", "ETIS-LaribPolypDB", "CVC-ColonDB",
]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", default="pranet_v2",
                   choices=["pranet_v1", "pvt_pranet_v1",
                            "pranet_v2", "pvt_pranet_v2"])
    p.add_argument("--checkpoint", required=True,
                   help="a reference .pth, or a port checkpoint")
    p.add_argument("--testsize", type=int, default=352)
    p.add_argument("--batchsize", type=int, default=16)
    p.add_argument("--data_root", default="./data/TestDataset")
    p.add_argument("--save_root", default="./results")
    p.add_argument("--datasets", nargs="+", default=DEFAULT_DATASETS)
    p.add_argument("--precision", default="highest",
                   choices=["default", "high", "highest"],
                   help="float32 convolutions and products: 'highest' keeps "
                        "them float32 (TF32 off in cuDNN and cuBLAS), for "
                        "checkpoint parity; 'high' and 'default' allow TF32")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute type of the convolutions (BatchNorm stays "
                        "float32)")
    p.add_argument("--device", default=None,
                   help="torch device; the CUDA card unless given")
    args = p.parse_args(argv)

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    tf32 = args.precision != "highest"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return _export(args)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def _export(args) -> dict:
    """Load the model and write each dataset's PNGs; returns the number
    written by dataset."""
    from PIL import Image

    from pranet2_tpu_torch.data import PolypTestDataset
    from pranet2_tpu_torch.models import get_model
    from pranet2_tpu_torch.serve import head_kwargs, is_v2
    from pranet2_tpu_torch.train.binary import make_predict_fn, predict_to_maps
    from pranet2_tpu_torch.utils.checkpoint import restore_params
    from pranet2_tpu_torch.utils.convert import (load_reference,
                                                load_reference_state_dict)

    model = get_model(args.model, device=args.device,
                      dtype=torch.bfloat16 if args.dtype == "bfloat16"
                      else None, **head_kwargs(args.model))
    if args.checkpoint.endswith(".pth"):
        dropped = load_reference(model,
                                 load_reference_state_dict(args.checkpoint))
        if dropped:
            print(f"dropped {len(dropped)} checkpoint keys the model does "
                  f"not hold: {dropped}")
    else:
        model.load_state_dict(restore_params(args.checkpoint, device="cpu"))

    fwd = make_predict_fn(model, v2=is_v2(args.model))
    written = {}
    for ds_name in args.datasets:
        img_root = os.path.join(args.data_root, ds_name, "images")
        gt_root = os.path.join(args.data_root, ds_name, "masks")
        if not os.path.isdir(img_root):
            print(f"skip {ds_name}: {img_root} not found")
            continue
        ds = PolypTestDataset(img_root, gt_root, args.testsize)
        out_dir = os.path.join(args.save_root, args.model, ds_name)
        os.makedirs(out_dir, exist_ok=True)
        n = 0
        for name, pred, _gt in predict_to_maps(fwd, ds, args.batchsize):
            Image.fromarray(pred).save(os.path.join(out_dir, name))
            n += 1
        written[ds_name] = n
        print(f"{args.model}/{ds_name}: wrote {n} maps -> {out_dir}")
    return written


if __name__ == "__main__":
    main()

"""One-command BASELINE.md reproduction: predict + eval for every binary model.

Port of ``pranet2_tpu/cli/reproduce_baseline.py``, with ``--device`` (the
CUDA card unless given).  The released polyp data and checkpoints on disk
become the BASELINE.md metric table:

    python -m pranet2_tpu_torch.cli.reproduce_baseline \\
        --data_root data/TestDataset --ckpt_dir snapshots

It is the reference's two-step protocol, the ``MyTest_med.py`` PNG export
(``binary_seg/MyTest_med.py:81-113``) then the ``eval.py`` sweep
(``binary_seg/eval.py:214-226``), in one command over the 4 models x 5 test
sets (the reference iterates 4, omitting CVC-ColonDB at
``MyTest_med.py:82``; pass ``--datasets`` to match exactly).

Checkpoint per model (``find_checkpoint``): ``<ckpt_dir>/<alias>.pth`` for
the release aliases (RES-V1 / PVT-V1 / RES-V2 / PVT-V2), the reference's
nested ``<ckpt_dir>/<DirName>/<alias>.pth``, ``<ckpt_dir>/<model>.pth``, or
a port parameter file (``utils.checkpoint.save_params``)
``<ckpt_dir>/<model>.pt`` or ``<ckpt_dir>/<DirName>/<model>.pt``.  A
``.pth`` is unwrapped (containers, ``module.`` prefixes) and its
classifier keys dropped (``utils.convert.load_reference``).

The multiclass equivalent (Synapse/ACDC per-class Dice/HD95 tables from a
released ``.pth``) is ``cli/test_multiclass.py --checkpoint model.pth
--volume_path ... --list_dir ...``: it needs its own data paths, so it
stays a separate command.
"""

from __future__ import annotations

import argparse
import json
import os

DEFAULT_DATASETS = [
    "CVC-300", "CVC-ClinicDB", "Kvasir", "ETIS-LaribPolypDB", "CVC-ColonDB",
]

# model registry name -> (release alias, release subdir)  (MyTest_med.py:57)
CKPT_ALIASES = {
    "pranet_v1": ("RES-V1", "PraNet-V1"),
    "pvt_pranet_v1": ("PVT-V1", "PVT-PraNet-V1"),
    "pranet_v2": ("RES-V2", "PraNet-V2"),
    "pvt_pranet_v2": ("PVT-V2", "PVT-PraNet-V2"),
}

# Published PyTorch mDice (%), BASELINE.md / binary_seg/jittor/README.md:27-84.
# CVC-ColonDB has no published row (the reference's scripts skip it,
# MyTest_med.py:82), so --expect scores whichever of these datasets ran.
EXPECTED_MDICE = {
    "pranet_v1": {"CVC-300": 87.06, "CVC-ClinicDB": 89.84, "Kvasir": 89.39,
                  "ETIS-LaribPolypDB": 62.75},
    "pvt_pranet_v1": {"CVC-300": 86.59, "CVC-ClinicDB": 90.96,
                      "Kvasir": 87.09, "ETIS-LaribPolypDB": 68.32},
    "pranet_v2": {"CVC-300": 89.83, "CVC-ClinicDB": 92.28, "Kvasir": 90.70,
                  "ETIS-LaribPolypDB": 64.05},
    "pvt_pranet_v2": {"CVC-300": 89.89, "CVC-ClinicDB": 93.09,
                      "Kvasir": 91.52, "ETIS-LaribPolypDB": 76.35},
}


def verdict_rows(all_rows, metrics, expected, tol_pp: float):
    """Measured mDice against expectations -> per-row PASS/FAIL.

    ``all_rows`` are ``[model, dataset, *metric values]`` with metrics in
    0..1; expectations are percent (the BASELINE.md convention).  Returns
    (verdict table rows, ok): ``ok`` is False if any compared row misses
    the tolerance.  Datasets without a published number are marked ``n/a``
    and do not affect the verdict.
    """
    idx = 2 + metrics.index("meanDic")
    rows, ok = [], True
    for r in all_rows:
        model, ds = r[0], r[1]
        got_pp = 100.0 * float(r[idx])
        want = expected.get(model, {}).get(ds)
        if want is None:
            rows.append([model, ds, f"{got_pp:.2f}", "—", "—", "n/a"])
            continue
        diff = got_pp - float(want)
        good = abs(diff) <= tol_pp
        ok &= good
        rows.append([model, ds, f"{got_pp:.2f}", f"{want:.2f}",
                     f"{diff:+.2f}", "PASS" if good else "FAIL"])
    return rows, ok


def find_checkpoint(ckpt_dir: str, model: str) -> str | None:
    """The first checkpoint file of ``model`` under ``ckpt_dir`` (the
    layouts in the module's docstring), or None."""
    alias, subdir = CKPT_ALIASES[model]
    candidates = [
        os.path.join(ckpt_dir, f"{alias}.pth"),
        os.path.join(ckpt_dir, subdir, f"{alias}.pth"),
        os.path.join(ckpt_dir, f"{model}.pth"),
        os.path.join(ckpt_dir, f"{model}.pt"),           # save_params
        os.path.join(ckpt_dir, subdir, f"{model}.pt"),   # release name
    ]
    for c in candidates:
        if os.path.isfile(c):
            return c
    return None


def predict_model(model_name: str, checkpoint: str, data_root: str,
                  save_root: str, datasets, testsize: int, batchsize: int,
                  device=None) -> list[str]:
    """Write ``model_name``'s PNGs for each dataset found under
    ``data_root`` to ``<save_root>/<model>/<dataset>/``; returns the
    datasets done."""
    from PIL import Image

    from pranet2_tpu_torch.data import PolypTestDataset
    from pranet2_tpu_torch.models import get_model
    from pranet2_tpu_torch.serve import head_kwargs, is_v2
    from pranet2_tpu_torch.train.binary import make_predict_fn, predict_to_maps
    from pranet2_tpu_torch.utils.checkpoint import restore_params
    from pranet2_tpu_torch.utils.convert import (load_reference,
                                                load_reference_state_dict)

    model = get_model(model_name, device=device, **head_kwargs(model_name))
    if checkpoint.endswith(".pth"):
        dropped = load_reference(model, load_reference_state_dict(checkpoint))
        if dropped:
            print(f"  dropped {len(dropped)} checkpoint keys the model does "
                  f"not hold: {dropped}")
    else:
        model.load_state_dict(restore_params(checkpoint, device="cpu"))

    fwd = make_predict_fn(model, v2=is_v2(model_name))
    done = []
    for ds_name in datasets:
        img_root = os.path.join(data_root, ds_name, "images")
        gt_root = os.path.join(data_root, ds_name, "masks")
        if not os.path.isdir(img_root):
            print(f"  skip {ds_name}: {img_root} not found")
            continue
        ds = PolypTestDataset(img_root, gt_root, testsize)
        out_dir = os.path.join(save_root, model_name, ds_name)
        os.makedirs(out_dir, exist_ok=True)
        n = 0
        for name, pred, _gt in predict_to_maps(fwd, ds, batchsize):
            Image.fromarray(pred).save(os.path.join(out_dir, name))
            n += 1
        print(f"  {model_name}/{ds_name}: {n} maps")
        done.append(ds_name)
    return done


def main(argv=None):
    from pranet2_tpu_torch.cli.eval_binary import DEFAULT_METRICS

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data_root", required=True,
                   help="TestDataset root: <root>/<name>/{images,masks}")
    p.add_argument("--ckpt_dir", required=True,
                   help="dir holding the 4 released .pth files (flat or in "
                        "the release's subdirs) or port .pt files")
    p.add_argument("--models", nargs="+", default=list(CKPT_ALIASES),
                   choices=list(CKPT_ALIASES))
    p.add_argument("--datasets", nargs="+", default=DEFAULT_DATASETS)
    p.add_argument("--save_root", default="./results_baseline")
    p.add_argument("--result_path", default=None, help="CSV output dir")
    p.add_argument("--metrics", nargs="+", default=DEFAULT_METRICS)
    p.add_argument("--testsize", type=int, default=352)
    p.add_argument("--batchsize", type=int, default=16)
    p.add_argument("--precision", default="highest",
                   choices=["default", "high", "highest"],
                   help="'highest' for checkpoint-parity numbers: float32 "
                        "convolutions and products in full float32 (TF32 "
                        "off in cuDNN and cuBLAS); 'high' and 'default' "
                        "allow TF32")
    p.add_argument("--expect", action="store_true",
                   help="compare measured mDice against the published "
                        "PyTorch numbers (BASELINE.md) and exit nonzero on "
                        "any miss: the one-command parity verdict")
    p.add_argument("--expect_json", default=None,
                   help="JSON {model: {dataset: mdice_pct}} overriding the "
                        "built-in expectations (implies --expect)")
    p.add_argument("--tol_pp", type=float, default=0.4,
                   help="mDice tolerance in percentage points for --expect "
                        "(0.4 = the historically accepted port drift; the "
                        "stretch target is 0.1)")
    p.add_argument("--device", default=None,
                   help="torch device; the CUDA card unless given")
    args = p.parse_args(argv)

    import torch

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    tf32 = args.precision != "highest"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return _reproduce(args)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def _reproduce(args) -> list:
    """Predict, score and print the table (and the verdict); returns the
    table's rows.  Raises ``SystemExit(1)`` when the verdict fails."""
    from pranet2_tpu_torch.cli.eval_binary import evaluate_pred_dirs
    from pranet2_tpu_torch.cli.table import format_table

    all_rows = []
    for model_name in args.models:
        ckpt = find_checkpoint(args.ckpt_dir, model_name)
        if ckpt is None:
            print(f"{model_name}: no checkpoint under {args.ckpt_dir} — skip")
            continue
        print(f"{model_name}: predicting with {ckpt}")
        done = predict_model(model_name, ckpt, args.data_root, args.save_root,
                             args.datasets, args.testsize, args.batchsize,
                             args.device)
        if not done:
            continue
        rows = evaluate_pred_dirs(
            os.path.join(args.save_root, model_name), args.data_root, done,
            args.metrics, args.result_path)
        for r in rows:
            all_rows.append([model_name] + r)

    print()
    print(format_table(all_rows, ["model", "dataset", *args.metrics],
                       floatfmt=".4f"))

    if args.expect or args.expect_json:
        expected = EXPECTED_MDICE
        if args.expect_json:
            with open(args.expect_json) as f:
                expected = json.load(f)
        vrows, ok = verdict_rows(all_rows, args.metrics, expected,
                                 args.tol_pp)
        print()
        print(format_table(vrows, ["model", "dataset", "mDice", "expected",
                                   "diff (pp)", "verdict"]))
        print(f"\nparity verdict: {'PASS' if ok else 'FAIL'} "
              f"(tolerance ±{args.tol_pp}pp)")
        if not ok:
            raise SystemExit(1)
    else:
        print("\nCompare against BASELINE.md (PyTorch rows; historical port "
              "tolerance <=0.4pp, target +-0.1pp), or rerun with --expect "
              "for an automatic verdict.")
    return all_rows


if __name__ == "__main__":
    main()

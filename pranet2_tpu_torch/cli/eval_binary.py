"""Offline metric sweep over saved prediction PNGs (``binary_seg/eval.py``).

Port of ``pranet2_tpu/cli/eval_binary.py`` over the port's ``evalx``.
Scores ``<pred_root>/<dataset>/*.png`` against ``<gt_root>/<dataset>/masks``,
appends per-dataset CSVs and prints a table.  Example:

    python -m pranet2_tpu_torch.cli.eval_binary \\
        --pred_root results/pranet_v1 --gt_root ./data/TestDataset
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
from PIL import Image

from pranet2_tpu_torch.cli.table import format_table

DEFAULT_METRICS = ["meanDic", "meanIoU", "wFm", "Sm", "meanEm", "mae"]


def _pair_files(pdir: str, gdir: str, ds: str):
    """Match prediction files to GT masks by stem (extension-insensitive);
    unpaired files on either side are reported to stderr and skipped."""
    preds = {os.path.splitext(f)[0]: f for f in sorted(os.listdir(pdir))}
    gts = {os.path.splitext(f)[0]: f for f in sorted(os.listdir(gdir))}
    common = sorted(preds.keys() & gts.keys())
    for stem in sorted(preds.keys() - gts.keys()):
        print(f"[eval:{ds}] prediction without GT mask, skipped: "
              f"{preds[stem]}", file=sys.stderr)
    for stem in sorted(gts.keys() - preds.keys()):
        print(f"[eval:{ds}] GT mask without prediction, skipped: "
              f"{gts[stem]}", file=sys.stderr)
    return [(preds[s], gts[s]) for s in common]


def evaluate_pred_dirs(pred_root: str, gt_root: str, datasets, metrics,
                       result_path: str | None = None):
    """One row ``[dataset, *metrics]`` per dataset with pairs; appends
    ``result_<dataset>.csv`` under ``result_path`` when given."""
    from pranet2_tpu_torch.evalx import (aggregate_dataset_metrics,
                                         binary_image_metrics)

    method = os.path.basename(os.path.normpath(pred_root))
    rows = []
    for ds in datasets:
        pdir = os.path.join(pred_root, ds)
        gdir = os.path.join(gt_root, ds, "masks")
        pairs = _pair_files(pdir, gdir, ds)
        if not pairs:
            print(f"[eval:{ds}] no matching pred/GT pairs — skipped",
                  file=sys.stderr)
            continue
        per_image = []
        for pf, gf in pairs:
            pred = np.array(Image.open(os.path.join(pdir, pf)))
            gt = np.array(Image.open(os.path.join(gdir, gf)))
            per_image.append(binary_image_metrics(pred, gt))
        agg = aggregate_dataset_metrics(per_image)
        rows.append([ds] + [agg[m] for m in metrics])
        if result_path:
            os.makedirs(result_path, exist_ok=True)
            csv = os.path.join(result_path, f"result_{ds}.csv")
            new = not os.path.isfile(csv)
            with open(csv, "a") as f:
                if new:
                    f.write(", ".join(["method", *metrics]) + "\n")
                f.write(method + "," +
                        ",".join(f"{agg[m]:.4f}" for m in metrics) + ",\n")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--pred_root", required=True)
    p.add_argument("--gt_root", default="./data/TestDataset")
    p.add_argument("--result_path", default="eval_results")
    p.add_argument("--datasets", nargs="+",
                   default=["CVC-300", "CVC-ClinicDB", "Kvasir",
                            "ETIS-LaribPolypDB"])
    p.add_argument("--metrics", nargs="+", default=DEFAULT_METRICS)
    args = p.parse_args(argv)

    rows = evaluate_pred_dirs(args.pred_root, args.gt_root, args.datasets,
                              args.metrics, args.result_path)
    print(format_table(rows, ["dataset", *args.metrics]))
    return rows


if __name__ == "__main__":
    main()

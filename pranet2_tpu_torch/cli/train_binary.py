"""Binary polyp training CLI (equivalent of ``binary_seg/MyTrain_med.py``).

Port of ``pranet2_tpu/cli/train_binary.py``, with ``--device`` (the CUDA
card unless given; ``--device cpu`` to run on the CPU).  Example:

    python -m pranet2_tpu_torch.cli.train_binary --model pranet_v2 \\
        --train_path ./data/TrainDataset --test_root ./data/TestDataset

Snapshots go to ``snapshots/<train_save>/``: ``epoch_<N>.pt`` every
``--snapshot_every`` epochs and ``last.pt`` (full train state), and
``best.pt`` (the best epoch's weights by summed meanDice, when the eval
datasets exist).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", default="pranet_v2",
                   choices=["pranet_v2", "pvt_pranet_v2"])
    p.add_argument("--epoch", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batchsize", type=int, default=8)
    p.add_argument("--trainsize", type=int, default=352)
    p.add_argument("--clip", type=float, default=0.5)
    p.add_argument("--decay_rate", type=float, default=0.1)
    p.add_argument("--decay_epoch", type=int, default=50)
    p.add_argument("--train_path", default="./data/TrainDataset")
    p.add_argument("--test_root", default="./data/TestDataset")
    p.add_argument("--train_save", default="pranet_v2")
    p.add_argument("--eval_datasets", nargs="+",
                   default=["CVC-300", "CVC-ClinicDB"])
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--snapshot_every", type=int, default=10,
                   help="epoch snapshot period (MyTrain_med.py:101-103)")
    p.add_argument("--device", default=None,
                   help="torch device; the CUDA card unless given")
    args = p.parse_args(argv)

    from pranet2_tpu_torch.train.binary import (BinaryTrainConfig,
                                                test_with_eval, train)
    from pranet2_tpu_torch.utils.checkpoint import save_params, save_state

    cfg = BinaryTrainConfig(
        model=args.model, epochs=args.epoch, lr=args.lr,
        batch_size=args.batchsize, trainsize=args.trainsize, clip=args.clip,
        decay_rate=args.decay_rate, decay_epoch=args.decay_epoch,
        train_path=args.train_path, test_root=args.test_root,
        eval_datasets=tuple(args.eval_datasets),
        save_dir=os.path.join("snapshots", args.train_save),
        dtype=args.dtype, seed=args.seed,
        snapshot_every=args.snapshot_every, device=args.device,
    )

    def eval_fn(model, state):
        res = test_with_eval(model, cfg.test_root, cfg.eval_datasets,
                             testsize=cfg.trainsize)
        # best = summed meanDice over eval datasets (MyTrain_med.py:167)
        return sum(res[d]["meanDic"] for d in cfg.eval_datasets)

    has_eval = all(os.path.isdir(os.path.join(cfg.test_root, d))
                   for d in cfg.eval_datasets)
    state, best, history = train(cfg, eval_fn=eval_fn if has_eval else None)
    save_state(os.path.join(cfg.save_dir, "last.pt"), state)
    if best is not None:
        save_params(os.path.join(cfg.save_dir, "best.pt"), best)
    print("done; snapshots in", cfg.save_dir)


if __name__ == "__main__":
    main()

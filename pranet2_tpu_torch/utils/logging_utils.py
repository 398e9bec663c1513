"""Logging and meters.

Port of ``pranet2_tpu/utils/logging_utils.py`` (a copy: it needs no JAX);
reference: ``AvgMeter`` (``binary_seg/utils/utils.py:26-46``) and the
file + stdout logging of ``multiclass_seg/MERIT/train_ACDC.py:128-129``.
"""

from __future__ import annotations

import logging
import os
import sys


class AvgMeter:
    """Windowed average meter (the reference's ``show()``: the mean of the
    last ``num`` recorded values)."""

    def __init__(self, num: int = 40):
        self.num = num
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0
        self.losses: list[float] = []

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        self.losses.append(val)

    def show(self) -> float:
        tail = self.losses[max(len(self.losses) - self.num, 0):]
        return sum(tail) / max(len(tail), 1)


def setup_logging(log_dir: str | None = None,
                  name: str = "pranet2_tpu_torch") -> logging.Logger:
    """File + stdout logger (the reference's basicConfig-with-tee pattern):
    ``<log_dir>/log.txt`` when ``log_dir`` is given."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("[%(asctime)s.%(msecs)03d] %(message)s",
                            datefmt="%H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger

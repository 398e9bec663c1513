"""Where the port runs: the CUDA card, unless the caller names a device."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``cuda``; raises when no GPU is present rather than falling back."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


def resolve(device=None) -> torch.device:
    """The caller's device, or ``default_device()`` when none is given."""
    return default_device() if device is None else torch.device(device)

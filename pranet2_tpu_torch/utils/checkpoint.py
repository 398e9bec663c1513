"""Checkpoints: the full train state (step, parameters, BatchNorm buffers,
optimizer state), or the inference variables alone.

Port of ``pranet2_tpu/utils/checkpoint.py`` (Orbax directories there; one
``torch.save`` file here).  The reference saves weights only
(``binary_seg/MyTrain_med.py:101-103``) and cannot resume the optimizer;
the full state resumes a run exactly.  Files are read back with
``torch.load(weights_only=True)``: tensors, numbers and containers only.
"""

from __future__ import annotations

import os

import torch


def _save(path: str, obj) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(obj, path)


def save_state(path: str, state) -> None:
    """Save a ``TrainState`` (step, model ``state_dict``, optimizer state)
    to the file ``path``."""
    _save(path, state.state_dict())


def restore_state(path: str, state):
    """Load the file ``path`` into ``state`` (a ``TrainState`` with the same
    model and optimizer layout), in place, onto its model's device; returns
    ``state``."""
    dev = next(state.model.parameters()).device
    state.load_state_dict(torch.load(os.path.abspath(path), map_location=dev,
                                     weights_only=True))
    return state


def save_params(path: str, variables: dict) -> None:
    """Save inference variables (a model's ``state_dict``)."""
    _save(path, variables)


def restore_params(path: str, device=None) -> dict:
    """The variables saved at ``path``, on ``device`` (where they were
    saved from, when None); load them with ``model.load_state_dict``."""
    return torch.load(os.path.abspath(path), map_location=device,
                      weights_only=True)

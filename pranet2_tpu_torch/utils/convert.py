"""Carry weights from the JAX package's flax variables into the port.

``state_dict_from_jax`` takes a ``{'params': ..., 'batch_stats': ...}`` tree
of numpy arrays and returns the port's ``state_dict``: conv kernels HWIO ->
OIHW, Dense kernels (in, out) -> Linear (out, in), BatchNorm and LayerNorm
``scale/bias`` -> ``weight/bias`` and BatchNorm ``mean/var`` ->
``running_mean/running_var``.  The names are the inverse of the JAX
package's ``res2net_key_map``, ``pvtv2_key_map`` and ``pranet_key_map``;
the port keeps the reference checkpoint's names, so a reference ``.pth``
loads with plain ``load_state_dict``.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

# flax path (joined with '.') -> torch prefix, applied in order
_RENAMES = (
    (r"^stem_conv$", "conv.0"),
    (r"^stem_bn$", "conv.1"),
    (r"^backbone\.conv1_(\d)$", r"backbone.conv1.\1"),
    (r"\.layer(\d)_(\d+)\.", r".layer\1.\2."),
    (r"\.(convs|bns|downsample)_(\d)$", r".\1.\2"),
    (r"\.branch(\d)_(\d)\.", r".branch\1.\2."),
    (r"^ra([234])\.", r"ra\1_"),
    (r"\.block(\d)_(\d+)\.", r".block\1.\2."),
    (r"\.patch_embed(\d)_(proj|norm)$", r".patch_embed\1.\2"),
    (r"\.mlp\.dwconv$", ".mlp.dwconv.dwconv"),
)


def torch_prefix(path: tuple[str, ...]) -> str:
    """Flax module path -> the torch module path of the same layer."""
    name = ".".join(path)
    for pat, rep in _RENAMES:
        name = re.sub(pat, rep, name)
    return name


def _flatten(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def state_dict_from_jax(variables) -> dict[str, torch.Tensor]:
    """flax ``{'params', 'batch_stats'}`` tree -> the port's ``state_dict``."""
    sd = {}
    for path, leaf in _flatten(variables["params"]):
        prefix, kind = torch_prefix(path[:-1]), path[-1]
        if kind == "kernel":
            axes = (3, 2, 0, 1) if leaf.ndim == 4 else (1, 0)
            sd[f"{prefix}.weight"] = np.transpose(leaf, axes)
        elif kind == "scale":
            sd[f"{prefix}.weight"] = leaf
        elif kind == "bias":
            sd[f"{prefix}.bias"] = leaf
        else:
            raise ValueError(f"unexpected flax leaf {'/'.join(path)}")
    for path, leaf in _flatten(variables.get("batch_stats", {})):
        prefix, kind = torch_prefix(path[:-1]), path[-1]
        stat = {"mean": "running_mean", "var": "running_var"}[kind]
        sd[f"{prefix}.{stat}"] = leaf
        sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=v.dtype))
            for k, v in sd.items()}


def load_jax_variables(model: nn.Module, variables) -> nn.Module:
    """Load a flax tree into ``model``.

    Every key of the tree must land, and every parameter of the model must
    be given, except the grayscale stem (``conv.*``), which the reference
    always defines but a JAX tree holds only when it was initialised on
    1-channel input.
    """
    missing, unexpected = model.load_state_dict(
        state_dict_from_jax(variables), strict=False)
    missing = [k for k in missing if not k.startswith("conv.")]
    if missing or unexpected:
        raise KeyError(f"flax tree does not fit the model: missing {missing}, "
                       f"unexpected {unexpected}")
    return model

"""Model registry: ``get_model(name, ...)`` builds any registered model.

Port of ``pranet2_tpu/models/registry.py``.  ``get_model`` also places the
model: it initialises the weights from an explicit ``torch.Generator``
(seed 0 when none is given), moves them to the device (the GPU unless the
caller names one) and casts the convolutions to ``dtype``.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from pranet2_tpu_torch.device import resolve
from pranet2_tpu_torch.nn import init_weights_, set_compute_dtype

_REGISTRY: dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"duplicate model name {name!r}")
        _REGISTRY[name] = fn
        return fn

    return deco


def get_model(name: str, device=None, dtype: torch.dtype | None = None,
              generator: torch.Generator | None = None, **kwargs):
    """Build model ``name`` with random weights on ``device``.

    ``dtype`` (e.g. ``torch.bfloat16``) is the compute type of the
    convolutions; BatchNorm stays float32.  Load real weights afterwards with
    ``load_state_dict`` (reference checkpoint) or
    ``utils.convert.load_jax_variables`` (JAX package).
    """
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    device = resolve(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = init_weights_(_REGISTRY[name](**kwargs), generator).to(device)
    if dtype is not None:
        set_compute_dtype(model, dtype)
    return model


def list_models() -> list[str]:
    return sorted(_REGISTRY)

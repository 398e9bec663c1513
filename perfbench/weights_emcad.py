"""Seeded weights for an EMCAD configuration, made on the device in one
draw: ``weights.py``'s rules (LeCun-normal kernels with the ReLU gain,
BatchNorm and LayerNorm scales near 1 and shifts near 0, BatchNorm's
running statistics drawn), over the names and shapes of
``reference/emcad.py`` (built on the meta device), which takes the
program's ``state_dict`` keys.

BatchNorm's running statistics are then calibrated on two seeded
one-channel CT slices (``volumes.ct_batches``, the traffic's kind of
input) and jittered, as ``weights.calibrate`` does on RGB images for
PraNet.  The configuration's ``weights.scale`` (glob pattern -> factor)
scales tensors after the draw, before the calibration.
"""

from __future__ import annotations

import fnmatch
import math

import torch
from torch import nn

from perfbench import volumes, weights
from perfbench.reference import emcad
from perfbench.reference.serve import no_tf32


def make_state_dict(config: dict, seed: int, device,
                    calib_size: int | None = None) -> dict:
    """The configuration's weights drawn from ``seed`` on ``device``,
    float32, BatchNorm's statistics calibrated at ``calib_size`` (the
    configuration's input size when None)."""
    with torch.device("meta"):
        ref = emcad.build(config)
    shapes = {k: v.shape for k, v in ref.state_dict().items()}
    kinds = weights._kinds(ref)
    missing = set(shapes) - set(kinds)
    if missing:
        raise ValueError(f"no rule for {sorted(missing)[:5]}")
    floats = [k for k in shapes if kinds[k] != "count"]
    total = sum(math.prod(shapes[k]) for k in floats)
    g = torch.Generator(device=device).manual_seed(weights.subseed(seed, 1))
    flat = torch.randn(total, generator=g, device=device)
    sd, at = {}, 0
    for k, shape in shapes.items():
        kind = kinds[k]
        if kind == "count":
            sd[k] = torch.zeros((), dtype=torch.long, device=device)
            continue
        n = math.prod(shape)
        z = flat[at:at + n].view(shape)
        at += n
        if kind == "kernel":
            z = z * (weights.GAIN / math.sqrt(math.prod(shape[1:])))
        elif kind == "scale":
            z = 1.0 + 0.1 * z
        elif kind in ("shift", "bias", "mean"):
            z = 0.1 * z
        elif kind == "var":
            z = torch.exp(0.2 * z)
        sd[k] = z
    for pattern, factor in config.get("weights", {}).get("scale", {}).items():
        for k in fnmatch.filter(sd, pattern):
            sd[k] = sd[k] * factor
    return calibrate(config, sd, seed, calib_size or config["input_size"])


def calibrate(config: dict, sd: dict, seed: int, size: int) -> dict:
    """``sd`` with each BatchNorm's running statistics set to those of a
    training-mode forward of the float32 reference over two seeded CT
    slices of ``size``, then jittered as ``weights.calibrate`` jitters
    them (means by 0.05 standard deviations, variances by exp(0.05 z))."""
    device = next(iter(sd.values())).device
    with torch.device(device):
        ref = emcad.build(config)
    ref.load_state_dict(sd)
    bns = [m for m in ref.modules()
           if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    for m in bns:
        m.momentum = 1.0
    x = volumes.ct_batches(1, 2, size, weights.subseed(seed, 2), device)[0]
    g = torch.Generator(device=device).manual_seed(weights.subseed(seed, 7))
    with no_tf32(), torch.no_grad():
        ref.train()(x)
    out = dict(sd)
    with torch.no_grad():
        for name, m in ref.named_modules():
            if m in bns:
                mean, var = m.running_mean, m.running_var
                z = torch.randn((2, mean.numel()), generator=g,
                                device=device)
                out[f"{name}.running_mean"] = mean + 0.05 * var.sqrt() * z[0]
                out[f"{name}.running_var"] = var * torch.exp(0.05 * z[1])
    return out

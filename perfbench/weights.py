"""Seeded weights for a configuration, made on the device in one draw.

The names and shapes come from the benchmark's reference model (built on
the meta device), which takes the program's ``state_dict`` keys; both
sides load the same dict.  Convolution and Linear kernels are LeCun
normal with the ReLU gain; BatchNorm and LayerNorm scales lie near 1 and
shifts near 0, and BatchNorm's running statistics are drawn too, so that
a program that folds BatchNorm into its kernels is exercised.  Drawn
blindly, running statistics would let activations grow without bound
through fifty layers; so they are first measured on one seeded batch
(``calibrate``) and then moved off by a random share, which keeps every
stage near unit scale and the logits in sigmoid's working range.

A configuration may scale some tensors after the draw (``weights.scale``:
glob pattern -> factor).  Res2Net's configuration scales the last
BatchNorm of each residual branch (``bn3.weight``) to 0.2: with it at 1 a
random fifty-layer residual network is chaotic, and rounding the
convolutions' operands to bf16 moves its logits by 30-60% (an fp8
rounding only twice as far), so that no check could tell bf16 from fp8;
at 0.2, as trained ResNets keep those scales small (and as their
zero-init practice starts them), bf16 moves them by 3-7% and fp8 by
35-70%.  PVTv2-b2's configuration scales each block's two residual
branch outputs (``attn.proj`` and ``mlp.fc2`` kernels) to 0.2 for the
same reason, which brings them near PVTv2's own initialisation (std
0.02): on the CPU at 352, one image with every tensor in bf16 moved the
logits by 6.4-7.0% at 1 and 2.9-3.2% at 0.2.
"""

from __future__ import annotations

import fnmatch
import math

import torch
from torch import nn

from perfbench import images
from perfbench.reference import pranet

GAIN = math.sqrt(2.0)


def subseed(seed: int, stream: int) -> int:
    """A seed for one of a run's independent draws (weights, traffic,
    samples), mixed from the run's ``seed`` (any size) by a fixed rule."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9)
    x &= (1 << 64) - 1
    x ^= x >> 31
    return x & ((1 << 63) - 1)


def _kinds(model: nn.Module) -> dict:
    """State-dict key -> 'kernel', 'bias', 'scale', 'shift', 'mean', 'var'
    or 'count'."""
    kinds = {}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            kinds.update({pre + "weight": "scale", pre + "bias": "shift",
                          pre + "running_mean": "mean",
                          pre + "running_var": "var",
                          pre + "num_batches_tracked": "count"})
        elif isinstance(mod, nn.LayerNorm):
            kinds.update({pre + "weight": "scale", pre + "bias": "shift"})
        elif isinstance(mod, (pranet.Conv, pranet.Linear)):
            kinds[pre + "weight"] = "kernel"
            if mod.bias is not None:
                kinds[pre + "bias"] = "bias"
    return kinds


def make_state_dict(config: dict, seed: int, device,
                    calib_size: int | None = None) -> dict:
    """The configuration's weights drawn from ``seed`` on ``device``:
    one ``torch.randn`` for every float tensor, float32, then BatchNorm's
    running statistics calibrated at ``calib_size`` (the configuration's
    input size when None)."""
    with torch.device("meta"):
        ref = pranet.build(config)
    shapes = {k: v.shape for k, v in ref.state_dict().items()}
    kinds = _kinds(ref)
    missing = set(shapes) - set(kinds)
    if missing:
        raise ValueError(f"no rule for {sorted(missing)[:5]}")
    floats = [k for k in shapes if kinds[k] != "count"]
    total = sum(math.prod(shapes[k]) for k in floats)
    g = torch.Generator(device=device).manual_seed(subseed(seed, 1))
    flat = torch.randn(total, generator=g, device=device)
    sd, at = {}, 0
    for k in shapes:
        if kinds[k] == "count":
            sd[k] = torch.zeros((), dtype=torch.long, device=device)
            continue
        n = math.prod(shapes[k])
        z = flat[at:at + n].view(shapes[k])
        at += n
        kind = kinds[k]
        if kind == "kernel":
            z = z * (GAIN / math.sqrt(math.prod(shapes[k][1:])))
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
    training-mode forward of the float32 reference over two seeded images
    of ``size`` like the traffic's (``images.image_batches``), then the
    means moved by 0.05 standard deviations and the variances scaled by
    exp(0.05 z), z standard normal: random statistics at a realistic
    scale (a wider jitter compounds through the residual stages: exp(0.2
    z) grew layer 4's output 30-fold)."""
    device = next(iter(sd.values())).device
    with torch.device(device):
        ref = pranet.build(config)
    ref.load_state_dict(sd)
    bns = [m for m in ref.modules()
           if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    for m in bns:
        m.momentum = 1.0
    x = images.image_batches(1, 2, size, subseed(seed, 2), device)[0]
    g = torch.Generator(device=device).manual_seed(subseed(seed, 7))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            ref.train()(x)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
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

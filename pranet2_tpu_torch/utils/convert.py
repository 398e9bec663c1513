"""Carry weights into the port: from the JAX package's flax variables, or
from a reference ``.pth``.

``state_dict_from_jax`` takes a ``{'params': ..., 'batch_stats': ...}`` tree
of numpy arrays and returns the port's ``state_dict``: conv kernels HWIO ->
OIHW (grouped and depthwise ones too: ``(kh, kw, cin/g, cout)`` ->
``(cout, cin/g, kh, kw)``), Dense kernels (in, out) -> Linear (out, in),
BatchNorm and LayerNorm ``scale/bias`` -> ``weight/bias`` and BatchNorm
``mean/var`` -> ``running_mean/running_var``; MaxViT's LayerScale
``ls_gamma``/``ls1_gamma``/``ls2_gamma`` -> ``ls.gamma``/``ls1.gamma``/
``ls2.gamma`` and its ``relative_position_bias_table`` as it is; MIST's
``in_proj_q/k/v`` packed into ``nn.MultiheadAttention``'s
``in_proj_weight`` (3C, C) and ``in_proj_bias`` (the inverse of the JAX
package's ``split_packed_mha``).  The names are the inverse of the JAX
package's ``res2net_key_map``, ``resnet_key_map``, ``pvtv2_key_map``,
``pranet_key_map``, ``emcad_key_map``, ``maxvit_key_map``,
``merit_key_map``, ``maxvit_single_key_map`` and ``mist_key_map``; the
port keeps the reference checkpoint's names, so a reference ``.pth``
loads with plain ``load_state_dict``.  The JAX package calls every encoder
``backbone``; the reference (and so the port) calls PraNet-V1's Res2Net
and ResNet encoders ``resnet`` (the model's ``encoder_name``), which
``encoder=`` renames.

``load_reference_state_dict`` reads a reference ``.pth`` (the port's copy
of ``pranet2_tpu/utils/torch_convert.py::load_torch_state_dict``) and
``load_reference`` loads it into a model, dropping and reporting the keys
that the JAX package's key maps drop too (classifier heads, thop's
counters, MIST's dead ``decoder.block_N.conv3``).
"""

from __future__ import annotations

import logging
import re

import numpy as np
import torch
from torch import nn

log = logging.getLogger(__name__)

# flax path (joined with '.') -> torch prefix, applied in order
_RENAMES = (
    (r"^stem_conv$", "conv.0"),
    (r"^stem_bn$", "conv.1"),
    # MaxViT (backbone, backbone1, backbone2) and the MERIT zoo's stem
    (r"^gray\.stem_conv$", "conv.0"),
    (r"^gray\.stem_bn$", "conv.1"),
    (r"^(backbone\d?)\.stem_(conv1|norm1|conv2)$", r"\1.stem.\2"),
    (r"^(backbone\d?)\.stages_(\d)_blocks_(\d+)\.",
     r"\1.stages.\2.blocks.\3."),
    (r"^(backbone\d?\.stages\.\d\.blocks\.\d+\..+)\.mlp_(fc[12])$",
     r"\1.mlp.\2"),
    (r"^(backbone\d?\..+\.attn\.rel_pos)\.(fc[12])$", r"\1.mlp.\2"),
    # the CASCADE decoders: convs and BatchNorms in Sequentials
    (r"^decoder\.(ConvBlock\d)\.(?:conv|bn)(\d)$", r"decoder.\1.conv.\2"),
    (r"^decoder\.(Up\d)\.conv$", r"decoder.\1.up.1"),
    (r"^decoder\.(Up\d)\.bn$", r"decoder.\1.up.2"),
    (r"^decoder\.(AG\d)\.(W_g|W_x|psi)$", r"decoder.\1.\2.0"),
    (r"^decoder\.(AG\d)\.(W_g|W_x|psi)_bn$", r"decoder.\1.\2.1"),
    # MIST's attention is an nn.MultiheadAttention named ``attention``
    (r"^(decoder\.block_\d\.trans\.attention_output)"
     r"\.(in_proj_[qkv]|out_proj)$", r"\1.attention.\2"),
    (r"^backbone\.conv1_(\d)$", r"backbone.conv1.\1"),
    (r"(^|\.)layer(\d)_(\d+)\.", r"\1layer\2.\3."),
    (r"\.(convs|bns|downsample)_(\d)$", r".\1.\2"),
    (r"\.branch(\d)_(\d)\.", r".branch\1.\2."),
    (r"^ra([234])\.", r"ra\1_"),
    (r"\.block(\d)_(\d+)\.", r".block\1.\2."),
    (r"\.patch_embed(\d)_(proj|norm)$", r".patch_embed\1.\2"),
    (r"\.mlp\.dwconv$", ".mlp.dwconv.dwconv"),
    # EMCAD's decoder: each MSCB is the first of a Sequential, its depthwise
    # convs in ``msdc.dwconvs``; convs and BatchNorms in Sequentials
    (r"^decoder\.(mscb\d)\.dwconv(\d)(_bn)?$", r"decoder.\1.msdc.dwconvs.\2\3"),
    (r"^decoder\.(mscb\d)\.", r"decoder.\1.0."),
    (r"^decoder\.(eucb\d)\.up_dwc$", r"decoder.\1.up_dwc.1"),
    (r"^decoder\.(eucb\d)\.up_dwc_bn$", r"decoder.\1.up_dwc.2"),
    (r"^decoder\.(eucb\d)\.pwc$", r"decoder.\1.pwc.0"),
    (r"^decoder\.((mscb\d\.0\.(pconv[12]|msdc\.dwconvs\.\d))"
     r"|lgag\d\.(W_g|W_x|psi))_bn$", r"decoder.\1.1"),
    (r"^decoder\.((mscb\d\.0\.(pconv[12]|msdc\.dwconvs\.\d))"
     r"|lgag\d\.(W_g|W_x|psi))$", r"decoder.\1.0"),
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


# MaxViT's parameters that are neither a kernel, a scale nor a bias: the
# leaf name -> the torch name under the leaf's module
_LEAVES = {"ls_gamma": "ls.gamma", "ls1_gamma": "ls1.gamma",
           "ls2_gamma": "ls2.gamma",
           "relative_position_bias_table": "relative_position_bias_table"}


def _pack_mha(sd: dict) -> None:
    """``<p>.in_proj_{q,k,v}.{weight,bias}`` -> ``<p>.in_proj_weight``
    (3C, C) and ``<p>.in_proj_bias`` (3C,), q then k then v, in place."""
    for key in [k for k in sd if k.endswith(".in_proj_q.weight")]:
        p = key[:-len(".in_proj_q.weight")]
        for kind in ("weight", "bias"):
            sd[f"{p}.in_proj_{kind}"] = np.concatenate(
                [sd.pop(f"{p}.in_proj_{n}.{kind}") for n in "qkv"])


def state_dict_from_jax(variables, encoder: str = "backbone"
                        ) -> dict[str, torch.Tensor]:
    """flax ``{'params', 'batch_stats'}`` tree -> the port's ``state_dict``,
    the tree's ``backbone`` named ``encoder``."""
    def prefix_of(path):
        name = torch_prefix(path)
        if name.startswith("backbone."):
            name = encoder + name[len("backbone"):]
        return name

    sd = {}
    for path, leaf in _flatten(variables["params"]):
        prefix, kind = prefix_of(path[:-1]), path[-1]
        if kind == "kernel":
            axes = (3, 2, 0, 1) if leaf.ndim == 4 else (1, 0)
            sd[f"{prefix}.weight"] = np.transpose(leaf, axes)
        elif kind == "scale":
            sd[f"{prefix}.weight"] = leaf
        elif kind == "bias":
            sd[f"{prefix}.bias"] = leaf
        elif kind in _LEAVES:
            sd[f"{prefix}.{_LEAVES[kind]}"] = leaf
        else:
            raise ValueError(f"unexpected flax leaf {'/'.join(path)}")
    _pack_mha(sd)
    for path, leaf in _flatten(variables.get("batch_stats", {})):
        prefix, kind = prefix_of(path[:-1]), path[-1]
        stat = {"mean": "running_mean", "var": "running_var"}[kind]
        sd[f"{prefix}.{stat}"] = leaf
        sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=v.dtype))
            for k, v in sd.items()}


def load_jax_variables(model: nn.Module, variables) -> nn.Module:
    """Load a flax tree into ``model`` (its encoder named by the model's
    ``encoder_name``, ``backbone`` when it has none).

    Every key of the tree must land, and every parameter of the model must
    be given, except a grayscale stem (PraNet-V2's ``conv.*``), which the
    reference always defines but a JAX tree holds only when it was
    initialised on 1-channel input.
    """
    missing, unexpected = model.load_state_dict(
        state_dict_from_jax(variables,
                            getattr(model, "encoder_name", "backbone")),
        strict=False)
    if isinstance(getattr(model, "conv", None), nn.Sequential):
        missing = [k for k in missing if not k.startswith("conv.")]
    if missing or unexpected:
        raise KeyError(f"flax tree does not fit the model: missing {missing}, "
                       f"unexpected {unexpected}")
    return model


def load_reference_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A reference ``.pth`` as a flat ``state_dict`` on the CPU.

    ``torch.load(weights_only=True)``; the ``state_dict`` / ``model`` /
    ``net`` / ``model_state_dict`` container unwrapped; the ``module.``
    prefix that ``nn.DataParallel`` puts on every key stripped; only
    tensors kept.
    """
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model", "net", "model_state_dict"):
        if (isinstance(sd, dict) and wrapper in sd
                and isinstance(sd[wrapper], dict)):
            sd = sd[wrapper]
            break
    out = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    if out and all(k.startswith("module.") for k in out):
        out = {k[len("module."):]: v for k, v in out.items()}
    return out


# keys of a reference checkpoint that no model of the port holds and the JAX
# package's key maps drop too (torch_convert.py:135-141,151,206,317):
# classifier heads (a MaxViT's whole ``head``), the average pool, thop's
# profiling counters and MIST's ``Block_decoder.conv3``, defined but dead in
# the reference forward
_DROPPED = re.compile(r"(^|\.)(fc|head|avgpool)\.[^.]+$"
                      r"|(^|\.)(total_ops|total_params)$"
                      r"|^(backbone\d?\.)?head\."
                      r"|^decoder\.block_\d\.conv3\.")


def load_reference(model: nn.Module, state_dict) -> list[str]:
    """Load a reference ``state_dict`` into ``model``; returns the keys it
    dropped (also logged as a warning).

    A key the model does not hold is dropped where the JAX package's key
    maps drop it too, and is an error otherwise; a parameter or buffer of
    the model that the checkpoint lacks is an error, except
    ``num_batches_tracked``, which eval never reads.
    """
    own = model.state_dict()
    dropped = sorted(k for k in state_dict
                     if k not in own and _DROPPED.search(k))
    unexpected = sorted(k for k in state_dict
                        if k not in own and k not in dropped)
    missing = sorted(k for k in own if k not in state_dict
                     and not k.endswith("num_batches_tracked"))
    if missing or unexpected:
        raise KeyError(f"checkpoint does not fit the model: missing "
                       f"{missing[:10]}, unexpected {unexpected[:10]}")
    model.load_state_dict({k: v for k, v in state_dict.items() if k in own},
                          strict=False)
    if dropped:
        log.warning("load_reference: dropped %d keys the model does not "
                    "hold: %s", len(dropped), dropped)
    return dropped

"""Faulty copies of the port's plain Bottle2neck, each with one planted
fault, for showing that a kernel check rejects them.  Imports no JAX, so
the card tests use it too.

* ``wrong_eps``: the BatchNorms folded with eps 1e-3 instead of 1e-5
  (``fold``);
* ``no_hierarchical_add``: conv i reads u_i alone, not u_i + sp_{i-1};
* ``border_not_zeroed``: the 3x3 convs pad by repeating the border pixels
  instead of with zeros.
"""

import torch
import torch.nn.functional as F

from pranet2_tpu_torch.ops.res2_block import SCALE
from pranet2_tpu_torch.ops.res2_tail import (bn_relu, conv1x1, fold_bn,
                                             res2_tail_plain)

FAULTS = ("wrong_eps", "no_hierarchical_add", "border_not_zeroed")


def fold(fault: str, weight, bias, mean, var):
    return fold_bn(weight, bias, mean, var,
                   1e-3 if fault == "wrong_eps" else 1e-5)


def bottle2neck(fault: str, x, w1, s1, t1, wd, sd, td, w3, s3, t3):
    """``bottle2neck_plain`` with ``fault`` planted in its arithmetic (the
    ``wrong_eps`` fault lies in the folded arguments, see ``fold``)."""
    dt = x.dtype
    width = wd.shape[1]
    u = bn_relu(conv1x1(x, w1), s1, t1).to(dt)
    parts, sp = [], None
    for i in range(SCALE - 1):
        vin = u[:, i * width:(i + 1) * width]
        if sp is not None and fault != "no_hierarchical_add":
            vin = vin + sp
        if fault == "border_not_zeroed":
            acc = F.conv2d(F.pad(vin.float(), (1, 1, 1, 1), mode="replicate"),
                           wd[i].float())
        else:
            acc = F.conv2d(vin.float(), wd[i].float(), padding=1)
        sp = bn_relu(acc, sd[i], td[i]).to(dt)
        parts.append(sp)
    parts.append(u[:, (SCALE - 1) * width:])
    return res2_tail_plain(torch.cat(parts, 1), x, w3, s3, t3)

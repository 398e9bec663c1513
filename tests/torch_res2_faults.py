"""Faulty copies of the port's plain Bottle2neck, each with one planted
fault, for showing that a kernel check rejects them.  Imports no JAX, so
the card tests use it too.

* ``wrong_eps``: the BatchNorms folded with eps 1e-3 instead of 1e-5
  (``fold``);
* ``no_hierarchical_add``: conv i reads u_i alone, not u_i + sp_{i-1};
* ``border_not_zeroed``: the 3x3 convs pad by repeating the border pixels
  instead of with zeros;
* ``halo_column_dropped``: the 3x3 convs see zeros in the halo column right
  of every pixel tile of the bfloat16 kernel's (``tile``);
* ``halo_add_skipped``: the hierarchical add applied inside each pixel tile
  but not on its halo, where conv i reads u_i alone.

The tile is the kernel's on a CUDA device (``ops.res2_block.conv3x3_tile``),
else 4 x 3 pixels, which cuts the CPU tests' small maps.
"""

import torch
import torch.nn.functional as F

from pranet2_tpu_torch.ops.res2_block import SCALE, conv3x3_tile
from pranet2_tpu_torch.ops.res2_tail import (bn_relu, conv1x1, fold_bn,
                                             res2_tail_plain)

FAULTS = ("wrong_eps", "no_hierarchical_add", "border_not_zeroed",
          "halo_column_dropped", "halo_add_skipped")


def fold(fault: str, weight, bias, mean, var):
    return fold_bn(weight, bias, mean, var,
                   1e-3 if fault == "wrong_eps" else 1e-5)


def _tile(x, width):
    n, c, h, w = x.shape
    return conv3x3_tile(n, c, width, h, w)[:2] if x.is_cuda else (4, 3)


def _conv3x3(fault, u_i, sp, w, tile):
    """conv i's float32 product of u_i (+ sp, rounded) with ``fault``."""
    dt = u_i.dtype
    vin = u_i if sp is None else u_i + sp
    if fault == "border_not_zeroed":
        return F.conv2d(F.pad(vin.float(), (1, 1, 1, 1), mode="replicate"),
                        w.float())
    conv = lambda t: F.conv2d(t.float(), w.float(), padding=1)
    _, _, h, wd = vin.shape
    th, tw = tile
    y = torch.arange(h, device=vin.device)[:, None]
    x = torch.arange(wd, device=vin.device)[None, :]
    if fault == "halo_column_dropped":
        # the right halo column x0 + tw of every tile read as zero
        cut = vin.masked_fill((x % tw == 0) & (x > 0), 0)
        return torch.where(x % tw == tw - 1, conv(cut), conv(vin))
    if fault == "halo_add_skipped" and sp is not None:
        out = torch.zeros_like(conv(vin))
        tile_id = (y // th) * -(-wd // tw) + x // tw
        for t in tile_id.unique():
            inside = tile_id == t
            out = torch.where(inside, conv(torch.where(inside, vin, u_i)), out)
        return out
    return conv(vin)


def bottle2neck(fault: str, x, w1, s1, t1, wd, sd, td, w3, s3, t3):
    """``bottle2neck_plain`` with ``fault`` planted in its arithmetic (the
    ``wrong_eps`` fault lies in the folded arguments, see ``fold``)."""
    dt = x.dtype
    width = wd.shape[1]
    u = bn_relu(conv1x1(x, w1), s1, t1).to(dt)
    tile = _tile(x, width)
    parts, sp = [], None
    for i in range(SCALE - 1):
        add = None if fault == "no_hierarchical_add" else sp
        acc = _conv3x3(fault, u[:, i * width:(i + 1) * width], add, wd[i],
                       tile)
        sp = bn_relu(acc, sd[i], td[i]).to(dt)
        parts.append(sp)
    parts.append(u[:, (SCALE - 1) * width:])
    return res2_tail_plain(torch.cat(parts, 1), x, w3, s3, t3)

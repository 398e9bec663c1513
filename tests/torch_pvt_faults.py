"""Faulty copies of the port's plain whole-half SRA, whole-block and
depthwise versions, each with one planted fault, for showing that a kernel
check rejects them.  Imports no JAX, so the card tests use it too.

* ``sr_window_transposed``: the sr x sr patch read (column, row) instead of
  (row, column) (``sra_block``);
* ``kv_ln_dropped``: the K/V path without its LayerNorm (``sra_block``);
* ``mlp_residual_from_x``: the MLP's residual taken from x instead of the
  attention half's output h (``pvt_block``);
* ``dw_taps_transposed``: the depthwise taps read w[dj, di]
  (``depthwise_conv3x3``).
"""

from pranet2_tpu_torch.ops.dwconv import depthwise_conv3x3_plain
from pranet2_tpu_torch.ops.pvt_attn import (KV_EPS, attend_plain, ln1_plain,
                                            sr_weight, sra_block_plain)
from pranet2_tpu_torch.ops.pvt_mlp import layer_norm_f32, mlp_block_plain

SRA_FAULTS = ("sr_window_transposed", "kv_ln_dropped")
FAULTS = (*SRA_FAULTS, "mlp_residual_from_x", "dw_taps_transposed")


def sra_block(fault, x, norm_w, norm_b, wq, bq, sr_w, sr_b, kvn_w, kvn_b,
              wkv, bkv, wp, bp, num_heads, sr, eps=1e-6):
    """``sra_block_plain`` with ``fault`` (one of ``SRA_FAULTS``, sr > 1)
    planted in its K/V path."""
    dt = x.dtype
    yb = ln1_plain(x, norm_w, norm_b, eps)
    n, h, w, d = yb.shape
    hs, ws = h // sr, w // sr
    p = yb[:, :hs * sr, :ws * sr].reshape(n, hs, sr, ws, sr, d)
    order = ((0, 1, 3, 4, 2, 5) if fault == "sr_window_transposed"
             else (0, 1, 3, 2, 4, 5))
    p = p.permute(*order).reshape(n, hs * ws, sr * sr * d)
    s = p.float() @ sr_weight(sr_w).float().t() + sr_b.float()
    kvi = (s if fault == "kv_ln_dropped"
           else layer_norm_f32(s, kvn_w, kvn_b, KV_EPS)).to(dt)
    kv = (kvi.float() @ wkv.float().t() + bkv.float()).to(dt)
    return attend_plain(x, yb, wq, bq, kv, wp, bp, num_heads, True)


def pvt_block(fault, x, *args, num_heads, sr, eps=1e-6, eps2=1e-6):
    """``pvt_block_plain`` (``args``: its tensors after x) with the MLP's
    residual taken from x."""
    assert fault == "mlp_residual_from_x"
    h = sra_block_plain(x, *args[:12], num_heads, sr, eps)
    o = mlp_block_plain(h, *args[12:], eps2)
    return (x.float() + (o.float() - h.float())).to(x.dtype)


def depthwise_conv3x3(fault, x, w):
    """``depthwise_conv3x3_plain`` with its taps transposed."""
    assert fault == "dw_taps_transposed"
    return depthwise_conv3x3_plain(x, w.transpose(0, 1).contiguous())


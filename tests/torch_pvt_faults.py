"""Faulty copies of the port's plain whole-half SRA, whole-block and
depthwise versions, each with one planted fault, for showing that a kernel
check rejects them.  Imports no JAX, so the card tests use it too.

* ``sr_window_transposed``: the sr x sr patch read (column, row) instead of
  (row, column) (``sra_block``);
* ``kv_ln_dropped``: the K/V path without its LayerNorm (``sra_block``);
* ``kv_patch_row_dropped``: the patch product without its last patch
  row, one split-K part of the K/V kernel (``sra_block``);
* ``mlp_residual_from_x``: the MLP's residual taken from x instead of the
  attention half's output h (``pvt_block``);
* ``mlp_tile_halo_dropped``: the depthwise 3x3 of the MLP seeing zeros
  across every edge of the MLP launch's R-row tiles (``pvt_block``; R as
  ``ops.pvt_mlp.mlp_tile`` reads it from the launch on a CUDA device,
  else 4, the most rows a tile takes);
* ``dw_taps_transposed``: the depthwise taps read w[dj, di]
  (``depthwise_conv3x3``);
* ``heads_rotated``: the projection reading head (h + 1) mod nh's output
  in place of head h's, a head exchange between blocks gone wrong
  (``sra_attention``);
* ``kv_pad_in_softmax``: K/V zero-padded to a multiple of 32 keys, the
  padded scores kept in the max and the sum (``sra_attention``);
* ``stats_unrounded``: the (mu, rstd) of the MLP's output taken before its
  rounding to x's type (``mlp_block``, stats mode);
* ``final_ln_rounded``: the output rounded to x's type before the stage
  LayerNorm (``mlp_block``, final_ln mode).
"""

import torch
import torch.nn.functional as F

from pranet2_tpu_torch.ops.dwconv import depthwise_conv3x3_plain
from pranet2_tpu_torch.ops.pvt_attn import (KV_EPS, attend_plain, ln1_plain,
                                            sr_weight, sra_block_plain)
from pranet2_tpu_torch.ops.pvt_mlp import (gelu_poly, layer_norm_f32,
                                           ln_stats, mlp_block_plain,
                                           mlp_tile)

ATTN_FAULTS = ("heads_rotated", "kv_pad_in_softmax")
SRA_FAULTS = ("sr_window_transposed", "kv_ln_dropped", "kv_patch_row_dropped")
BLOCK_FAULTS = ("mlp_residual_from_x", "mlp_tile_halo_dropped")
MLP_FAULTS = ("stats_unrounded", "final_ln_rounded")
FAULTS = (*SRA_FAULTS, *BLOCK_FAULTS, "dw_taps_transposed")


def attend(fault, x, yb, wq, bq, kv, wp, bp, num_heads, exact_residual):
    """``attend_plain`` with ``fault`` (one of ``ATTN_FAULTS``) planted."""
    dt = x.dtype
    n, h, w, d = x.shape
    hd = d // num_heads
    q = (yb.reshape(n, h * w, d).float() @ wq.float().t()
         + bq.float()) * (1.0 / hd ** 0.5)
    heads = lambda t: t.reshape(n, -1, num_heads, hd).transpose(1, 2)
    if fault == "kv_pad_in_softmax":
        kv = F.pad(kv, (0, 0, 0, -kv.shape[1] % 32))
    q = heads(q.to(dt)).float()
    k, v = (heads(t).float() for t in kv.split(d, dim=-1))
    s = q @ k.transpose(-1, -2)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = (p.to(dt).float() @ v) / p.sum(-1, keepdim=True)
    if fault == "heads_rotated":
        o = o.roll(-1, dims=1)
    else:
        assert fault == "kv_pad_in_softmax"
    o = o.transpose(1, 2).reshape(n, h * w, d).to(dt)
    out = (o.float() @ wp.float().t() + bp.float()).reshape(n, h, w, d)
    if exact_residual:
        return (x.float() + out).to(dt)
    return x + out.to(dt)


def sra_attention(fault, x, norm_w, norm_b, wq, bq, kv, wp, bp, num_heads,
                  eps=1e-6):
    """``sra_attention_plain`` with ``fault`` (one of ``ATTN_FAULTS``)
    planted in its attention."""
    return attend(fault, x, ln1_plain(x, norm_w, norm_b, eps), wq, bq, kv,
                  wp, bp, num_heads, False)


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
    p = p.permute(*order)
    if fault == "kv_patch_row_dropped":
        p = p.clone()
        p[:, :, :, sr - 1] = 0
    p = p.reshape(n, hs * ws, sr * sr * d)
    s = p.float() @ sr_weight(sr_w).float().t() + sr_b.float()
    kvi = (s if fault == "kv_ln_dropped"
           else layer_norm_f32(s, kvn_w, kvn_b, KV_EPS)).to(dt)
    kv = (kvi.float() @ wkv.float().t() + bkv.float()).to(dt)
    return attend_plain(x, yb, wq, bq, kv, wp, bp, num_heads, True)


def _mlp_out(h, norm_w, norm_b, w1, b1, dw_w, dw_b, w2, b2, eps,
             rows=None):
    """The float32 fc2 output of ``mlp_block_plain`` (before its residual
    and rounding); with ``rows``, its depthwise 3x3 sees zeros above the
    first and below the last row of every ``rows``-row tile."""
    n, hh, w, d = h.shape
    yb = layer_norm_f32(h.float(), norm_w, norm_b, eps).to(h.dtype)
    z = yb.float() @ w1.float().t() + b1.float()
    zp = F.pad(z, (0, 0, 1, 1, 1, 1))
    i = torch.arange(hh, device=h.device)
    # the tap row di - 1 lies in another tile
    cut = {} if rows is None else {0: i % rows == 0, 2: i % rows == rows - 1}
    taps = dw_w.float()[:, 0]
    acc = torch.zeros_like(z)
    for dj in range(3):
        for di in range(3):
            t = zp[:, di:di + hh, dj:dj + w]
            if di in cut:
                t = t.masked_fill(cut[di].view(1, hh, 1, 1), 0.0)
            acc = acc + t * taps[:, di, dj]
    g = gelu_poly(acc + dw_b.float()).to(h.dtype)
    return g.float() @ w2.float().t() + b2.float()


def mlp_tile_halo_dropped(h, norm_w, norm_b, w1, b1, dw_w, dw_b, w2, b2,
                          eps, rows):
    """``mlp_block_plain`` whose depthwise 3x3 sees zeros above the first
    and below the last row of every ``rows``-row tile."""
    return h + _mlp_out(h, norm_w, norm_b, w1, b1, dw_w, dw_b, w2, b2, eps,
                        rows).to(h.dtype)


def mlp_block(fault, x, norm_w, norm_b, w1, b1, dw_w, dw_b, w2, b2,
              eps=1e-6, stats_eps=None, final_ln=None, final_eps=1e-6):
    """``mlp_block_plain`` with ``fault`` (one of ``MLP_FAULTS``) planted
    in its epilogue: ``stats_unrounded`` needs ``stats_eps``,
    ``final_ln_rounded`` ``final_ln``."""
    out = _mlp_out(x, norm_w, norm_b, w1, b1, dw_w, dw_b, w2, b2, eps)
    ob = x + out.to(x.dtype)
    if fault == "stats_unrounded":
        return (ob, *ln_stats(x.float() + out, stats_eps))
    assert fault == "final_ln_rounded"
    return layer_norm_f32(ob.float(), *final_ln, final_eps).to(x.dtype)


def pvt_block(fault, x, *args, num_heads, sr, eps=1e-6, eps2=1e-6):
    """``pvt_block_plain`` (``args``: its tensors after x) with ``fault``
    (one of ``BLOCK_FAULTS``) planted in its MLP half."""
    h = sra_block_plain(x, *args[:12], num_heads, sr, eps)
    if fault == "mlp_tile_halo_dropped":
        rows = (mlp_tile(*x.shape, args[14].shape[0], x.dtype)[0]
                if x.is_cuda else 4)
        return mlp_tile_halo_dropped(h, *args[12:], eps2, rows)
    assert fault == "mlp_residual_from_x"
    o = mlp_block_plain(h, *args[12:], eps2)
    return (x.float() + (o.float() - h.float())).to(x.dtype)


def depthwise_conv3x3(fault, x, w):
    """``depthwise_conv3x3_plain`` with its taps transposed."""
    assert fault == "dw_taps_transposed"
    return depthwise_conv3x3_plain(x, w.transpose(0, 1).contiguous())


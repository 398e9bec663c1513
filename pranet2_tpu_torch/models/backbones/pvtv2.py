"""PVTv2 backbone, the PVT-PraNet encoder: a pyramid ViT with spatial-
reduction attention.

Port of ``pranet2_tpu/models/backbones/pvtv2.py`` with the reference's
attribute names (``patch_embed{1-4}.{proj,norm}``,
``block{1-4}.{i}.{norm1,attn.{q,kv,proj,sr,norm},norm2,mlp.{fc1,dwconv.dwconv,fc2}}``,
``norm{1-4}``).

* 4 stages; each = overlapping patch embed (7x7/4, then 3x3/2 convs) + LN
  (eps 1e-5) -> N blocks -> LN (eps 1e-6).
* Block = x + SRA(LN1 x), then x + MLP(LN2 x).  SRA: queries from every
  token; K/V from a stride-``sr`` ``sr`` x ``sr`` conv + LN (eps 1e-5) of
  LN1's output (LN1's output itself at sr = 1, stage 4), then the ``kv``
  Linear.  MLP: fc1 -> depthwise 3x3 -> GELU -> fc2.
* Inside the backbone tokens stay channels-last, (N, H, W, C) contiguous,
  which LayerNorm, the Linears and both kernels want; the convolutions see
  them as NCHW views in channels-last memory.  The four stage maps come out
  NCHW for the heads.

Routing follows the JAX package's, decided by the compute dtype (the patch
embed's weight type), not by the device:

* bfloat16 in eval with autograd off: each block's attention half goes
  through ``ops.pvt_attn.sra_attention`` with the K/V path in plain
  PyTorch, and its MLP half through ``ops.pvt_mlp.mlp_block``: "stats" mode in the non-last
  blocks of a stage, whose (mu, rstd) feed the next block's K/V-path LN1,
  and "final_ln" mode in the last block, which applies ``norm{s}`` in its
  epilogue (``pranet2_tpu/models/backbones/pvtv2.py:263-312,380-403,
  495-526``).
* otherwise (float32, or training or autograd recording in any type):
  the module chain, with exact-erf GELU and plain softmax attention.  The
  kernels are forward only, and JAX trains on the chain too
  (``pvtv2.py:445-464``).

Two options select the JAX package's opt-in PVT kernels, in bfloat16:

* ``attn_impl``: "v1" (the default, above), "v2" or "auto:N", the JAX
  package's ``PVT_ATTN_IMPL`` (``pvtv2.py:257-266``).  A v2 stage runs each
  attention half, its K/V path included, through ``ops.pvt_attn.sra_block``;
  its blocks take no LN1 statistics, so their MLPs run in "plain" mode
  (the last one in "final_ln").  "auto:N" takes v2 for the stages with
  sr <= N (N is 1 when left out), v1 for the others.
* ``blockfuse``: in eval with autograd off, every block through
  ``ops.pvt_block.pvt_block``, both halves in one call, and the stage
  LayerNorm on its own (the JAX package's ``PRANET2_FUSED=blockfuse`` or
  ``PVTv2(fused_block=True)``, ``pvtv2.py:343-357,499-510``); it takes
  precedence over ``attn_impl``.

``stage_route`` holds the whole rule.  The parameters and the ``state_dict``
are the same on every route.

The JAX package's space-to-depth stage-1 patch embed is a TPU restructure of
the same convolution and is not carried over.

Stochastic depth: each block drops its attention and its MLP branch per
sample at its rate, a linear ramp from 0 at the first block to
``drop_path_rate`` (0.1, ``pvtv2.py:424,469``) at the last, in training
only (``nn.DropPath``; the module chain is the only route that trains).
Under the trainers' ``remat`` (``nn.remat``) the chain checkpoints each
block (``nn.checkpointed``): the same values, the block's activations
rebuilt in the backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pranet2_tpu_torch.nn import DropPath, LayerNorm, checkpointed
from pranet2_tpu_torch.ops.pvt_attn import sra_attention, sra_block
from pranet2_tpu_torch.ops.pvt_block import pvt_block
from pranet2_tpu_torch.ops.pvt_mlp import ln_stats, mlp_block

PVT_CONFIGS = {
    "b0": dict(embed_dims=(32, 64, 160, 256), depths=(2, 2, 2, 2),
               num_heads=(1, 2, 5, 8), mlp_ratios=(8, 8, 4, 4)),
    "b1": dict(embed_dims=(64, 128, 320, 512), depths=(2, 2, 2, 2),
               num_heads=(1, 2, 5, 8), mlp_ratios=(8, 8, 4, 4)),
    "b2": dict(embed_dims=(64, 128, 320, 512), depths=(3, 4, 6, 3),
               num_heads=(1, 2, 5, 8), mlp_ratios=(8, 8, 4, 4)),
    "b3": dict(embed_dims=(64, 128, 320, 512), depths=(3, 4, 18, 3),
               num_heads=(1, 2, 5, 8), mlp_ratios=(8, 8, 4, 4)),
    "b4": dict(embed_dims=(64, 128, 320, 512), depths=(3, 8, 27, 3),
               num_heads=(1, 2, 5, 8), mlp_ratios=(8, 8, 4, 4)),
    "b5": dict(embed_dims=(64, 128, 320, 512), depths=(3, 6, 40, 3),
               num_heads=(1, 2, 5, 8), mlp_ratios=(4, 4, 4, 4)),
}

SR_RATIOS = (8, 4, 2, 1)


def stage_attn_impl(attn_impl: str, sr: int) -> str:
    """The attention kernel, "v1" or "v2", of a stage of spatial-reduction
    ratio ``sr`` under ``attn_impl`` ("v1", "v2" or "auto:N"; "auto" is
    "auto:1"): the JAX package's rule for ``PVT_ATTN_IMPL``."""
    if attn_impl.startswith("auto"):
        max_sr = int(attn_impl.split(":")[1]) if ":" in attn_impl else 1
        return "v2" if sr <= max_sr else "v1"
    if attn_impl not in ("v1", "v2"):
        raise ValueError(f"attn_impl must be 'v1', 'v2' or 'auto:N', got "
                         f"{attn_impl!r}")
    return attn_impl


def stage_route(kernels: bool, training: bool, grad: bool, attn_impl: str,
                blockfuse: bool, sr: int) -> str:
    """How the blocks of a stage run: "chain" (the module chain: no
    kernels, as in float32, and in training or wherever autograd records
    (``grad``), since the kernels have no backward and JAX trains on the
    chain too), "block" (``pvt_block`` per block, then the stage LN:
    ``blockfuse``), else the attention kernel "v1" or "v2" with
    ``mlp_block``."""
    if not kernels or training or grad:
        return "chain"
    if blockfuse:
        return "block"
    return stage_attn_impl(attn_impl, sr)


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A convolution over channels-last tokens (N, H, W, C), tokens out."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()


class OverlapPatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, patch: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, patch, stride, patch // 2)
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        """NCHW map in, channels-last tokens (N, H, W, dim) out."""
        return self.norm(self.proj(x).permute(0, 2, 3, 1).contiguous())


class SRAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = LayerNorm(dim, eps=1e-5)

    def kv_tokens(self, y):
        """The K/V path on LN1's output: (N, Tkv, 2D)."""
        if self.sr_ratio > 1:
            y = self.norm(_conv_nhwc(self.sr, y))
        return self.kv(y).flatten(1, 2)

    def forward(self, y):
        """Module chain: y is LN1's output, (N, H, W, D)."""
        n, h, w, d = y.shape
        nh = self.num_heads
        hd = d // nh
        q = self.q(y).reshape(n, h * w, nh, hd).transpose(1, 2)
        k, v = (t.reshape(n, -1, nh, hd).transpose(1, 2)
                for t in self.kv_tokens(y).split(d, dim=-1))
        p = torch.softmax((q @ k.transpose(-1, -2)) * hd ** -0.5, dim=-1)
        o = (p @ v).transpose(1, 2).reshape(n, h, w, d)
        return self.proj(o)


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x):
        return _conv_nhwc(self.dwconv, x)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x))))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int,
                 sr_ratio: int, drop_path: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = SRAttention(dim, num_heads, sr_ratio)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * mlp_ratio)
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        """Module chain (float32 path, and training in any type)."""
        x = x + self.drop_path(self.attn(self.norm1(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))

    def attn_args(self):
        """``sra_block``'s parameters after x: LN1, q, the K/V path (None
        at sr = 1), kv, proj."""
        n1, a = self.norm1, self.attn
        kv_path = ((a.sr.weight, a.sr.bias, a.norm.weight, a.norm.bias)
                   if a.sr_ratio > 1 else (None,) * 4)
        return (n1.weight, n1.bias, a.q.weight, a.q.bias, *kv_path,
                a.kv.weight, a.kv.bias, a.proj.weight, a.proj.bias)

    def mlp_args(self):
        """``mlp_block``'s parameters after x: LN2, fc1, dwconv, fc2."""
        n2, m = self.norm2, self.mlp
        return (n2.weight, n2.bias, m.fc1.weight, m.fc1.bias,
                m.dwconv.dwconv.weight, m.dwconv.dwconv.bias, m.fc2.weight,
                m.fc2.bias)

    def forward_kernels(self, x, ln1_stats=None, final_norm=None,
                        whole_half=False):
        """Both halves through the kernels (bfloat16 path).

        ``ln1_stats``: the previous block's (mu, rstd) of x, which the K/V
        path's LN1 applies instead of reducing x again.  ``final_norm``: the
        stage-end LayerNorm, applied in the MLP's epilogue.  ``whole_half``:
        the attention half through ``sra_block``, which takes no statistics
        and makes the MLP give none.  Returns the block output and its
        (mu, rstd), or None after ``final_norm`` or with ``whole_half``.
        """
        n1, attn, n2 = self.norm1, self.attn, self.norm2
        if whole_half:
            x = sra_block(x, *self.attn_args(), attn.num_heads,
                          attn.sr_ratio, n1.eps)
        else:
            if ln1_stats is None:
                ln1_stats = ln_stats(x.float(), n1.eps)
            mu, rstd = (s[..., None] for s in ln1_stats)
            y = ((x.float() - mu) * rstd * n1.weight + n1.bias).to(x.dtype)
            x = sra_attention(x, n1.weight, n1.bias, attn.q.weight,
                              attn.q.bias, attn.kv_tokens(y),
                              attn.proj.weight, attn.proj.bias,
                              attn.num_heads, n1.eps)
        args = (x, *self.mlp_args(), n2.eps)
        if final_norm is not None:
            return mlp_block(*args, final_ln=(final_norm.weight,
                                              final_norm.bias),
                             final_eps=final_norm.eps), None
        if whole_half:
            return mlp_block(*args), None
        out, mu, rstd = mlp_block(*args, stats_eps=n1.eps)
        return out, (mu, rstd)

    def forward_block(self, x):
        """The whole block in one ``pvt_block`` call (bfloat16 eval path)."""
        return pvt_block(x, *self.attn_args(), *self.mlp_args(),
                         self.attn.num_heads, self.attn.sr_ratio,
                         self.norm1.eps, self.norm2.eps)


class PVTv2(nn.Module):
    """Returns the 4-stage NCHW feature pyramid (strides 4/8/16/32).
    ``attn_impl`` and ``blockfuse`` choose the bfloat16 kernels (see the
    module's docstring); ``drop_path_rate`` is the last block's stochastic
    depth in training."""

    def __init__(self, embed_dims=(64, 128, 320, 512), depths=(3, 4, 6, 3),
                 num_heads=(1, 2, 5, 8), mlp_ratios=(8, 8, 4, 4),
                 attn_impl: str = "v1", blockfuse: bool = False,
                 drop_path_rate: float = 0.1):
        super().__init__()
        for sr in SR_RATIOS:
            stage_attn_impl(attn_impl, sr)  # refuses an unknown name now
        self.attn_impl, self.blockfuse = attn_impl, blockfuse
        total = sum(depths)
        dpr = iter(drop_path_rate * i / max(total - 1, 1)
                   for i in range(total))
        cin = 3
        for s, dim in enumerate(embed_dims, start=1):
            patch, stride = (7, 4) if s == 1 else (3, 2)
            setattr(self, f"patch_embed{s}",
                    OverlapPatchEmbed(cin, dim, patch, stride))
            setattr(self, f"block{s}", nn.ModuleList(
                Block(dim, num_heads[s - 1], mlp_ratios[s - 1],
                      SR_RATIOS[s - 1], next(dpr))
                for _ in range(depths[s - 1])))
            setattr(self, f"norm{s}", LayerNorm(dim, eps=1e-6))
            cin = dim

    def forward(self, x):
        kernels = self.patch_embed1.proj.weight.dtype == torch.bfloat16
        outs = []
        for s in range(1, 5):
            x = getattr(self, f"patch_embed{s}")(x)
            blocks, norm = getattr(self, f"block{s}"), getattr(self, f"norm{s}")
            route = stage_route(kernels, self.training,
                                torch.is_grad_enabled(), self.attn_impl,
                                self.blockfuse, SR_RATIOS[s - 1])
            if route in ("chain", "block"):
                for blk in blocks:
                    x = (checkpointed(blk, x) if route == "chain"
                         else blk.forward_block(x))
                x = norm(x)
            else:
                stats = None
                for i, blk in enumerate(blocks):
                    last = i == len(blocks) - 1
                    x, stats = blk.forward_kernels(
                        x, stats, norm if last else None, route == "v2")
            x = x.permute(0, 3, 1, 2).contiguous()
            outs.append(x)
        return tuple(outs)


def pvt_v2(variant: str = "b2", **kw) -> PVTv2:
    """PVTv2 of ``variant``; ``kw`` (``attn_impl``, ``blockfuse``,
    ``drop_path_rate``) go to ``PVTv2``."""
    return PVTv2(**PVT_CONFIGS[variant], **kw)

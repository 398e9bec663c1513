"""Plain PyTorch reference of PraNet-V2 on Res2Net-50-v1b or PVTv2, frozen
for the benchmark.

It follows the published models (``binary_seg/lib/pranet.py``,
``lib/Res2Net_v1b.py``, ``lib/pvtv2.py`` of ai4colonoscopy/PraNet-V2) and
takes the same ``state_dict`` keys as the measured program, so both sides
load one set of weights.  It imports nothing of the program: every layer
is ``torch.nn.functional`` over the state dict's tensors, NCHW, in float32
(its callers turn TF32 off: ``reference/serve.py::no_tf32``).  BatchNorm
runs on the running statistics in eval and on the batch in training, as
``F.batch_norm`` does.

Departures from the published code, none of which changes the arithmetic:
the grayscale stem (``conv.0``, ``conv.1``) runs only on 1-channel input,
as in the program; DropPath is not modelled (the benchmark runs none);
LayerNorm is ``F.layer_norm`` and GELU the exact erf, where the program's
bf16 kernels take E[x^2] - mu^2 and a clipped polynomial erf (part of
what the check judges).

``quant``: a function applied to both operands of every convolution,
Linear and attention product (``BELOW``, ``set_quant``), which turns
the reference into the benchmark's lower-precision control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# level -> (trunk width, trunk k x k convs, their kernel, head kernel, head
# index in the published names)
DSRA = {4: (256, 3, 5, 1, 5), 3: (64, 2, 3, 3, 4), 2: (64, 2, 3, 3, 4)}
PVT_SR = (8, 4, 2, 1)

FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def identity(t):
    return t


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude at the format's largest value), returned in ``t``'s type."""
    amax = t.detach().abs().amax().float().clamp_min(1e-12)
    scale = FP8_MAX / amax
    q = (t.float() * scale).to(torch.float8_e4m3fn).float() / scale
    return q.to(t.dtype)


# a configuration's served type -> the rounding of the precision below it
# (the checks' control); a type with no entry has no control yet
BELOW = {"bfloat16": fp8_round}


class Layer(nn.Module):
    """A module whose products go through ``self.quant``."""

    quant = staticmethod(identity)


class Conv(Layer):
    def __init__(self, cin, cout, k, stride=1, padding=0, dilation=1,
                 groups=1, bias=False):
        super().__init__()
        kh, kw = (k, k) if isinstance(k, int) else k
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kh, kw))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.args = (stride, padding, dilation, groups)

    def forward(self, x):
        return F.conv2d(self.quant(x), self.quant(self.weight), self.bias,
                        *self.args)


class Linear(Layer):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return F.linear(self.quant(x), self.quant(self.weight), self.bias)


class BN(nn.BatchNorm2d):
    def __init__(self, c):
        super().__init__(c, eps=1e-5, momentum=0.1)


class LN(nn.LayerNorm):
    pass


class ConvBN(nn.Module):
    """The published ``BasicConv2d``: conv without bias, then BN."""

    def __init__(self, cin, cout, k, padding=0, dilation=1):
        super().__init__()
        self.conv = Conv(cin, cout, k, padding=padding, dilation=dilation)
        self.bn = BN(cout)

    def forward(self, x):
        return self.bn(self.conv(x))


def up(x, size, align_corners=False):
    """Bilinear resize in float32 at least, back in x's type."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    ct = torch.promote_types(x.dtype, torch.float32)
    return F.interpolate(x.to(ct), size=tuple(size), mode="bilinear",
                         align_corners=align_corners).to(x.dtype)


class RFB(nn.Module):
    def __init__(self, cin, c):
        super().__init__()
        self.branch0 = nn.Sequential(ConvBN(cin, c, 1))
        for i, k in enumerate((3, 5, 7), start=1):
            p = k // 2
            setattr(self, f"branch{i}", nn.Sequential(
                ConvBN(cin, c, 1), ConvBN(c, c, (1, k), padding=(0, p)),
                ConvBN(c, c, (k, 1), padding=(p, 0)),
                ConvBN(c, c, 3, padding=k, dilation=k)))
        self.conv_cat = ConvBN(4 * c, c, 3, padding=1)
        self.conv_res = ConvBN(cin, c, 1)

    def forward(self, x):
        xs = [getattr(self, f"branch{i}")(x) for i in range(4)]
        return F.relu(self.conv_cat(torch.cat(xs, 1)) + self.conv_res(x))


class Aggregation(nn.Module):
    """The dual-head partial decoder (``aggregation``)."""

    def __init__(self, c, num_class):
        super().__init__()
        for i in range(1, 5):
            setattr(self, f"conv_upsample{i}", ConvBN(c, c, 3, padding=1))
        self.conv_upsample5 = ConvBN(2 * c, 2 * c, 3, padding=1)
        self.conv_concat2 = ConvBN(2 * c, 2 * c, 3, padding=1)
        self.conv_concat3 = ConvBN(3 * c, 3 * c, 3, padding=1)
        self.conv4 = ConvBN(3 * c, 3 * c, 3, padding=1)
        self.conv5_fg = Conv(3 * c, num_class, 1, bias=True)
        self.conv5_bg = Conv(3 * c, num_class, 1, bias=True)

    def forward(self, x1, x2, x3):
        def up2(t):
            return up(t, (2 * t.shape[-2], 2 * t.shape[-1]), True)

        x2_1 = self.conv_upsample1(up2(x1)) * x2
        x3_1 = (self.conv_upsample2(up2(up2(x1)))
                * self.conv_upsample3(up2(x2)) * x3)
        x2_2 = self.conv_concat2(
            torch.cat([x2_1, self.conv_upsample4(up2(x1))], 1))
        x3_2 = self.conv_concat3(
            torch.cat([x3_1, self.conv_upsample5(up2(x2_2))], 1))
        x = self.conv4(x3_2)
        return self.conv5_fg(x), self.conv5_bg(x)


class Bottle2neck(nn.Module):
    def __init__(self, inplanes, planes, stride, downsample, stype,
                 base_width, scale):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64.0)))
        self.width, self.stride, self.stype = width, stride, stype
        self.conv1 = Conv(inplanes, width * scale, 1)
        self.bn1 = BN(width * scale)
        self.convs = nn.ModuleList(Conv(width, width, 3, stride, 1)
                                   for _ in range(scale - 1))
        self.bns = nn.ModuleList(BN(width) for _ in range(scale - 1))
        self.conv3 = Conv(width * scale, planes * 4, 1)
        self.bn3 = BN(planes * 4)
        if downsample:
            # downsample.0 is the parameterless average pool
            self.downsample = nn.Sequential(
                nn.Identity(), Conv(inplanes, planes * 4, 1), BN(planes * 4))
        else:
            self.downsample = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        spx = torch.split(out, self.width, 1)
        parts, sp = [], None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = spx[i] if (i == 0 or self.stype == "stage") else sp + spx[i]
            sp = F.relu(bn(conv(sp)))
            parts.append(sp)
        if self.stype == "normal":
            parts.append(spx[-1])
        else:
            parts.append(F.avg_pool2d(spx[-1], 3, self.stride, 1))
        out = self.bn3(self.conv3(torch.cat(parts, 1)))
        short = x
        if self.downsample is not None:
            if self.stride > 1:
                short = F.avg_pool2d(x, self.stride, self.stride,
                                     ceil_mode=True, count_include_pad=False)
            short = self.downsample[2](self.downsample[1](short))
        return F.relu(out + short)


class Res2Net(nn.Module):
    """Res2Net-v1b (deep stem); returns the four stages' maps."""

    def __init__(self, layers=(3, 4, 6, 3), base_width=26, scale=4):
        super().__init__()
        self.conv1 = nn.Sequential(
            Conv(3, 32, 3, 2, 1), BN(32), nn.ReLU(),
            Conv(32, 32, 3, 1, 1), BN(32), nn.ReLU(), Conv(32, 64, 3, 1, 1))
        self.bn1 = BN(64)
        inplanes = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                  layers), start=1):
            stride = 1 if li == 1 else 2
            seq = [Bottle2neck(inplanes, planes, stride,
                               stride != 1 or inplanes != planes * 4,
                               "stage", base_width, scale)]
            inplanes = planes * 4
            seq += [Bottle2neck(inplanes, planes, 1, False, "normal",
                                base_width, scale) for _ in range(blocks - 1)]
            setattr(self, f"layer{li}", nn.Sequential(*seq))

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        feats = []
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
            feats.append(x)
        return feats


class PatchEmbed(nn.Module):
    def __init__(self, cin, dim, patch, stride):
        super().__init__()
        self.proj = Conv(cin, dim, patch, stride, patch // 2, bias=True)
        self.norm = LN(dim, eps=1e-5)

    def forward(self, x):
        x = self.proj(x)
        return self.norm(x.flatten(2).transpose(1, 2)), x.shape[-2:]


class Attention(Layer):
    def __init__(self, dim, heads, sr):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr
        self.q = Linear(dim, dim)
        self.kv = Linear(dim, 2 * dim)
        self.proj = Linear(dim, dim)
        if sr > 1:
            self.sr = Conv(dim, dim, sr, sr, bias=True)
            self.norm = LN(dim, eps=1e-5)

    def forward(self, x, hw):
        n, t, d = x.shape
        nh, hd = self.heads, d // self.heads
        q = self.q(x).reshape(n, t, nh, hd).transpose(1, 2)
        y = x
        if self.sr_ratio > 1:
            y = self.sr(x.transpose(1, 2).reshape(n, d, *hw))
            y = self.norm(y.flatten(2).transpose(1, 2))
        k, v = self.kv(y).reshape(n, -1, 2, nh, hd).permute(2, 0, 3, 1, 4)
        s = self.quant(q) @ self.quant(k).transpose(-1, -2) * hd ** -0.5
        p = torch.softmax(s.float(), dim=-1).to(s.dtype)
        o = (self.quant(p) @ self.quant(v)).transpose(1, 2).reshape(n, t, d)
        return self.proj(o)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.dwconv = nn.Module()
        self.dwconv.dwconv = Conv(hidden, hidden, 3, 1, 1, groups=hidden,
                                  bias=True)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x, hw):
        n, t, _ = x.shape
        h = self.fc1(x)
        c = h.shape[-1]
        h = self.dwconv.dwconv(h.transpose(1, 2).reshape(n, c, *hw))
        return self.fc2(F.gelu(h.flatten(2).transpose(1, 2)))


class Block(nn.Module):
    def __init__(self, dim, heads, ratio, sr):
        super().__init__()
        self.norm1 = LN(dim, eps=1e-6)
        self.attn = Attention(dim, heads, sr)
        self.norm2 = LN(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * ratio)

    def forward(self, x, hw):
        x = x + self.attn(self.norm1(x), hw)
        return x + self.mlp(self.norm2(x), hw)


class PVTv2(nn.Module):
    def __init__(self, embed_dims=(64, 128, 320, 512), depths=(3, 4, 6, 3),
                 num_heads=(1, 2, 5, 8), mlp_ratios=(8, 8, 4, 4)):
        super().__init__()
        cin = 3
        for s, dim in enumerate(embed_dims, start=1):
            patch, stride = (7, 4) if s == 1 else (3, 2)
            setattr(self, f"patch_embed{s}", PatchEmbed(cin, dim, patch,
                                                        stride))
            setattr(self, f"block{s}", nn.ModuleList(
                Block(dim, num_heads[s - 1], mlp_ratios[s - 1],
                      PVT_SR[s - 1]) for _ in range(depths[s - 1])))
            setattr(self, f"norm{s}", LN(dim, eps=1e-6))
            cin = dim

    def forward(self, x):
        outs = []
        for s in range(1, 5):
            x, hw = getattr(self, f"patch_embed{s}")(x)
            for blk in getattr(self, f"block{s}"):
                x = blk(x, hw)
            x = getattr(self, f"norm{s}")(x)
            x = x.transpose(1, 2).reshape(x.shape[0], -1, *hw)
            outs.append(x)
        return outs


class PraNetV2(nn.Module):
    """PraNet-V2: encoder stages 2-4, three RFBs, the dual-head partial
    decoder, three DSRA levels.  Returns the eight maps at input size,
    (map2_fg, map3_fg, map4_fg, map5_fg, map2_bg, ..., map5_bg)."""

    def __init__(self, encoder: nn.Module, widths, channel=32, num_class=1):
        super().__init__()
        self.conv = nn.Sequential(Conv(1, 3, 1, bias=True), BN(3), nn.ReLU())
        self.backbone = encoder
        widths = dict(zip((2, 3, 4), widths))
        for lvl, cin in widths.items():
            setattr(self, f"rfb{lvl}_1", RFB(cin, channel))
        self.agg1 = Aggregation(channel, num_class)
        for lvl, (mid, n, k, hk, hi) in DSRA.items():
            setattr(self, f"ra{lvl}_conv1", ConvBN(widths[lvl], mid, 1))
            for i in range(2, 2 + n):
                setattr(self, f"ra{lvl}_conv{i}",
                        ConvBN(mid, mid, k, padding=k // 2))
            for side in ("fg", "bg"):
                setattr(self, f"ra{lvl}_conv{hi}_{side}",
                        ConvBN(mid, num_class, hk, padding=hk // 2))

    def branch(self, lvl, x):
        _, n, _, _, hi = DSRA[lvl]
        x = getattr(self, f"ra{lvl}_conv1")(x)
        for i in range(2, 2 + n):
            x = F.relu(getattr(self, f"ra{lvl}_conv{i}")(x))
        return (getattr(self, f"ra{lvl}_conv{hi}_fg")(x),
                getattr(self, f"ra{lvl}_conv{hi}_bg")(x))

    def forward(self, x):
        if x.shape[1] == 1:
            x = self.conv(x)
        size = x.shape[-2:]
        _, x2, x3, x4 = self.backbone(x)
        prev_fg, prev_bg = self.agg1(self.rfb4_1(x4), self.rfb3_1(x3),
                                     self.rfb2_1(x2))
        fg, bg = [], []
        for lvl, stage in ((4, x4), (3, x3), (2, x2)):
            ra_fg, ra_bg = self.branch(lvl, stage)
            s = ra_fg.shape[-2:]
            diff = up(prev_fg, s) - up(prev_bg, s)
            gate = torch.softmax(diff.float(), dim=1).to(ra_fg.dtype)
            gated = ra_fg + ra_fg * gate
            if lvl == 4:
                fg.append(up(prev_fg, size))
                bg.append(up(prev_bg, size))
            fg.insert(0, up(gated, size))
            bg.insert(0, up(ra_bg, size))
            prev_fg, prev_bg = gated, ra_bg
        return (*fg, *bg)


def served_logits(maps) -> torch.Tensor:
    """What a binary PraNet-V2 serves: the sum of its four fg maps."""
    return maps[0] + maps[1] + maps[2] + maps[3]


def build(config: dict) -> PraNetV2:
    """The reference model of a configuration file's ``model`` block
    (parameters uninitialised; load a state dict)."""
    m = config["model"]
    if m["encoder"] == "res2net_v1b":
        enc = Res2Net(tuple(m["layers"]), m["base_width"], m["scale"])
        widths = tuple(m["planes"][i] * 4 for i in (1, 2, 3))
    elif m["encoder"] == "pvt_v2":
        enc = PVTv2(tuple(m["embed_dims"]), tuple(m["depths"]),
                    tuple(m["num_heads"]), tuple(m["mlp_ratios"]))
        widths = tuple(m["embed_dims"][1:])
    else:
        raise ValueError(f"unknown encoder {m['encoder']!r}")
    return PraNetV2(enc, widths, m["channel"], m["num_class"])


def set_quant(model: nn.Module, fn) -> nn.Module:
    """Route every product of ``model`` through ``fn`` (``identity`` to
    undo)."""
    for mod in model.modules():
        if isinstance(mod, Layer):
            mod.quant = fn
    return model

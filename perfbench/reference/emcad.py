"""Plain PyTorch reference of EMCAD with PraNet-V2's DSRA dual heads, on
PVTv2, frozen for the benchmark.

It follows the published model (ai4colonoscopy/PraNet-V2,
``multiclass_seg/EMCAD/lib/networks.py:10-142`` and
``lib/decoders.py:407-526``; EMCAD: Rahman, Munir and Marculescu, CVPR
2024) and takes the same ``state_dict`` keys as the measured program, so
both sides load one set of weights.  It imports nothing of the program:
the encoder and the layers are ``reference/pranet.py``'s (``PVTv2``,
``Conv``, ``BN``, ``ConvBN``, ``up``), so its ``quant`` reaches every
product; the decoder is written here from the published code, every layer
``torch.nn.functional`` over the state dict's tensors, NCHW, float32 (its
callers turn TF32 off: ``reference/serve.py::no_tf32``).  BatchNorm runs
on the running statistics in eval.

* MSCB: 1x1 expand + BN + act, one depthwise k x k + BN + act per kernel
  size on the expanded map, their sum, the channel shuffle by
  gcd(expanded, out), 1x1 project + BN, and the skip.
* EUCB: nearest x2, depthwise 3x3 + BN + ReLU, 1x1 (biased); its shuffle
  by the channel count is the identity and is left out.
* LGAG: ``x * sigmoid(BN(psi(relu(BN(W_g g) + BN(W_x x)))))``, ``W_g``
  and ``W_x`` grouped 3x3 convs of ``channels // 2`` groups.
* CAB: a bias-free 1x1 MLP (``channels // min(16, channels)`` wide) over
  the global mean and max, summed, sigmoid.  SAB: one 7x7 conv on the
  channels' [mean, max], sigmoid, shared by the four levels.
* Heads: fg and bg conv + BN at each level (1x1 at level 4, 3x3 below);
  from level 3 on, the fg map is gated as ``decoders.py:477,500,523`` do,
  ``fg + fg * softmax_c(up(prev_fg) - up(prev_bg))``, the previous level's
  maps resized bilinearly to this level's size.
* The eight maps are resized bilinearly to the input size
  (``networks.py``'s scale factors 32/16/8/4 at these sizes).

Departures, none of which changes the arithmetic: the grayscale stem
(``conv``: 1x1 conv + BN + ReLU) runs only on 1-channel input, as the
published network does it; the maps are returned as the program returns
them, the fg maps of levels 4..1 then the bg maps; only ``dw_parallel``,
``add`` and the published activations (ReLU6 in MSCB, ReLU elsewhere) are
modelled; DropPath is not modelled (the benchmark runs no training here).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference import pranet
from perfbench.reference.pranet import BN, Conv, ConvBN, up


def conv_bn_act(cin, cout, k=1, groups=1, bias=False, relu6=None):
    """The published ``Sequential(Conv2d, BatchNorm2d[, act])`` (k // 2
    padding): keys ``0`` and ``1``."""
    layers = [Conv(cin, cout, k, 1, k // 2, groups=groups, bias=bias),
              BN(cout)]
    if relu6 is not None:
        layers.append(nn.ReLU6() if relu6 else nn.ReLU())
    return nn.Sequential(*layers)


def shuffle(x, groups):
    """The published ``channel_shuffle``: view (N, groups, C // groups,
    H, W), swap the two channel axes, view back."""
    n, c, h, w = x.shape
    return (x.view(n, groups, c // groups, h, w).transpose(1, 2)
            .reshape(n, c, h, w))


class MSDC(nn.Module):
    def __init__(self, c, kernel_sizes):
        super().__init__()
        self.dwconvs = nn.ModuleList(
            conv_bn_act(c, c, k, groups=c, relu6=True) for k in kernel_sizes)

    def forward(self, x):
        return [dw(x) for dw in self.dwconvs]  # dw_parallel


class MSCB(nn.Module):
    def __init__(self, c, kernel_sizes, expansion):
        super().__init__()
        ex = c * expansion
        self.pconv1 = conv_bn_act(c, ex, relu6=True)
        self.msdc = MSDC(ex, kernel_sizes)
        self.groups = math.gcd(ex, c)  # add: the expanded width
        self.pconv2 = conv_bn_act(ex, c)

    def forward(self, x):
        d = sum(self.msdc(self.pconv1(x)))
        return x + self.pconv2(shuffle(d, self.groups))


class EUCB(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.up_dwc = nn.Sequential(
            nn.Upsample(scale_factor=2), Conv(cin, cin, 3, 1, 1, groups=cin),
            BN(cin), nn.ReLU())
        self.pwc = nn.Sequential(Conv(cin, cout, 1, bias=True))

    def forward(self, x):
        return self.pwc(self.up_dwc(x))


class LGAG(nn.Module):
    def __init__(self, c, k):
        super().__init__()
        groups = 1 if k == 1 else c // 2
        self.W_g = conv_bn_act(c, c // 2, k, groups, bias=True)
        self.W_x = conv_bn_act(c, c // 2, k, groups, bias=True)
        self.psi = conv_bn_act(c // 2, 1, 1, bias=True)

    def forward(self, g, x):
        return x * torch.sigmoid(self.psi(F.relu(self.W_g(g) + self.W_x(x))))


class CAB(nn.Module):
    def __init__(self, c, ratio=16):
        super().__init__()
        red = c // min(ratio, c)
        self.fc1 = Conv(c, red, 1)
        self.fc2 = Conv(red, c, 1)

    def forward(self, x):
        def mlp(t):
            return self.fc2(F.relu(self.fc1(t)))

        avg = F.adaptive_avg_pool2d(x, 1)
        mx = F.adaptive_max_pool2d(x, 1)
        return torch.sigmoid(mlp(avg) + mlp(mx))


class SAB(nn.Module):
    def __init__(self, k=7):
        super().__init__()
        self.conv = Conv(2, 1, k, 1, k // 2)

    def forward(self, x):
        s = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
        return torch.sigmoid(self.conv(s))


class Decoder(nn.Module):
    """EMCAD's four levels with the dual DSRA heads (``decoders.py``)."""

    def __init__(self, channels, num_class, kernel_sizes, expansion, lgag_ks):
        super().__init__()
        ch = tuple(channels)
        for lvl in (4, 3, 2, 1):
            c = ch[4 - lvl]
            setattr(self, f"mscb{lvl}",
                    nn.Sequential(MSCB(c, kernel_sizes, expansion)))
            setattr(self, f"cab{lvl}", CAB(c))
            if lvl < 4:
                setattr(self, f"eucb{lvl}", EUCB(ch[3 - lvl], c))
                setattr(self, f"lgag{lvl}", LGAG(c, lgag_ks))
            k = 1 if lvl == 4 else 3
            for side in ("fg", "bg"):
                setattr(self, f"ConvBlock{lvl}_{side}",
                        ConvBN(c, num_class, k, padding=k // 2))
        self.sab = SAB()

    def attend(self, lvl, d):
        d = getattr(self, f"cab{lvl}")(d) * d
        d = self.sab(d) * d
        return getattr(self, f"mscb{lvl}")(d)

    def heads(self, lvl, d):
        return (getattr(self, f"ConvBlock{lvl}_fg")(d),
                getattr(self, f"ConvBlock{lvl}_bg")(d))

    def forward(self, x, skips):
        d = self.attend(4, x)
        fg, bg = self.heads(4, d)
        fgs, bgs = [fg], [bg]
        for lvl, skip in zip((3, 2, 1), skips):
            d = getattr(self, f"eucb{lvl}")(d)
            d = d + getattr(self, f"lgag{lvl}")(d, skip)
            d = self.attend(lvl, d)
            ra_fg, ra_bg = self.heads(lvl, d)
            s = ra_fg.shape[-2:]
            gate = torch.softmax((up(fg, s) - up(bg, s)).float(), dim=1)
            fg = ra_fg + ra_fg * gate.to(ra_fg.dtype)
            bg = ra_bg
            fgs.append(fg)
            bgs.append(bg)
        return fgs + bgs


class EMCAD(nn.Module):
    """The grayscale stem, PVTv2 and the dual decoder; returns the eight
    maps at input size, (fg4, fg3, fg2, fg1, bg4, bg3, bg2, bg1)."""

    def __init__(self, encoder: nn.Module, channels, num_class,
                 kernel_sizes=(1, 3, 5), expansion=2, lgag_ks=3):
        super().__init__()
        self.conv = nn.Sequential(Conv(1, 3, 1, bias=True), BN(3), nn.ReLU())
        self.backbone = encoder
        self.decoder = Decoder(channels, num_class, kernel_sizes, expansion,
                               lgag_ks)

    def forward(self, x):
        if x.shape[1] == 1:
            x = self.conv(x)
        size = x.shape[-2:]
        x1, x2, x3, x4 = self.backbone(x)
        return tuple(up(m, size) for m in self.decoder(x4, [x3, x2, x1]))


def served_logits(maps) -> torch.Tensor:
    """What EMCAD's ``test_single_volume`` scores: the sum of its four fg
    maps."""
    return maps[0] + maps[1] + maps[2] + maps[3]


def build(config: dict) -> EMCAD:
    """The reference model of a configuration file's ``model`` block
    (parameters uninitialised; load a state dict)."""
    m = config["model"]
    if m["encoder"] != "pvt_v2" or not (m["dw_parallel"] and m["add"]
                                         and m["activation"] == "relu6"):
        raise ValueError("the reference models EMCAD on PVTv2 with "
                         "dw_parallel, add and relu6 only")
    enc = pranet.PVTv2(tuple(m["embed_dims"]), tuple(m["depths"]),
                       tuple(m["num_heads"]), tuple(m["mlp_ratios"]))
    return EMCAD(enc, tuple(reversed(m["embed_dims"])), m["num_class"],
                 tuple(m["kernel_sizes"]), m["expansion_factor"],
                 m["lgag_ks"])

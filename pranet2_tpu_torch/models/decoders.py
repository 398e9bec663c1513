"""The CASCADE decoders of MERIT and the MaxViT zoo: an attention-gated,
UNet-style cascade.

Port of ``pranet2_tpu/models/decoders.py`` with the reference checkpoint's
names (``multiclass_seg/MERIT/lib/decoders.py``; the inverse of
``_cascade_member_map``, ``pranet2_tpu/utils/torch_convert.py:371``):
``Conv_1x1``, ``ConvBlock{l}.conv.{0,1,3,4}``, ``Up{l}.up.{1,2}``,
``AG{l}.{W_g,W_x,psi}.{0,1}``, ``CA{l}.{fc1,fc2}``, ``SA.conv1`` and the
dual heads ``ConvBlock{l}_{fg,bg}.{conv,bn}``.

* ``ConvBlock``: 2 x (3x3 conv with bias + BN + ReLU).
* ``UpConv``: nearest x2 + 3x3 conv + BN + ReLU.
* ``AttentionGate``: ``x * sigmoid(BN(psi(relu(BN(W_g g) + BN(W_x x)))))``.
* ``ChannelAttention`` (ratio 16, one bias-free MLP over the global average
  and max pools) and ``SpatialAttention`` (a 7x7 conv over the channels'
  [mean, max]); each returns its gate.  One ``SA`` is shared by every
  level.
* ``CascadeAdd``: per level up-conv, the gated skip added, CA, SA, conv
  block; returns the 4 level features (d4 .. d1).  ``CascadeCat``
  concatenates the gated skip instead.  ``CascadeAddDual`` adds fg and bg
  ``ConvBN`` heads at each level (1x1 at level 4, 3x3 below) and gates each
  level's fg map by ``ops.dsra_gate`` with the previous level's maps
  resized bilinearly: the autograd Function, whose forward is the gate
  kernel on every CUDA tensor, in eval and in training.  It returns the 4
  fg maps, the 4 bg maps and the finest feature.

``channels`` are deepest first, e.g. (768, 384, 192, 96).
"""

from __future__ import annotations

import torch
from torch import nn

from pranet2_tpu_torch.models.emcad import UpsampleNearest
from pranet2_tpu_torch.nn import ConvBN
from pranet2_tpu_torch.ops import dsra_gate, resize_bilinear


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class ConvBlock(nn.Module):
    """2 x (3x3 conv + BN + ReLU)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(cin, cout, 3, 1, 1), _bn(cout), nn.ReLU(),
            nn.Conv2d(cout, cout, 3, 1, 1), _bn(cout), nn.ReLU())

    def forward(self, x):
        return self.conv(x)


class UpConv(nn.Module):
    """nearest x2 + 3x3 conv + BN + ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up = nn.Sequential(UpsampleNearest(2),
                                nn.Conv2d(cin, cout, 3, 1, 1), _bn(cout),
                                nn.ReLU())

    def forward(self, x):
        return self.up(x)


class AttentionGate(nn.Module):
    """The additive attention gate (``Attention_block``)."""

    def __init__(self, f_g: int, f_l: int, f_int: int):
        super().__init__()
        self.W_g = nn.Sequential(nn.Conv2d(f_g, f_int, 1), _bn(f_int))
        self.W_x = nn.Sequential(nn.Conv2d(f_l, f_int, 1), _bn(f_int))
        self.psi = nn.Sequential(nn.Conv2d(f_int, 1, 1), _bn(1),
                                 nn.Sigmoid())

    def forward(self, g, x):
        return x * self.psi(torch.relu(self.W_g(g) + self.W_x(x)))


class ChannelAttention(nn.Module):
    """The (N, C, 1, 1) gate of a shared bias-free MLP (ratio 16) over the
    global average and max pools."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // 16, 1, bias=False)
        self.fc2 = nn.Conv2d(channels // 16, channels, 1, bias=False)

    def forward(self, x):
        mlp = lambda t: self.fc2(torch.relu(self.fc1(t)))
        return torch.sigmoid(mlp(x.mean(dim=(2, 3), keepdim=True))
                             + mlp(x.amax(dim=(2, 3), keepdim=True)))


class SpatialAttention(nn.Module):
    """The (N, 1, H, W) gate of a 7x7 conv (no bias) over the channels'
    [mean, max]."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(2, 1, 7, 1, 3, bias=False)

    def forward(self, x):
        s = torch.cat([x.mean(dim=1, keepdim=True),
                       x.amax(dim=1, keepdim=True)], 1)
        return torch.sigmoid(self.conv1(s))


class _Cascade(nn.Module):
    """The levels shared by the three decoders; ``cat`` concatenates the
    gated skip (``CascadeCat``), else adds it."""

    def __init__(self, channels, cat: bool = False):
        super().__init__()
        ch = tuple(channels)
        self.cat = cat
        self.Conv_1x1 = nn.Conv2d(ch[0], ch[0], 1)
        self.CA4 = ChannelAttention(ch[0])
        self.ConvBlock4 = ConvBlock(ch[0], ch[0])
        f_ints = (ch[2], ch[3], ch[3] // 2)
        for lvl, f_int in zip((3, 2, 1), f_ints):
            c = ch[4 - lvl]
            setattr(self, f"Up{lvl}", UpConv(ch[3 - lvl], c))
            setattr(self, f"AG{lvl}", AttentionGate(c, c, f_int))
            cc = 2 * c if cat else c
            setattr(self, f"CA{lvl}", ChannelAttention(cc))
            setattr(self, f"ConvBlock{lvl}", ConvBlock(cc, c))
        self.SA = SpatialAttention()

    def _attend(self, lvl: int, d):
        d = getattr(self, f"CA{lvl}")(d) * d
        d = self.SA(d) * d
        return getattr(self, f"ConvBlock{lvl}")(d)

    def top(self, x):
        """Level 4 on the deepest feature."""
        return self._attend(4, self.Conv_1x1(x))

    def level(self, lvl: int, d, skip):
        """Level ``lvl`` (3, 2, 1) on the coarser level's feature ``d``."""
        d = getattr(self, f"Up{lvl}")(d)
        g = getattr(self, f"AG{lvl}")(d, skip)
        d = torch.cat([g, d], 1) if self.cat else d + g
        return self._attend(lvl, d)

    def forward(self, x, skips):
        """``x`` the deepest feature, ``skips`` the next three, deepest
        first; returns [d4, d3, d2, d1]."""
        d = self.top(x)
        outs = [d]
        for lvl, skip in zip((3, 2, 1), skips):
            d = self.level(lvl, d, skip)
            outs.append(d)
        return outs


class CascadeAdd(_Cascade):
    """Additive CASCADE (``CASCADE_Add``)."""

    def __init__(self, channels):
        super().__init__(channels, cat=False)


class CascadeCat(_Cascade):
    """Concatenating CASCADE (``CASCADE_Cat``)."""

    def __init__(self, channels):
        super().__init__(channels, cat=True)


class CascadeAddDual(_Cascade):
    """The DSRA-grafted additive CASCADE (``CASCADE_Add_dual``): returns
    (d4_fg, d3_fg, d2_fg, d1_fg, d4_bg, d3_bg, d2_bg, d1_bg, d1)."""

    def __init__(self, channels, num_class: int, use_softmax: bool = True):
        super().__init__(channels, cat=False)
        self.use_softmax = use_softmax
        for lvl in (4, 3, 2, 1):
            ks = 1 if lvl == 4 else 3
            for side in ("fg", "bg"):
                setattr(self, f"ConvBlock{lvl}_{side}",
                        ConvBN(channels[4 - lvl], num_class, ks,
                               padding=ks // 2))

    def _heads(self, lvl: int, d):
        return (getattr(self, f"ConvBlock{lvl}_fg")(d),
                getattr(self, f"ConvBlock{lvl}_bg")(d))

    def forward(self, x, skips):
        d = self.top(x)
        prev_fg, prev_bg = self._heads(4, d)
        fg_maps, bg_maps = [prev_fg], [prev_bg]
        for lvl, skip in zip((3, 2, 1), skips):
            d = self.level(lvl, d, skip)
            size = tuple(d.shape[-2:])
            d_fg, d_bg = self._heads(lvl, d)
            d_fg = dsra_gate(d_fg, resize_bilinear(prev_fg, size),
                             resize_bilinear(prev_bg, size), self.use_softmax)
            fg_maps.append(d_fg)
            bg_maps.append(d_bg)
            prev_fg, prev_bg = d_fg, d_bg
        return fg_maps + bg_maps + [d]

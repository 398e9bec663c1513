"""Plain reference of the published binary recipe's update
(``binary_seg/MyTrain_med.py:19-38,55-98``): at each scale the batch is
rescaled (bilinear, ``align_corners=True``), the model runs in training
mode, the loss is the sum over the four (fg, bg) map pairs of the
structure loss (boundary weight ``1 + 5 |avgpool31(mask) - mask|``,
weighted BCE plus weighted IoU on fg, 0.8 weighted BCE on bg against
``1 - mask``, averaged over the batch), every gradient is clamped to
+/-``clip`` and Adam (bias-corrected, eps outside the root) takes one
step.  Written out here from the published recipe; nothing of the
program is used.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import pranet


def rate_size(trainsize: int, rate: float) -> int:
    """The recipe's size at a rate: a multiple of 32."""
    return int(round(trainsize * rate / 32) * 32)


def _bce(pred, target):
    return F.binary_cross_entropy_with_logits(pred, target, reduction="none")


def structure_loss(pred, pred_bg, mask):
    weit = 1 + 5 * (F.avg_pool2d(mask, 31, 1, 15) - mask).abs()
    wsum = weit.sum(dim=(2, 3))
    wbce = (weit * _bce(pred, mask)).sum(dim=(2, 3)) / wsum
    p = torch.sigmoid(pred)
    inter = (p * mask * weit).sum(dim=(2, 3))
    union = ((p + mask) * weit).sum(dim=(2, 3))
    wiou = 1 - (inter + 1) / (union - inter + 1)
    wbce_bg = (weit * _bce(pred_bg, 1 - mask)).sum(dim=(2, 3)) / wsum
    return (wbce + wiou + 0.8 * wbce_bg).mean()


def loss(model, images, masks):
    maps = model(images)
    return sum(structure_loss(maps[i].float(), maps[4 + i].float(), masks)
               for i in range(4))


class Adam:
    """Adam over ``params`` with an element-wise gradient clamp first."""

    def __init__(self, params, lr: float, clip: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.clip, self.betas, self.eps = lr, clip, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self) -> list:
        """One update; returns each parameter's clamped gradient (None
        where it has none, and is then left as it is)."""
        self.t += 1
        b1, b2 = self.betas
        grads = []
        for p, m, v in zip(self.params, self.m, self.v):
            if p.grad is None:
                grads.append(None)
                continue
            g = p.grad.clamp(-self.clip, self.clip)
            grads.append(g)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v / (1 - b2 ** self.t)).sqrt() + self.eps
            p.sub_(self.lr / (1 - b1 ** self.t) * m / denom)
            p.grad = None
        return grads


def steps(config: dict, state_dict: dict, images, masks, rates, trainsize,
          lr: float, clip: float, device) -> dict:
    """The recipe's first ``len(rates)`` updates, one a rate, on one batch
    (NCHW ``images`` and ``masks``), from ``state_dict``.  Returns the
    loss of each update, each parameter's first clamped gradient norm and
    its change after the last update."""
    with torch.device(device):
        ref = pranet.build(config)
    ref.load_state_dict(state_dict)
    ref.train()
    names = [n for n, _ in ref.named_parameters()]
    params = [p for _, p in ref.named_parameters()]
    start = [p.detach().clone() for p in params]
    opt = Adam(params, lr, clip)
    losses, first = [], None
    for rate in rates:
        size = rate_size(trainsize, rate)
        x, y = images, masks
        if size != x.shape[-1]:
            x = F.interpolate(x, size=(size, size), mode="bilinear",
                              align_corners=True)
            y = F.interpolate(y, size=(size, size), mode="bilinear",
                              align_corners=True)
        value = loss(ref, x, y)
        value.backward()
        grads = opt.step()
        losses.append(float(value.detach()))
        if first is None:
            first = {n: (float(g.norm()) if g is not None else None)
                     for n, g in zip(names, grads)}
    change = {n: float((p.detach() - s).norm())
              for n, p, s in zip(names, params, start)}
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def compare(got: dict, want: dict) -> dict:
    """The numbers held between the program's first updates and the
    reference's: the worst relative gap of a step's loss (and the first
    step's alone), of a leaf's first gradient norm, and of a leaf's change
    after the last step (and the median leaf's relative gap).  A
    leaf's gap is taken against the reference's norm of that leaf or of
    the median leaf, whichever is larger; leaves whose reference gradient
    is under a thousandth of the median leaf's (zero to rounding) are
    left out of the change, and leaves with no gradient from both."""
    gaps = [abs(a - b) / max(abs(b), 1e-12)
            for a, b in zip(got["losses"], want["losses"])]
    ref_g = {n: g for n, g in want["grad_norms"].items() if g is not None}
    med_g = _median(ref_g.values())
    grad_gap = max(abs((got["grad_norms"].get(n) or 0.0) - g) / max(g, med_g)
                   for n, g in ref_g.items())
    moved = [n for n, g in ref_g.items() if g >= 1e-3 * med_g]
    med_c = _median(want["change_norms"][n] for n in moved)
    change_gap = max(abs(got["change_norms"][n] - want["change_norms"][n])
                     / max(want["change_norms"][n], med_c) for n in moved)
    med_gap = _median(abs(got["change_norms"][n] - want["change_norms"][n])
                      / want["change_norms"][n] for n in moved)
    return {"loss_gap": max(gaps), "first_loss_gap": gaps[0],
            "grad_norm_gap": grad_gap, "change_gap": change_gap,
            "median_change_gap": med_gap}


def _median(values) -> float:
    v = sorted(values)
    if not v:
        return math.nan
    mid = len(v) // 2
    return v[mid] if len(v) % 2 else 0.5 * (v[mid - 1] + v[mid])

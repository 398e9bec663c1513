"""Optimizer and LR schedule of the reference binary recipe.

Port of ``pranet2_tpu/train/optim.py``: Adam(1e-4) with an element-wise
gradient clamp to +/-0.5 and step LR decay ``lr * rate^(epoch //
decay_epoch)`` (``binary_seg/MyTrain_med.py:108-125``,
``binary_seg/utils/utils.py:7-23``); AdamW with weight decay for the
multiclass recipes.  The reference's ``clip_gradient`` is a value clamp,
not a norm clip.

JAX's ``optax.chain(optax.clip(c), optax.adam(schedule))`` evaluates the
schedule at the update count, 0 on the first update.  ``Optimizer.step``
does the same: it clamps every existing gradient, sets the rate of update
number ``count`` from the schedule, then steps ``torch.optim.Adam`` (or
``AdamW``), whose arithmetic is optax's (bias-corrected moments, eps added
to the corrected root, decoupled weight decay).  optax updates a
parameter with no gradient as with a zero one: under Adam that moves
nothing, and torch, which skips it, agrees; under AdamW the decay still
shrinks it, so there the step gives such a parameter a zero gradient.
"""

from __future__ import annotations

from collections.abc import Callable

import torch


def step_decay_schedule(base_lr: float, decay_rate: float, decay_epoch: int,
                        steps_per_epoch: int) -> Callable[[int], float]:
    """lr(step) = base * rate^(epoch // decay_epoch), epoch 1-based, for
    update number ``step`` counting from 0."""

    def fn(step: int) -> float:
        epoch = step // steps_per_epoch + 1
        return base_lr * decay_rate ** (epoch // decay_epoch)

    return fn


class Optimizer:
    """``torch.optim.Adam`` or ``AdamW`` behind a gradient clamp and an LR
    schedule; ``count`` is the number of updates taken."""

    def __init__(self, params, learning_rate: float | Callable[[int], float],
                 clip_value: float | None = 0.5, weight_decay: float = 0.0):
        self.params = list(params)
        self.schedule = (learning_rate if callable(learning_rate)
                         else lambda step: learning_rate)
        self.clip_value = clip_value
        self.weight_decay = weight_decay
        lr = self.schedule(0)
        self.inner = (torch.optim.AdamW(self.params, lr=lr,
                                        weight_decay=weight_decay)
                      if weight_decay else torch.optim.Adam(self.params,
                                                            lr=lr))
        self.count = 0

    def step(self) -> None:
        """Clamp the gradients, set this update's rate, take the update."""
        for p in self.params:
            if p.grad is None:
                if self.weight_decay:
                    p.grad = torch.zeros_like(p)
            elif self.clip_value:
                p.grad.clamp_(-self.clip_value, self.clip_value)
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return {"count": self.count, "inner": self.inner.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.inner.load_state_dict(state["inner"])


def make_optimizer(params, learning_rate, clip_value: float | None = 0.5,
                   weight_decay: float = 0.0) -> Optimizer:
    """Adam (AdamW when ``weight_decay``) over ``params`` at
    ``learning_rate`` (a float, or a schedule of the update count), each
    gradient clamped to +/-``clip_value`` first (none when 0 or None)."""
    return Optimizer(params, learning_rate, clip_value, weight_decay)

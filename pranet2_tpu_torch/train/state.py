"""Train state: the step, the model (parameters and BatchNorm buffers) and
the optimizer.

Port of ``pranet2_tpu/train/state.py``.  JAX keeps one immutable pytree and
replaces it each step; here the model and the optimizer are updated in
place and ``apply_gradients`` takes the gradients the backward left in
``.grad``.
"""

from __future__ import annotations

import dataclasses

from torch import nn

from pranet2_tpu_torch.train.optim import Optimizer


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients in ``.grad``, which it
        then clears."""
        self.optimizer.step()
        self.optimizer.zero_grad()
        self.step += 1

    @property
    def variables(self) -> dict:
        """The model's ``state_dict``: parameters and BatchNorm buffers."""
        return self.model.state_dict()

    def state_dict(self) -> dict:
        """Everything a resume needs."""
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])


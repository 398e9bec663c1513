"""Training of the port: the binary (PraNet, ``train.binary``) and
multiclass (``train.multiclass``) recipes, their optimizer and state."""

from pranet2_tpu_torch.train.optim import (Optimizer, make_optimizer,
                                           step_decay_schedule)
from pranet2_tpu_torch.train.state import TrainState

__all__ = ["Optimizer", "TrainState", "make_optimizer",
           "step_decay_schedule"]

"""Training of the port: the binary (PraNet) recipe, its optimizer and
state."""

from pranet2_tpu_torch.train.optim import (Optimizer, make_optimizer,
                                           step_decay_schedule)
from pranet2_tpu_torch.train.state import TrainState

__all__ = ["Optimizer", "TrainState", "make_optimizer",
           "step_decay_schedule"]

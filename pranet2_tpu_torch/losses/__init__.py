"""Losses of the port (NCHW).  The binary (PraNet) losses; the multiclass
ones are still to port."""

from pranet2_tpu_torch.losses.binary import (structure_loss,
                                             structure_loss_multi,
                                             structure_loss_v1)

__all__ = ["structure_loss", "structure_loss_multi", "structure_loss_v1"]

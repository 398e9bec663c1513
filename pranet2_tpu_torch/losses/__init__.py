"""Losses of the port (NCHW): the binary (PraNet) losses and the
multiclass MUTATION losses."""

from pranet2_tpu_torch.losses.binary import (structure_loss,
                                             structure_loss_multi,
                                             structure_loss_v1)
from pranet2_tpu_torch.losses.multiclass import (bce_with_logits, dice_loss,
                                                 mutation_loss, one_hot_bg,
                                                 powerset, softmax_ce_loss,
                                                 supervision_subsets)

__all__ = ["bce_with_logits", "dice_loss", "mutation_loss", "one_hot_bg",
           "powerset", "softmax_ce_loss", "structure_loss",
           "structure_loss_multi", "structure_loss_v1",
           "supervision_subsets"]

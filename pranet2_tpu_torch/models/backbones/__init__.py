from pranet2_tpu_torch.models.backbones.res2net import Res2Net

__all__ = ["Res2Net"]

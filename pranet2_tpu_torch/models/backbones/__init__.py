from pranet2_tpu_torch.models.backbones.res2net import (Res2Net,
                                                        res2net50_v1b,
                                                        res2net101_v1b)

__all__ = ["Res2Net", "res2net50_v1b", "res2net101_v1b"]

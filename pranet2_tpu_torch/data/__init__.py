from pranet2_tpu_torch.data.polyp import (IMAGENET_MEAN, IMAGENET_STD,
                                          preprocess_image)

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "preprocess_image"]

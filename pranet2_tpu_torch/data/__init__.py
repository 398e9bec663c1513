from pranet2_tpu_torch.data.loader import (AugmentedView, BatchLoader,
                                           CachedDataset, DevicePrefetcher)
from pranet2_tpu_torch.data.polyp import (IMAGENET_MEAN, IMAGENET_STD,
                                          OdgtDataset, PolypDataset,
                                          PolypTestDataset, preprocess_image,
                                          preprocess_mask)

__all__ = ["AugmentedView", "BatchLoader", "CachedDataset",
           "DevicePrefetcher", "IMAGENET_MEAN", "IMAGENET_STD", "OdgtDataset",
           "PolypDataset", "PolypTestDataset", "preprocess_image",
           "preprocess_mask"]

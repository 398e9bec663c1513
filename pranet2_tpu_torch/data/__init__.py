from pranet2_tpu_torch.data.loader import (AugmentedView, BatchLoader,
                                           CachedDataset, DevicePrefetcher)
from pranet2_tpu_torch.data.polyp import (IMAGENET_MEAN, IMAGENET_STD,
                                          OdgtDataset, PolypDataset,
                                          PolypTestDataset, preprocess_image,
                                          preprocess_mask)
from pranet2_tpu_torch.data.preprocess import (export_synapse_case,
                                               preprocess_ct_volume,
                                               random_split, tif_to_png)
from pranet2_tpu_torch.data.volumes import (ACDCDataset, RandomGenerator,
                                            RandomGeneratorACDC,
                                            SynapseDataset,
                                            remap_synapse_labels)

__all__ = ["ACDCDataset", "AugmentedView", "BatchLoader", "CachedDataset",
           "DevicePrefetcher", "IMAGENET_MEAN", "IMAGENET_STD", "OdgtDataset",
           "PolypDataset", "PolypTestDataset", "RandomGenerator",
           "RandomGeneratorACDC", "SynapseDataset", "export_synapse_case",
           "preprocess_ct_volume", "preprocess_image", "preprocess_mask",
           "random_split", "remap_synapse_labels", "tif_to_png"]

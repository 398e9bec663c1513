from pranet2_tpu_torch.evalx.binary_metrics import (BINARY_METRIC_NAMES,
                                                    aggregate_dataset_metrics,
                                                    binary_image_metrics)
from pranet2_tpu_torch.evalx.volumetric import (calculate_dice_percase,
                                                calculate_metric_percase)

__all__ = ["BINARY_METRIC_NAMES", "aggregate_dataset_metrics",
           "binary_image_metrics", "calculate_dice_percase",
           "calculate_metric_percase"]

from pranet2_tpu_torch.evalx.binary_metrics import (BINARY_METRIC_NAMES,
                                                    aggregate_dataset_metrics,
                                                    binary_image_metrics)

__all__ = ["BINARY_METRIC_NAMES", "aggregate_dataset_metrics",
           "binary_image_metrics"]

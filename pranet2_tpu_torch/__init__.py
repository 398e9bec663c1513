"""PyTorch / CUDA port of pranet2_tpu for NVIDIA Hopper (H100).

NCHW tensors, ``nn.Module``s named after the reference checkpoint's torch
attribute paths, hand-written CUDA kernels (``csrc/``) where the JAX package
has Pallas kernels.  Entry points run on the GPU unless given
``device="cpu"``.  This package imports neither JAX nor ``pranet2_tpu``.
"""

from pranet2_tpu_torch.device import default_device
from pranet2_tpu_torch.models import get_model, list_models

__all__ = ["default_device", "get_model", "list_models"]

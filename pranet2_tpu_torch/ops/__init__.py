"""Tensor ops of the port (NCHW).  Kernels live in ``stem``, ``dsra``,
``res2_tail``, ``res2_block``, ``pvt_mlp`` and ``pvt_attn``."""

from pranet2_tpu_torch.ops.dsra import dsra_gate, dsra_gate_plain
from pranet2_tpu_torch.ops.pooling import avg_pool, max_pool
from pranet2_tpu_torch.ops.resize import (resize_bilinear, resize_bilinear_np,
                                          upsample)
from pranet2_tpu_torch.ops.stem import max_pool3x3s2, max_pool3x3s2_plain

__all__ = ["avg_pool", "dsra_gate", "dsra_gate_plain", "max_pool",
           "max_pool3x3s2", "max_pool3x3s2_plain", "resize_bilinear",
           "resize_bilinear_np", "upsample"]

"""Tensor ops of the port (NCHW).  Kernels live in ``stem``, ``dsra``,
``res2_tail``, ``res2_block``, ``pvt_mlp``, ``pvt_attn``, ``pvt_block`` and
``dwconv``."""

from pranet2_tpu_torch.ops.dsra import (dsra_gate, dsra_gate_plain, dsra_level,
                                        dsra_level_plain, reverse_attention)
from pranet2_tpu_torch.ops.dwconv import (depthwise_conv3x3,
                                          depthwise_conv3x3_plain)
from pranet2_tpu_torch.ops.pooling import avg_pool, avg_pool_same, max_pool
from pranet2_tpu_torch.ops.pvt_attn import sra_block, sra_block_plain
from pranet2_tpu_torch.ops.pvt_block import pvt_block, pvt_block_plain
from pranet2_tpu_torch.ops.resize import (resize_bilinear, resize_bilinear_np,
                                          upsample, upsample_nearest)
from pranet2_tpu_torch.ops.stem import (max_pool3x3s2, max_pool3x3s2_plain,
                                        stem_pool, stem_pool_plain)

__all__ = ["avg_pool", "avg_pool_same", "depthwise_conv3x3",
           "depthwise_conv3x3_plain", "dsra_gate", "dsra_gate_plain",
           "dsra_level", "dsra_level_plain", "max_pool", "max_pool3x3s2",
           "max_pool3x3s2_plain", "pvt_block", "pvt_block_plain",
           "resize_bilinear", "resize_bilinear_np", "reverse_attention",
           "sra_block", "sra_block_plain", "stem_pool", "stem_pool_plain",
           "upsample", "upsample_nearest"]

"""Data parallelism: one process per card, gradients averaged, BatchNorm
over the global batch.

Counterpart of ``pranet2_tpu/parallel/``.  There one ``Mesh`` with a
``data`` axis holds every chip of one program: the batch is split over the
axis, the parameters are replicated, and under ``jit`` XLA inserts the
cross-replica reductions, so BatchNorm's statistics are those of the global
batch (SyncBN) with no code of the package's own.  PyTorch runs eagerly and
has no such compiler, so the port takes PyTorch's idiom: one process per
card under ``torchrun`` (or started from Python by ``spawn.launch``), a
``torch.distributed`` process group in place of the mesh
(``init_from_env``), ``DistributedDataParallel`` to average the gradients,
and a synchronized BatchNorm of its own (``SyncBatchNorm``) in place of
XLA's global-batch statistics.  Each rank
holds a contiguous block of rows of the global batch (``shard_rows``), as
``PartitionSpec("data")`` splits it.

With one process and no torchrun environment nothing here creates a group,
and ``data_parallel`` returns the model untouched: single-device training
runs the same code as before.
"""

from pranet2_tpu_torch.parallel.distributed import (all_mean,
                                                    broadcast_object,
                                                    data_parallel, destroy,
                                                    gather_rows,
                                                    init_from_env, is_main,
                                                    main_only, rank,
                                                    shard_rows, world)
from pranet2_tpu_torch.parallel.sync_batchnorm import (SyncBatchNorm,
                                                       convert_sync_batchnorm)

__all__ = ["SyncBatchNorm", "all_mean", "broadcast_object",
           "convert_sync_batchnorm", "data_parallel", "destroy",
           "gather_rows", "init_from_env", "is_main", "main_only", "rank",
           "shard_rows", "world"]

"""The process group: set-up from torchrun's environment, small collectives,
the batch's split over the ranks and the data-parallel wrapper.

Every function here is a no-op at world 1 without a group: a single
process runs exactly the single-device code.
"""

from __future__ import annotations

import os
import warnings

import torch
import torch.distributed as dist
from torch import nn

from pranet2_tpu_torch.parallel.sync_batchnorm import convert_sync_batchnorm

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def init_from_env(device=None) -> tuple[int, int]:
    """Join the process group that torchrun describes; returns (rank, world).

    Reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``
    (``MASTER_ADDR``/``MASTER_PORT`` are read by ``init_process_group``).
    Without them, or at a world size of 1, it is world 1 and creates no
    group.  On a card (``device`` None or CUDA) each rank makes card
    ``local_rank % device_count`` its current device, so that the port's
    default ``cuda`` device is that rank's card.  The backend is ``nccl``
    when every rank of the host has a card of its own, ``gloo`` on the CPU
    or when ranks share a card; rank 0 prints it.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if "WORLD_SIZE" not in os.environ or int(os.environ["WORLD_SIZE"]) <= 1:
        return 0, 1
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"incomplete torchrun environment: {missing} "
                           f"not set")
    rank_, world_ = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local, local_world = (int(os.environ["LOCAL_RANK"]),
                          int(os.environ["LOCAL_WORLD_SIZE"]))
    on_card = device is None or torch.device(device).type == "cuda"
    backend = "gloo"
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "--device cpu to train on the CPU")
        n_cards = torch.cuda.device_count()
        torch.cuda.set_device(local % n_cards)
        if local_world <= n_cards:
            backend = "nccl"
    dist.init_process_group(backend, rank=rank_, world_size=world_)
    if rank_ == 0:
        print(f"parallel: {world_} ranks, backend {backend}", flush=True)
    return rank_, world_


def destroy() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """Whether this process writes the logs, snapshots and evaluations."""
    return rank() == 0


def main_only(log):
    """``log`` on rank 0, a function that prints nothing on the others."""
    return log if is_main() else _silent


def _silent(*args, **kwargs) -> None:
    pass


def all_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks (a detached copy; ``t`` itself at
    world 1)."""
    if world() == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out / world()


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank (picklable objects)."""
    if world() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def shard_rows(n_global: int, rank_: int, world_: int) -> slice:
    """Rank ``rank_``'s contiguous block of a global batch of ``n_global``
    rows, as ``PartitionSpec("data")`` splits it; raises ``ValueError``
    when the rows do not split evenly, as JAX's sharding does."""
    if n_global % world_:
        raise ValueError(f"batch of {n_global} rows not divisible over "
                         f"{world_} ranks")
    b = n_global // world_
    return slice(rank_ * b, (rank_ + 1) * b)


def _all_rows(x: torch.Tensor) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(world())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    """All ranks' rows concatenated in rank order; the gradient of a rank's
    rows is the sum over the ranks of theirs (all-gather's adjoint)."""

    @staticmethod
    def forward(ctx, x):
        ctx.rows = shard_rows(x.shape[0] * world(), rank(), world())
        return _all_rows(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad[ctx.rows]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch of ``x`` (each rank's rows, in rank order) on every
    rank, differentiable: a loss that is not a mean of per-image terms
    (the multiclass Dice sums over the whole batch) is computed on it, the
    same on every rank.  ``x`` itself at world 1."""
    if world() == 1:
        return x
    return _GatherRows.apply(x) if x.requires_grad else _all_rows(x)


def data_parallel(model: nn.Module) -> nn.Module:
    """``model`` for data-parallel training: its BatchNorms synchronized
    (``convert_sync_batchnorm``, in place) and wrapped in
    ``DistributedDataParallel`` on the rank's card (or the CPU).

    ``find_unused_parameters=True``: PraNet-V2's and EMCAD's grayscale stem
    runs only on 1-channel input, so an RGB step leaves it without a
    gradient, which DDP refuses otherwise.  ``broadcast_buffers=False``:
    the running statistics are the same on every rank already (each
    BatchNorm updates them from the global batch's statistics).

    At world 1 it returns ``model`` untouched.
    """
    if world() == 1:
        return model
    model = convert_sync_batchnorm(model)
    dev = next(model.parameters()).device
    ids = ([dev.index if dev.index is not None
            else torch.cuda.current_device()]
           if dev.type == "cuda" else None)
    with warnings.catch_warnings():
        # newer torch deprecates the flag's name, not what it does
        warnings.filterwarnings("ignore", ".*broadcast_buffers",
                                FutureWarning)
        return nn.parallel.DistributedDataParallel(
            model, device_ids=ids, broadcast_buffers=False,
            find_unused_parameters=True)

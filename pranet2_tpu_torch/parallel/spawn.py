"""Ranks of a process group on this host, started from Python rather than
by torchrun: the port's data-parallel tests and ``chip_smoke.py`` run a
function on every rank and hold the results against one process.

``launch(fn, world, tmp_dir, *args)`` starts ``world`` processes with the
``spawn`` start method (forking a process that holds other libraries'
threads can deadlock), each joins the group through a file store under
``tmp_dir`` (no port to collide on), runs ``fn(*args)`` and saves what it
returns.  Each rank's collectives time out after ``rank_timeout`` seconds
and the caller waits at most ``timeout`` seconds for all of them: a rank
that hangs or dies raises here instead of hanging the caller.
"""

from __future__ import annotations

import multiprocessing as mp
import time
import traceback
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist


def launch(fn, world: int, tmp_dir, *args, backend: str = "gloo",
           devices=None, threads: int | None = None,
           timeout: float = 180.0, rank_timeout: float = 60.0) -> list:
    """``fn(*args)`` on ``world`` spawned ranks of a ``backend`` group; what
    each returned, in rank order.

    ``devices[r]``: rank r's current card, set before it joins.
    ``threads``: each rank's intra-op threads (torch's default if None).
    Raises ``AssertionError`` with the ranks' tracebacks if a rank fails
    or is still running after ``timeout`` seconds (it is then killed).
    """
    tmp = Path(tmp_dir)
    tmp.mkdir(parents=True, exist_ok=True)
    store = tmp / "store"
    store.unlink(missing_ok=True)
    # the arguments go through a file: a start() whose pickle outgrows the
    # pipe waits until that child has imported, one child after another
    torch.save(args, tmp / "args.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, backend, f"file://{store}",
                               str(tmp), devices, threads, rank_timeout))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = "".join((tmp / f"rank{r}.err").read_text()
                     for r in range(world) if (tmp / f"rank{r}.err").exists())
    if hung:
        raise AssertionError(f"ranks {hung} still running after {timeout} s"
                             f"\n{errors}")
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"rank exit codes {codes}\n{errors}")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _rank_main(fn, rank: int, world: int, backend: str, init: str,
               out: str, devices, threads, rank_timeout: float) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        if devices is not None and torch.device(devices[rank]).type == "cuda":
            torch.cuda.set_device(torch.device(devices[rank]))
        args = torch.load(Path(out) / "args.pt", weights_only=False)
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=rank_timeout))
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        torch.save(result, Path(out) / f"rank{rank}.pt")
    except BaseException:
        (Path(out) / f"rank{rank}.err").write_text(
            f"rank {rank}:\n{traceback.format_exc()}")
        raise

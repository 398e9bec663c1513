"""Host-side batch loading with threaded workers, and device prefetch.

Port of ``pranet2_tpu/data/loader.py``: a thread pool decodes on the host,
batches are stacked as numpy (HWC, as the datasets give them), and
``DevicePrefetcher`` keeps ``depth`` batches in flight to the card so that
it never waits on input.  The shuffle draws from numpy's
``default_rng(seed)`` as the JAX package's does, so both visit the same
order.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import threading
from collections.abc import Iterable, Iterator
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

from pranet2_tpu_torch.device import resolve


class CachedDataset:
    """RAM-cached dataset: every item decoded once, by a process pool.

    Decode and resize are bound by the interpreter lock in one process,
    while the card trains far faster; medical segmentation train sets are
    small (polyp: 1450 images, about 3.6 GB preprocessed f32), so decode is
    paid once and epochs stream from memory.  Only for deterministic
    datasets (no random augmentation in ``__getitem__``); cache the raw
    dataset and augment on top with ``AugmentedView`` otherwise.

    The workers are spawned, not forked: the caller may already hold CUDA
    and threads.  They import the dataset's module afresh and do PIL and
    numpy work only.
    """

    def __init__(self, dataset, num_procs: int | None = None):
        n = len(dataset)
        if num_procs is None:
            num_procs = min(os.cpu_count() or 1, 16, n)
        if num_procs > 1 and n > 8:
            ctx = mp.get_context("spawn")
            with ProcessPoolExecutor(num_procs, mp_context=ctx) as pool:
                self._items = list(pool.map(
                    dataset.__getitem__, range(n),
                    chunksize=max(n // (num_procs * 4), 1)))
        else:
            self._items = [dataset[i] for i in range(n)]

    def __len__(self):
        return len(self._items)

    def __getitem__(self, i: int):
        return self._items[i]


class AugmentedView:
    """Apply a (possibly random) transform over a cached raw dataset."""

    def __init__(self, dataset, transform):
        self.dataset = dataset
        self.transform = transform

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i: int):
        image, label = self.dataset[i]
        return self.transform(image, label)


class BatchLoader:
    """Shuffling, batching loader over an indexable dataset of tuples."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, num_threads: int = 8):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = num_threads
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def __iter__(self) -> Iterator[tuple[np.ndarray, ...]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        n = len(self)

        def fetch(i):
            return self.dataset[int(i)]

        with ThreadPoolExecutor(self.num_threads) as pool:
            for b in range(n):
                idx = order[b * self.batch_size:(b + 1) * self.batch_size]
                items = list(pool.map(fetch, idx))
                yield tuple(np.stack([it[k] for it in items])
                            for k in range(len(items[0])))


class _Failed:
    def __init__(self, exc: BaseException):
        self.exc = exc


_END = object()


class DevicePrefetcher:
    """Wraps a host iterator of numpy batches; yields tuples of tensors on
    ``device`` (the card unless given), in the host batches' layout.

    On the card a producer thread copies each batch into pinned memory and
    on to the device by ``non_blocking`` copies on a side stream, keeping
    ``depth`` batches in flight; before a batch is handed out the
    consumer's current stream waits for its copies, and each tensor
    records that stream, so that its memory is not reused while the
    consumer's kernels may still read it.  On the CPU it is a plain
    pass-through of tensors.
    """

    def __init__(self, it: Iterable, device=None, depth: int = 2):
        self.it = it
        self.device = resolve(device)
        self.depth = depth

    def __iter__(self):
        if self.device.type != "cuda":
            for batch in self.it:
                yield tuple(torch.from_numpy(np.ascontiguousarray(a))
                            .to(self.device) for a in batch)
            return
        yield from self._prefetch()

    def _prefetch(self):
        dev = self.device
        side = torch.cuda.Stream(dev)
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with torch.cuda.device(dev), torch.cuda.stream(side):
                    for batch in self.it:
                        host = [torch.from_numpy(np.ascontiguousarray(a))
                                .pin_memory() for a in batch]
                        moved = tuple(h.to(dev, non_blocking=True)
                                      for h in host)
                        ready = torch.cuda.Event()
                        ready.record(side)
                        if not put((moved, ready)):
                            return
                put(_END)
            except BaseException as e:  # handed to the consumer, re-raised
                put(_Failed(e))

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, _Failed):
                    raise item.exc
                moved, ready = item
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(ready)
                for t in moved:
                    t.record_stream(consumer)
                yield moved
        finally:
            stop.set()
            thread.join(timeout=60)

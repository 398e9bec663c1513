"""Serving API: a fixed-shape batched predictor for PraNet inference.

Port of ``pranet2_tpu/serve.py::BinaryPredictor``.  Images (H x W x 3
uint8, any native size) go in; uint8 masks at each image's native size come
out, with the reference export's semantics: the sum of the four fg maps for
a V2 model (``*_v2``), the finest map (``outs[3]``) for a V1 model.
Partial batches are padded with zeros to the fixed batch size.

Several devices (``devices=[...]``, JAX's ``mesh=``): one replica of the
model on each, every batch split into equal contiguous chunks, one a
replica, as ``shard_map`` splits it over the mesh's ``data`` axis.  Every
op of the eval forward works image by image (BatchNorm on its running
statistics, the min-max per image), so the split changes no mask.

Spans (``utils.profiling.span``, recorded only while recording is on),
each keyed by the predictor's batch number: ``serve.decode`` and
``serve.launch`` around a batch's two stages, ``serve.copyout_wait`` around
the wait for its copy-out, ``serve.resize`` around each image's hand-back
at native size (on the exact path a copy of its mask out of the batch's
host buffer; else the host resize of the uint8 map).
"""

from __future__ import annotations

import itertools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image

from pranet2_tpu_torch.data.polyp import preprocess_image
from pranet2_tpu_torch.device import resolve
from pranet2_tpu_torch.models import get_model
from pranet2_tpu_torch.ops.native_mask import native_masks
from pranet2_tpu_torch.ops.resize import resize_bilinear_np
from pranet2_tpu_torch.utils.profiling import span


def is_v2(model_name: str) -> bool:
    """Whether ``model_name`` is a PraNet-V2 model (``*_v2``): V2 models
    take ``num_class`` and are served the sum of their four fg maps; V1
    models take no ``num_class`` and are served their finest map."""
    return model_name.endswith("_v2")


def head_kwargs(model_name: str) -> dict:
    """The ``get_model`` keyword arguments of a served binary model:
    ``num_class=1`` for V2, none for V1."""
    return {"num_class": 1} if is_v2(model_name) else {}


def served_logits(outs, v2: bool) -> torch.Tensor:
    """The logits a binary model serves: V2's four fg maps summed
    (``outs[:4]``), V1's finest map (``outs[3]``; V1 returns its maps
    coarse-first)."""
    return (outs[0] + outs[1] + outs[2] + outs[3]) if v2 else outs[3]


class BinaryPredictor:
    """Batched PraNet predictor: HxWx3 uint8 images in, uint8 masks out."""

    def __init__(self, model_name: str, state_dict, batch_size: int = 16,
                 testsize: int = 352, dtype: torch.dtype | None = None,
                 exact_postproc: bool = True, host_workers: int | None = None,
                 device=None, model_kwargs: dict | None = None,
                 devices=None):
        """``state_dict``: the model's weights (a reference checkpoint, or
        ``utils.convert.state_dict_from_jax`` output loaded into a model).

        ``exact_postproc=True`` reproduces the reference export exactly:
        the float32 logits are resized to each image's native size, then
        sigmoid + min-max + uint8, on the device (``ops.native_masks``, one
        kernel a batch and replica on a GPU), and only the uint8 masks are
        copied to the host.  ``False`` runs sigmoid + min-max + uint8 at
        test size on the device and resizes the uint8 map on the host: 4x
        less device-to-host traffic than float32 logits, visually
        equivalent masks.

        ``host_workers``: threads for the per-image decode (PIL and numpy
        release the GIL).  ``None`` = ``os.cpu_count()``
        capped at ``batch_size``; 0 or 1 decodes inline.

        ``device``: the GPU unless given (``"cpu"`` for tests).

        ``devices``: serve on several devices instead (JAX's ``mesh``):
        one replica loaded from ``state_dict`` on each (a device may be
        listed twice: two replicas on one card), each batch split into
        ``len(devices)`` equal contiguous chunks, which go out back to
        back, each to its replica, before any comes back; the masks come
        out in order.  ``batch_size`` must split evenly over them; giving
        ``device`` as well raises.

        ``model_kwargs``: more keyword arguments for ``get_model``, e.g.
        ``{"fused": True, "tailfuse": True}`` for PraNet-V2 with the fused
        Res2Net blocks.
        """
        if device is not None and devices is not None:
            raise ValueError("give device= or devices=, not both")
        self.devices = ([resolve(d) for d in devices] if devices is not None
                        else [resolve(device)])
        n_dev = len(self.devices)
        if not n_dev or batch_size % n_dev:
            raise ValueError(f"batch_size {batch_size} not divisible by the "
                             f"{n_dev}-device mesh")
        self.device = self.devices[0]
        self.v2 = is_v2(model_name)
        self.models = []
        for dev in self.devices:
            model = get_model(model_name, device=dev, dtype=dtype,
                              **head_kwargs(model_name),
                              **(model_kwargs or {}))
            model.load_state_dict(state_dict)
            self.models.append(model.eval())
        self.model = self.models[0]
        self.batch_size = batch_size
        self.testsize = testsize
        self.exact_postproc = exact_postproc
        if host_workers is None:
            host_workers = min(os.cpu_count() or 1, batch_size)
        self._pool = (ThreadPoolExecutor(max_workers=host_workers)
                      if host_workers > 1 else None)
        self._batches = itertools.count()  # the spans' keys

    def close(self):
        """Stop the host decode threads."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    @torch.inference_mode()
    def _forward(self, x: torch.Tensor, model=None) -> torch.Tensor:
        """The served output of ``x`` by ``model`` (the first replica when
        None)."""
        logits = served_logits((model or self.model)(x), self.v2)
        if self.exact_postproc:
            return logits.float()
        p = torch.sigmoid(logits.float())
        lo = p.amin(dim=(1, 2, 3), keepdim=True)
        hi = p.amax(dim=(1, 2, 3), keepdim=True)
        p = (p - lo) / (hi - lo + 1e-8)
        return (p * 255.0).to(torch.uint8)

    def warmup(self):
        """One forward of every replica at its chunk's shape and, on the
        exact path, one mask made from it (the kernel's first use builds
        it)."""
        b = self.batch_size // len(self.devices)
        for model, dev in zip(self.models, self.devices):
            out = self._forward(torch.zeros(
                (b, 3, self.testsize, self.testsize), device=dev), model)
            if self.exact_postproc:
                native_masks(out, [(self.testsize, self.testsize)])
        for dev in self.devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _decode_one(self, im) -> np.ndarray:
        pil = Image.fromarray(np.asarray(im))
        return preprocess_image(pil.convert("RGB"), self.testsize)

    def _preprocess(self, chunk) -> torch.Tensor:
        """(B, 3, S, S) float32 batch, in pinned memory when serving a GPU."""
        s = self.testsize
        batch = torch.zeros((self.batch_size, 3, s, s), dtype=torch.float32,
                            pin_memory=any(d.type == "cuda"
                                           for d in self.devices))
        arr = batch.numpy()
        decoded = (self._pool.map(self._decode_one, chunk)
                   if self._pool is not None else map(self._decode_one, chunk))
        for i, img in enumerate(decoded):
            arr[i] = img.transpose(2, 0, 1)
        return batch

    def _launch(self, batch: torch.Tensor, sizes):
        """Enqueue one batch: each replica's chunk copied in, forwarded, on
        the exact path made into its images' masks at their native
        ``sizes`` (h, w), and copied out, all before any is waited for.
        Returns, a chunk each, the host tensor, the event that marks it
        ready (None on the CPU) and, on the exact path, the offsets of the
        chunk's masks in it (else None)."""
        launched = []
        per = self.batch_size // len(self.devices)
        chunks = batch.chunk(len(self.devices))
        for i, (model, dev, chunk) in enumerate(zip(self.models, self.devices,
                                                    chunks)):
            out = self._forward(chunk.to(dev, non_blocking=True), model)
            offsets = None
            if self.exact_postproc:
                out, offsets = native_masks(out, sizes[i * per:(i + 1) * per])
            if dev.type != "cuda":
                launched.append((out, None, offsets))
                continue
            with torch.cuda.device(dev):
                host = out.to("cpu", non_blocking=True)  # pinned, async
                ready = torch.cuda.Event()
                ready.record()
            launched.append((host, ready, offsets))
        return launched

    def _postprocess(self, launched, sizes, key=None):
        with span("serve.copyout_wait", key):
            for _, ready, _ in launched:
                if ready is not None:
                    ready.synchronize()
        if self.exact_postproc:
            packed = [(host.numpy(), offsets) for host, _, offsets in launched]
            masks = ((buf, off) for buf, offsets in packed for off in offsets)
            for (buf, off), (h, w) in zip(masks, sizes):
                with span("serve.resize", key):
                    # a copy: the mask must not keep the batch's buffer
                    mask = buf[off:off + h * w].reshape(h, w).copy()
                yield mask
            return
        hosts = [host for host, _, _ in launched]
        result = (hosts[0] if len(hosts) == 1 else torch.cat(hosts)).numpy()
        for r, (h, w) in zip(result, sizes):
            with span("serve.resize", key):
                x = resize_bilinear_np(r.astype(np.float32), (h, w))[0]
            yield np.clip(x, 0, 255).astype(np.uint8)

    def stream(self, images):
        """Pipelined prediction: yields uint8 masks in input order.

        ``images`` may be any iterable of HxWx3 arrays; it is consumed lazily
        in ``batch_size`` chunks.  CUDA work is asynchronous, so batch i runs
        on the GPU while batch i+1 is decoded on the host and batch i-1's
        masks are post-processed; waiting for batch i-1's copy-out event is
        the only synchronisation.
        """
        it = iter(images)
        prev = None
        while True:
            chunk = list(itertools.islice(it, self.batch_size))
            if not chunk:
                break
            key = next(self._batches)
            with span("serve.decode", key):
                batch = self._preprocess(chunk)
                sizes = [np.asarray(im).shape[:2] for im in chunk]
            with span("serve.launch", key):
                launched = self._launch(batch, sizes)
            if prev is not None:
                yield from self._postprocess(*prev)
            prev = (launched, sizes, key)
        if prev is not None:
            yield from self._postprocess(*prev)

    def __call__(self, images) -> list[np.ndarray]:
        """images: list of HxWx3 uint8 arrays (native sizes).

        Returns uint8 masks at each image's native size (sigmoid + min-max
        normalized, the reference's export semantics).
        """
        return list(self.stream(images))

"""Serving API: a fixed-shape batched predictor for PraNet-V2 inference.

Port of ``pranet2_tpu/serve.py::BinaryPredictor`` (single device).  Images
(H x W x 3 uint8, any native size) go in; uint8 masks at each image's native
size come out, with the reference export's semantics.  Partial batches are
padded with zeros to the fixed batch size.
"""

from __future__ import annotations

import itertools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image
from scipy.special import expit

from pranet2_tpu_torch.data.polyp import preprocess_image
from pranet2_tpu_torch.device import resolve
from pranet2_tpu_torch.models import get_model
from pranet2_tpu_torch.ops.resize import resize_bilinear_np


class BinaryPredictor:
    """Batched PraNet-V2 predictor: HxWx3 uint8 images in, uint8 masks out."""

    def __init__(self, model_name: str, state_dict, batch_size: int = 16,
                 testsize: int = 352, dtype: torch.dtype | None = None,
                 exact_postproc: bool = True, host_workers: int | None = None,
                 device=None, model_kwargs: dict | None = None):
        """``state_dict``: the model's weights (a reference checkpoint, or
        ``utils.convert.state_dict_from_jax`` output loaded into a model).

        ``exact_postproc=True`` reproduces the reference export exactly:
        float32 logits come to the host, are resized to native size, then
        sigmoid + min-max.  ``False`` runs sigmoid + min-max + uint8 on the
        device at test size and resizes the uint8 map on the host: 4x less
        device-to-host traffic, visually equivalent masks.

        ``host_workers``: threads for the per-image decode/resize/normalize
        (PIL and numpy release the GIL).  ``None`` = ``os.cpu_count()``
        capped at ``batch_size``; 0 or 1 decodes inline.

        ``device``: the GPU unless given (``"cpu"`` for tests).

        ``model_kwargs``: more keyword arguments for ``get_model``, e.g.
        ``{"fused": True, "tailfuse": True}`` for PraNet-V2 with the fused
        Res2Net blocks.
        """
        self.device = resolve(device)
        self.model = get_model(model_name, device=self.device, dtype=dtype,
                               num_class=1, **(model_kwargs or {}))
        self.model.load_state_dict(state_dict)
        self.model.eval()
        self.batch_size = batch_size
        self.testsize = testsize
        self.exact_postproc = exact_postproc
        if host_workers is None:
            host_workers = min(os.cpu_count() or 1, batch_size)
        self._pool = (ThreadPoolExecutor(max_workers=host_workers)
                      if host_workers > 1 else None)

    def close(self):
        """Stop the host decode threads."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    @torch.inference_mode()
    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = self.model(x)
        logits = outs[0] + outs[1] + outs[2] + outs[3]
        if self.exact_postproc:
            return logits.float()
        p = torch.sigmoid(logits.float())
        lo = p.amin(dim=(1, 2, 3), keepdim=True)
        hi = p.amax(dim=(1, 2, 3), keepdim=True)
        p = (p - lo) / (hi - lo + 1e-8)
        return (p * 255.0).to(torch.uint8)

    def warmup(self):
        x = torch.zeros((self.batch_size, 3, self.testsize, self.testsize),
                        device=self.device)
        self._forward(x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _decode_one(self, im) -> np.ndarray:
        pil = Image.fromarray(np.asarray(im))
        return preprocess_image(pil.convert("RGB"), self.testsize)

    def _preprocess(self, chunk) -> torch.Tensor:
        """(B, 3, S, S) float32 batch, in pinned memory when serving a GPU."""
        s = self.testsize
        batch = torch.zeros((self.batch_size, 3, s, s), dtype=torch.float32,
                            pin_memory=self.device.type == "cuda")
        arr = batch.numpy()
        decoded = (self._pool.map(self._decode_one, chunk)
                   if self._pool is not None else map(self._decode_one, chunk))
        for i, img in enumerate(decoded):
            arr[i] = img.transpose(2, 0, 1)
        return batch

    def _launch(self, batch: torch.Tensor):
        """Enqueue one batch: copy in, forward, copy out.  Returns the host
        tensor and the event that marks it ready (None on the CPU)."""
        x = batch.to(self.device, non_blocking=True)
        out = self._forward(x)
        if self.device.type != "cuda":
            return out, None
        host = out.to("cpu", non_blocking=True)  # pinned, asynchronous
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    def _postprocess(self, launched, chunk):
        host, ready = launched
        if ready is not None:
            ready.synchronize()
        result = host.numpy()
        for r, im in zip(result[: len(chunk)], chunk):
            h, w = np.asarray(im).shape[:2]
            if self.exact_postproc:
                x = resize_bilinear_np(r, (h, w))[0]
                x = expit(x)
                x = (x - x.min()) / (x.max() - x.min() + 1e-8)
                yield (x * 255).astype(np.uint8)
            else:
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
            launched = self._launch(self._preprocess(chunk))
            if prev is not None:
                yield from self._postprocess(*prev)
            prev = (launched, chunk)
        if prev is not None:
            yield from self._postprocess(*prev)

    def __call__(self, images) -> list[np.ndarray]:
        """images: list of HxWx3 uint8 arrays (native sizes).

        Returns uint8 masks at each image's native size (sigmoid + min-max
        normalized, the reference's export semantics).
        """
        return list(self.stream(images))

"""The served masks at native size: bilinear resize of each image's logit
map to its own (h, w) (``align_corners=False``), sigmoid, min-max over the
image, ``x 255`` and a truncating cast to uint8, the reference export's
post-processing (``binary_seg/MyTest_med.py``) in float32.

No TPU kernel corresponds: the JAX package resizes on the host
(``pranet2_tpu/serve.py``).  ``native_masks`` launches the hand-written
kernel (``csrc/native_mask.cu``) on a CUDA tensor and runs the plain
version on a CPU tensor.  Both return the masks of a batch packed into one
flat uint8 tensor, each image's ``h * w`` bytes at its offset, the offsets
16-byte aligned (``mask_offsets``); serving copies the packed masks to the
host in one copy.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from pranet2_tpu_torch.ops import _build

ALIGN = 16  # bytes: each mask starts at a multiple (the kernel's 16-byte stores)


def mask_offsets(sizes) -> tuple[list[int], int]:
    """Each (h, w) mask's offset in the packed buffer, and its length."""
    offsets, end = [], 0
    for h, w in sizes:
        offsets.append(end)
        end += -(-h * w // ALIGN) * ALIGN
    return offsets, end


def _check(logits: torch.Tensor, sizes) -> None:
    if logits.dim() != 4 or logits.shape[1] != 1:
        raise ValueError("native_masks: needs (B, 1, H, W) logits, got "
                         f"shape {tuple(logits.shape)}")
    if logits.dtype != torch.float32:
        raise TypeError(f"native_masks: needs float32 logits, got "
                        f"{logits.dtype}")
    if len(sizes) > logits.shape[0]:
        raise ValueError(f"native_masks: {len(sizes)} sizes for a batch of "
                         f"{logits.shape[0]}")
    if any(h < 1 or w < 1 for h, w in sizes):
        raise ValueError(f"native_masks: empty native size in {sizes}")


def native_masks_plain(logits: torch.Tensor, sizes) -> tuple[torch.Tensor,
                                                               list[int]]:
    """Plain PyTorch version, on the logits' device: per image
    ``F.interpolate`` (bilinear, ``align_corners=False``), ``torch.sigmoid``,
    ``(x - min) / (max - min + 1e-8)``, ``(x * 255).to(uint8)``."""
    _check(logits, sizes)
    offsets, total = mask_offsets(sizes)
    packed = torch.zeros(total, dtype=torch.uint8, device=logits.device)
    for lg, (h, w), off in zip(logits, sizes, offsets):
        x = F.interpolate(lg[None], size=(h, w), mode="bilinear",
                          align_corners=False)[0, 0]
        x = torch.sigmoid(x)
        x = (x - x.min()) / (x.max() - x.min() + 1e-8)
        packed[off:off + h * w] = (x * 255).to(torch.uint8).flatten()
    return packed, offsets


@functools.cache
def _kernel():
    lib = _build.library("native_mask")
    f = lib.native_masks
    f.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p]
    f.restype = ctypes.c_int
    lib.native_mask_block_pixels.restype = ctypes.c_int
    return f, lib.native_mask_block_pixels()


def native_masks(logits: torch.Tensor, sizes) -> tuple[torch.Tensor,
                                                         list[int]]:
    """The uint8 masks of the first ``len(sizes)`` images of ``logits``
    ((B, 1, H, W) float32), each at its (h, w) in ``sizes``; padded slots
    beyond get none.  Returns the packed masks (one flat uint8 tensor on
    the logits' device) and each mask's offset in it.

    CPU tensor: the plain version.  CUDA tensor: two launches of the
    kernel behind one copy of the images' table (pinned, asynchronous), on
    the current stream, no synchronise; a contiguous float32 map only, and
    raises on anything else, or where autograd records and the logits
    require grad (forward only).  ``native_masks.launches`` counts the
    calls that launched it: one a served batch and replica.
    """
    dev = logits.device
    if dev.type == "cpu":
        return native_masks_plain(logits, sizes)
    if dev.type != "cuda":
        raise ValueError(f"native_masks: unsupported device {dev}")
    _check(logits, sizes)
    if not logits.is_contiguous():
        raise ValueError("native_masks: the logits must be contiguous, got "
                         f"strides {logits.stride()}")
    _build.refuse_grad("native_masks", logits)
    offsets, total = mask_offsets(sizes)
    packed = torch.empty(total, dtype=torch.uint8, device=dev)
    if not sizes:
        return packed, offsets
    with torch.cuda.device(dev):
        kernel, block_pixels = _kernel()
        table = torch.zeros((len(sizes), 8), dtype=torch.int32,
                            pin_memory=True)
        rows = table.numpy()
        blocks = np.cumsum([0] + [-(-h * w // block_pixels)
                                  for h, w in sizes])
        if blocks[-1] >= 2 ** 31:
            raise ValueError(f"native_masks: {blocks[-1]} blocks for {sizes}")
        rows.view(np.int64)[:, 0] = offsets      # Image.offset
        rows[:, 2:4] = sizes                     # Image.h, Image.w
        rows[:, 4] = blocks[:-1]                 # Image.first_block
        table = table.to(dev, non_blocking=True)
        err = kernel(logits.data_ptr(), logits.shape[2], logits.shape[3],
                     table.data_ptr(), len(sizes), int(blocks[-1]),
                     packed.data_ptr(), _build.stream_ptr(logits))
    _build.check(err, "native_masks")
    native_masks.launches += 1
    return packed, offsets


native_masks.launches = 0

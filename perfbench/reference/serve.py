"""Plain reference of the published export (``binary_seg/MyTest_med.py``):
decode (PIL bilinear resize to the test size, [0, 1], ImageNet
normalisation), the model's four fg maps summed, then at each image's
native size a bilinear resize (``align_corners=False``), sigmoid, min-max
and uint8.  Nothing of the program is used; the resizes are
``F.interpolate`` and the arithmetic float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from perfbench.reference import pranet

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def decode(img: np.ndarray, size: int) -> np.ndarray:
    """HxWx3 uint8 -> 3xSxS float32."""
    im = Image.fromarray(np.asarray(img)).convert("RGB")
    x = np.asarray(im.resize((size, size), Image.BILINEAR), np.float32)
    return ((x / 255.0 - MEAN) / STD).transpose(2, 0, 1)


def postprocess(logit: torch.Tensor, hw) -> np.ndarray:
    """(S, S) float32 logits -> the uint8 mask at ``hw``."""
    x = F.interpolate(logit.float()[None, None], size=tuple(hw),
                      mode="bilinear", align_corners=False)[0, 0]
    x = torch.sigmoid(x)
    x = (x - x.min()) / (x.max() - x.min() + 1e-8)
    return (x * 255).to(torch.uint8).cpu().numpy()


def no_tf32():
    """A context with TF32 off for cuDNN and cuBLAS (the reference's
    float32 is float32)."""
    return _Flags(False)


def tf32():
    """A context with TF32 on for cuDNN and cuBLAS: the precision below
    float32, the training cell's control."""
    return _Flags(True)


class _Flags:
    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.on
        torch.backends.cuda.matmul.allow_tf32 = self.on

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.saved
        return False


def model(config: dict, state_dict: dict, device, quant=pranet.identity):
    """The reference model of ``config`` with ``state_dict``, in eval, its
    products through ``quant``."""
    with torch.device(device):
        ref = pranet.build(config)
    ref.load_state_dict(state_dict)
    return pranet.set_quant(ref.eval(), quant)


def masks(config: dict, state_dict: dict, frames, device,
          quant=pranet.identity, batch: int = 8) -> list[np.ndarray]:
    """The reference's uint8 mask of each HxWx3 frame, at its size."""
    ref = model(config, state_dict, device, quant)
    size = config["input_size"]
    out = []
    with no_tf32(), torch.no_grad():
        for i in range(0, len(frames), batch):
            chunk = frames[i:i + batch]
            x = torch.from_numpy(np.stack([decode(f, size) for f in chunk]))
            logits = pranet.served_logits(ref(x.to(device)))
            out += [postprocess(lg[0], np.asarray(f).shape[:2])
                    for lg, f in zip(logits, chunk)]
    return out


def mask_mad(got: np.ndarray, want: np.ndarray) -> float:
    """Mean absolute difference of two uint8 masks, in levels."""
    return float(np.abs(got.astype(np.int16) - want.astype(np.int16)).mean())

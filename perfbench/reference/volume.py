"""Plain reference of EMCAD's volumetric test (``test_single_volume``,
``multiclass_seg/EMCAD/utils/utils.py:184-190`` of ai4colonoscopy/PraNet-V2):
each (H, W) slice zoomed to the patch by ``scipy.ndimage.zoom`` at order
3, the float32 reference model (``reference/emcad.py``) run on it, the sum
of its four fg maps, softmax over the classes and argmax, and the labels
zoomed back at order 0.

The published test runs one slice at a time; here the zoomed slices go
through the model in chunks of ``batch`` rows, the last chunk shorter
(nothing is padded): every operation of the eval forward works image by
image, so the chunks change no label.  Nothing of the program is used;
TF32 is off for cuDNN and cuBLAS.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.ndimage import zoom

from perfbench.reference import emcad, pranet
from perfbench.reference.serve import no_tf32


def model(config: dict, state_dict: dict, device, quant=pranet.identity):
    """The reference model of ``config`` with ``state_dict``, in eval, its
    products through ``quant``."""
    with torch.device(device):
        ref = emcad.build(config)
    ref.load_state_dict(state_dict)
    return pranet.set_quant(ref.eval(), quant)


def labels(ref, volume: np.ndarray, patch: int, device, batch: int = 16,
           order_back: int = 0) -> np.ndarray:
    """The (D, H, W) int32 labels of a (D, H, W) float32 volume
    (``order_back``: the published 0; another only to read what a zoom
    back at that order would give)."""
    d, x, y = volume.shape
    slices = np.stack([zoom(s, (patch / x, patch / y), order=3)
                       if (x, y) != (patch, patch) else s for s in volume])
    out = np.empty((d, x, y), np.int32)
    with no_tf32(), torch.no_grad():
        for i in range(0, d, batch):
            xb = torch.from_numpy(slices[i:i + batch, None]).float()
            logits = emcad.served_logits(ref(xb.to(device)))
            pred = torch.softmax(logits, dim=1).argmax(1).cpu().numpy()
            for j, p in enumerate(pred, start=i):
                out[j] = (zoom(p, (x / patch, y / patch), order=order_back)
                          if (x, y) != (patch, patch) else p)
    return out

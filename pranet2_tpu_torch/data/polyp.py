"""Host-side image preprocessing for the polyp models (PIL + numpy).

Copy of ``preprocess_image`` from ``pranet2_tpu/data/polyp.py``: PIL bilinear
resize to (S, S), scale to [0, 1], ImageNet normalisation.  Returns HWC
float32; the caller transposes to CHW.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess_image(img: Image.Image, size: int) -> np.ndarray:
    """PIL bilinear resize + [0,1] + ImageNet normalize -> (S,S,3) f32."""
    img = img.resize((size, size), Image.BILINEAR)
    x = np.asarray(img, np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD

"""Dataset preparation utilities.

Port of ``pranet2_tpu/data/preprocess.py`` (a copy: it needs no JAX).
Reference equivalents: ``binary_seg/utils/format_conversion.py`` (tif ->
png, random train split) and
``multiclass_seg/EMCAD/utils/preprocess_synapse_data.py`` (CT HU windowing
+ per-slice/per-volume export).
"""

from __future__ import annotations

import os
import random

import numpy as np
from PIL import Image


def tif_to_png(src_dir: str, dst_dir: str) -> int:
    """Convert every .tif in ``src_dir`` to .png in ``dst_dir``; returns
    the number converted."""
    os.makedirs(dst_dir, exist_ok=True)
    n = 0
    for f in sorted(os.listdir(src_dir)):
        if not f.lower().endswith((".tif", ".tiff")):
            continue
        img = Image.open(os.path.join(src_dir, f))
        stem = os.path.splitext(f)[0]
        img.save(os.path.join(dst_dir, stem + ".png"))
        n += 1
    return n


def random_split(names: list[str], n_train: int = 550, seed: int = 0):
    """Random train/test split of file names (reference: 550-image split)."""
    rng = random.Random(seed)
    names = list(names)
    rng.shuffle(names)
    return names[:n_train], names[n_train:]


def preprocess_ct_volume(image: np.ndarray, hu_min: float = -125.0,
                         hu_max: float = 275.0) -> np.ndarray:
    """Clip CT Hounsfield units to [hu_min, hu_max] and scale to [0, 1]
    (``preprocess_synapse_data.py:28-46``)."""
    image = np.clip(image, hu_min, hu_max)
    return ((image - hu_min) / (hu_max - hu_min)).astype(np.float32)


def export_synapse_case(image: np.ndarray, label: np.ndarray, case: str,
                        out_dir: str, split: str = "train") -> list[str]:
    """Export one z-first CT case the way the reference training expects.

    train -> per-slice ``<case>_slice###.npz`` (keys image/label);
    test  -> volume ``<case>.npy.h5`` (keys image/label).
    Returns the list of sample names for the list file.
    """
    os.makedirs(out_dir, exist_ok=True)
    image = preprocess_ct_volume(image)
    if split == "train":
        names = []
        for i in range(image.shape[0]):
            name = f"{case}_slice{i:03d}"
            np.savez(os.path.join(out_dir, name + ".npz"),
                     image=image[i], label=label[i])
            names.append(name)
        return names
    import h5py

    with h5py.File(os.path.join(out_dir, f"{case}.npy.h5"), "w") as f:
        f.create_dataset("image", data=image)
        f.create_dataset("label", data=label)
    return [case]

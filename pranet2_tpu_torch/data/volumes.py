"""Synapse / ACDC datasets and their RandomGenerator augmentations (host).

Port of ``pranet2_tpu/data/volumes.py`` (numpy and scipy; a copy, so that
the same seed gives bit-equal arrays), re-derived there from
``multiclass_seg/EMCAD/utils/dataset_synapse.py`` and
``multiclass_seg/MERIT/utils/dataset_ACDC.py``:

* Synapse train: per-slice ``.npz`` with keys image/label; test: volume
  ``.npy.h5`` (h5py, imported only there) with image/label; ``nclass==9``
  remaps the 13-organ labels to 8 organs (5,9,10,12,13 -> 0; 11 -> 5).
* ACDC train/valid: per-slice ``.npz`` keys img/label; test: volume ``.npz``.
* RandomGenerator (Synapse flavor): p=.5 rot90+flip else p=.5 rotate +/-20deg
  (order-0, reshape=False), then zoom to output size (image order-3, label
  order-0).
* RandomGenerator (ACDC flavor): crop to the non-zero bbox (image > -1),
  zoom back (image order-1 / label order-0), then the same aug + final zoom.

Output: a slice as image (1, S, S) float32, channel-first for the port's
NCHW batches (the JAX package gives (S, S, 1)), and label (S, S) int32; a
volume as (D, H, W) image and label.
"""

from __future__ import annotations

import os

import numpy as np
from scipy import ndimage
from scipy.ndimage import zoom


def remap_synapse_labels(label: np.ndarray) -> np.ndarray:
    label = label.copy()
    for v in (5, 9, 10, 12, 13):
        label[label == v] = 0
    label[label == 11] = 5
    return label


def _random_rot_flip(image, label, rng):
    k = rng.integers(0, 4)
    image = np.rot90(image, k)
    label = np.rot90(label, k)
    axis = int(rng.integers(0, 2))
    return np.flip(image, axis=axis).copy(), np.flip(label, axis=axis).copy()


def _random_rotate(image, label, rng):
    angle = int(rng.integers(-20, 20))
    image = ndimage.rotate(image, angle, order=0, reshape=False)
    label = ndimage.rotate(label, angle, order=0, reshape=False)
    return image, label


class RandomGenerator:
    """Synapse-flavor augmentation (``dataset_synapse.py:29-47``)."""

    def __init__(self, output_size: tuple[int, int], seed: int | None = None):
        self.output_size = output_size
        self.rng = np.random.default_rng(seed)

    def _augment(self, image, label):
        if self.rng.random() > 0.5:
            image, label = _random_rot_flip(image, label, self.rng)
        elif self.rng.random() > 0.5:
            image, label = _random_rotate(image, label, self.rng)
        return image, label

    def __call__(self, image: np.ndarray, label: np.ndarray):
        image, label = self._augment(image, label)
        x, y = image.shape
        oh, ow = self.output_size
        if (x, y) != (oh, ow):
            image = zoom(image, (oh / x, ow / y), order=3)
            label = zoom(label, (oh / x, ow / y), order=0)
        return image.astype(np.float32), label.astype(np.int32)


class RandomGeneratorACDC(RandomGenerator):
    """ACDC-flavor: non-zero bbox crop + zoom first (``dataset_ACDC.py:33-73``)."""

    def __call__(self, image: np.ndarray, label: np.ndarray):
        nz = np.argwhere(image > -1)
        lo = nz.min(axis=0)
        hi = nz.max(axis=0)
        image = image[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1]
        label = label[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1]
        oh, ow = self.output_size
        zf = (oh / image.shape[0], ow / image.shape[1])
        image = zoom(image, zf, order=1)
        label = zoom(label, zf, order=0)
        image, label = self._augment(image, label)
        x, y = image.shape
        if (x, y) != (oh, ow):
            image = zoom(image, (oh / x, ow / y), order=3)
            label = zoom(label, (oh / x, ow / y), order=0)
        return image.astype(np.float32), label.astype(np.int32)


class SynapseDataset:
    """Train split -> (image (1,S,S), label (S,S)); test -> volumes.

    ``raw=True`` returns the untransformed 2-D slice pair (for RAM caching +
    ``AugmentedView`` — augmentation is random, the decode is not).
    """

    def __init__(self, base_dir: str, list_dir: str, split: str,
                 nclass: int = 9, transform: RandomGenerator | None = None,
                 raw: bool = False):
        self.split = split
        self.nclass = nclass
        self.transform = transform
        self.raw = raw
        with open(os.path.join(list_dir, split + ".txt")) as f:
            self.sample_list = [l.strip() for l in f if l.strip()]
        self.data_dir = base_dir

    def __len__(self):
        return len(self.sample_list)

    def case_name(self, idx):
        return self.sample_list[idx]

    def __getitem__(self, idx: int):
        name = self.sample_list[idx]
        if self.split == "train":
            data = np.load(os.path.join(self.data_dir, name + ".npz"))
            image, label = data["image"], data["label"]
        else:
            import h5py

            with h5py.File(os.path.join(self.data_dir, f"{name}.npy.h5"), "r") as f:
                image, label = f["image"][:], f["label"][:]
        if self.nclass == 9:
            label = remap_synapse_labels(label)
        if self.split == "train":
            if self.raw:
                return image.astype(np.float32), label.astype(np.int32)
            if self.transform is not None:
                image, label = self.transform(image, label)
            return image[None].astype(np.float32), label.astype(np.int32)
        return image.astype(np.float32), label.astype(np.int32)


class ACDCDataset:
    """ACDC train/valid slices + test volumes (``dataset_ACDC.py:90-116``)."""

    def __init__(self, base_dir: str, list_dir: str, split: str,
                 transform: RandomGenerator | None = None, raw: bool = False):
        self.split = split
        self.transform = transform
        self.raw = raw
        with open(os.path.join(list_dir, split + ".txt")) as f:
            self.sample_list = [l.strip() for l in f if l.strip()]
        self.data_dir = base_dir

    def __len__(self):
        return len(self.sample_list)

    def case_name(self, idx):
        return self.sample_list[idx]

    def __getitem__(self, idx: int):
        name = self.sample_list[idx]
        if self.split in ("train", "valid"):
            data = np.load(os.path.join(self.data_dir, self.split, name))
        else:
            data = np.load(os.path.join(self.data_dir, name))
        image, label = data["img"], data["label"]
        if self.split == "train" and self.raw:
            return image.astype(np.float32), label.astype(np.int32)
        if self.split == "train" and self.transform is not None:
            image, label = self.transform(image, label)
            return image[None].astype(np.float32), label.astype(np.int32)
        if self.split == "valid":
            return image[None].astype(np.float32), label.astype(np.int32)
        return image.astype(np.float32), label.astype(np.int32)

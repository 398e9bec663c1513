"""Polyp segmentation datasets (host-side, PIL + numpy).

Copy of ``pranet2_tpu/data/polyp.py`` (the port imports nothing of the JAX
package).  Preprocessing reproduces the reference pipeline
(``binary_seg/utils/dataloader.py:90-208``):

* train: PIL bilinear resize to (S, S) for both image and mask, image scaled
  to [0,1] and ImageNet-normalized, mask scaled to [0,1] (float, *not*
  binarized: bilinear-resized masks are supervised as they are).
* test: image as above; GT kept at native size (a uint8 array);
  prediction names map ``.jpg -> .png``.
* pairs with mismatched image/mask sizes are dropped (``filter_files``).

Arrays stay HWC float32 on the host, as the JAX package has them; the
consumer (the trainer, the predictor) transposes to NCHW.
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_IMG_EXT = (".jpg", ".png")


def _list_pairs(image_root: str, gt_root: str, gt_ext=(".png", ".tif")):
    images = sorted(os.path.join(image_root, f)
                    for f in os.listdir(image_root) if f.endswith(_IMG_EXT))
    gts = sorted(os.path.join(gt_root, f)
                 for f in os.listdir(gt_root) if f.endswith(tuple(gt_ext)))
    return images, gts


def load_rgb(path: str) -> Image.Image:
    with open(path, "rb") as f:
        return Image.open(f).convert("RGB")


def load_gray(path: str) -> Image.Image:
    with open(path, "rb") as f:
        return Image.open(f).convert("L")


def preprocess_image(img: Image.Image, size: int) -> np.ndarray:
    """PIL bilinear resize + [0,1] + ImageNet normalize -> (S,S,3) f32."""
    img = img.resize((size, size), Image.BILINEAR)
    x = np.asarray(img, np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def preprocess_mask(gt: Image.Image, size: int) -> np.ndarray:
    """PIL bilinear resize + [0,1] -> (S,S,1) f32."""
    gt = gt.resize((size, size), Image.BILINEAR)
    return (np.asarray(gt, np.float32) / 255.0)[..., None]


class PolypDataset:
    """Training dataset: returns (image (S,S,3), mask (S,S,1)) float32."""

    def __init__(self, image_root: str, gt_root: str, trainsize: int):
        self.trainsize = trainsize
        images, gts = _list_pairs(image_root, gt_root, gt_ext=(".png",))
        if len(images) != len(gts):
            raise ValueError(f"{len(images)} images but {len(gts)} masks "
                             f"under {image_root}, {gt_root}")
        self.images, self.gts = self._filter(images, gts)

    @staticmethod
    def _filter(images, gts):
        keep_i, keep_g = [], []
        for ip, gp in zip(images, gts):
            with Image.open(ip) as im, Image.open(gp) as gm:
                if im.size == gm.size:
                    keep_i.append(ip)
                    keep_g.append(gp)
        return keep_i, keep_g

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i: int):
        img = preprocess_image(load_rgb(self.images[i]), self.trainsize)
        gt = preprocess_mask(load_gray(self.gts[i]), self.trainsize)
        return img, gt


class OdgtDataset:
    """odgt-manifest dataset (the reference's legacy ``Kits9`` loader,
    ``binary_seg/utils/dataloader.py:23-89``): one JSON object per line with
    ``fpath_img`` / ``fpath_segm`` keys; same preprocessing as
    PolypDataset."""

    def __init__(self, describe_path: str, trainsize: int):
        self.trainsize = trainsize
        with open(describe_path) as f:
            self.samples = [json.loads(line) for line in f if line.strip()]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int):
        s = self.samples[i]
        img = preprocess_image(load_rgb(s["fpath_img"]), self.trainsize)
        gt = preprocess_mask(load_gray(s["fpath_segm"]), self.trainsize)
        return img, gt


class PolypTestDataset:
    """Test dataset: yields (image (1,S,S,3), gt uint8 (H,W) native, name)."""

    def __init__(self, image_root: str, gt_root: str, testsize: int):
        self.testsize = testsize
        self.images, self.gts = _list_pairs(image_root, gt_root)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i: int):
        img = preprocess_image(load_rgb(self.images[i]), self.testsize)[None]
        gt = np.asarray(load_gray(self.gts[i]))
        name = os.path.basename(self.images[i])
        if name.endswith(".jpg"):
            name = name[: -len(".jpg")] + ".png"
        return img, gt, name

    def batches(self, batch_size: int):
        """Fixed-size batched iteration: ``(images (B,S,S,3), gts, names,
        real)``.  GTs keep their native sizes; the final partial batch is
        padded with zero images to ``batch_size`` (``real`` counts the
        images that are not padding; gts and names hold only those)."""
        n = len(self)
        for start in range(0, n, batch_size):
            imgs, gts, names = [], [], []
            for i in range(start, min(start + batch_size, n)):
                im, gt, name = self[i]
                imgs.append(im[0])
                gts.append(gt)
                names.append(name)
            real = len(imgs)
            while len(imgs) < batch_size:
                imgs.append(np.zeros_like(imgs[0]))
            yield np.stack(imgs), gts, names, real

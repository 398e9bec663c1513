"""The port's volumetric metrics, Synapse/ACDC datasets and augmentations
against the JAX package's, on the CPU: exactly equal.

The metrics are held on 3-D masks with overlap, disjoint masks and each
empty-mask rule.  The datasets read synthetic files the test writes:
Synapse train slices (``.npz``) and test volumes (``.npy.h5``), ACDC
train/valid slices and test volumes (``.npz``).  Both packages' augmenters
are seeded alike and must give bit-equal arrays call after call; the port
gives a slice's image channel-first, (1, S, S), where JAX gives (S, S, 1).
"""

import h5py
import numpy as np
import pytest

from pranet2_tpu.data import volumes as jax_volumes
from pranet2_tpu.evalx import volumetric as jax_metrics
from pranet2_tpu_torch.data import volumes as port_volumes
from pranet2_tpu_torch.evalx import volumetric as port_metrics

SIDE = 40


def _masks():
    rng = np.random.default_rng(0)
    a = np.zeros((6, 24, 20), bool)
    b = np.zeros((6, 24, 20), bool)
    a[1:5, 4:16, 3:12] = True
    b[2:6, 6:20, 5:17] = True
    noisy = rng.random((6, 24, 20)) > 0.7
    far = np.zeros_like(a)
    far[5, 22:, 18:] = True
    empty = np.zeros_like(a)
    return {"overlap": (a, b), "noisy": (noisy, b), "disjoint": (a, far),
            "pred_only": (a, empty), "gt_only": (empty, b),
            "both_empty": (empty, empty), "same": (b, b)}


@pytest.mark.parametrize("case", list(_masks()))
def test_metrics_equal_jax(case):
    pred, gt = _masks()[case]
    for name in ("calculate_metric_percase", "calculate_dice_percase"):
        got = getattr(port_metrics, name)(pred, gt)
        want = getattr(jax_metrics, name)(pred, gt)
        assert got == want, (name, got, want)
    if pred.any() and gt.any():
        for name in ("dice_coefficient", "jaccard", "hd95", "assd"):
            assert (getattr(port_metrics, name)(pred, gt)
                    == getattr(jax_metrics, name)(pred, gt)), name


def test_metrics_empty_mask_rules():
    pred, gt = _masks()["overlap"]
    empty = np.zeros_like(pred)
    assert port_metrics.calculate_metric_percase(pred, empty) == (
        1.0, 0.0, 1.0, 0.0)
    assert port_metrics.calculate_metric_percase(empty, gt) == (
        0.0, 0.0, 0.0, 0.0)
    assert port_metrics.calculate_dice_percase(pred, empty) == 1.0
    assert port_metrics.calculate_dice_percase(empty, empty) == 0.0


def test_synapse_label_remap_equals_jax():
    lab = np.random.default_rng(1).integers(0, 14, (SIDE, SIDE))
    np.testing.assert_array_equal(port_volumes.remap_synapse_labels(lab),
                                  jax_volumes.remap_synapse_labels(lab))


def _slice(rng, low=0.0):
    return ((rng.random((SIDE, SIDE + 8)) + low).astype(np.float32),
            rng.integers(0, 14, (SIDE, SIDE + 8)).astype(np.uint8))


@pytest.mark.parametrize("kind", ["synapse", "acdc"])
def test_augmenters_equal_jax_for_a_seed(kind):
    cls = {"synapse": "RandomGenerator", "acdc": "RandomGeneratorACDC"}[kind]
    port = getattr(port_volumes, cls)((32, 32), seed=5)
    ref = getattr(jax_volumes, cls)((32, 32), seed=5)
    rng = np.random.default_rng(2)
    for _ in range(12):  # enough draws to take every branch
        image, label = _slice(rng, low=-1.0 if kind == "acdc" else 0.0)
        if kind == "acdc":  # a zero border the crop removes
            image[:3] = -1.0
        gi, gl = port(image, label)
        wi, wl = ref(image, label)
        assert gi.dtype == wi.dtype == np.float32 and gl.dtype == np.int32
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


@pytest.fixture(scope="module")
def synthetic_sets(tmp_path_factory):
    """Synapse train .npz slices and test .npy.h5 volumes, ACDC train/valid
    .npz slices and test .npz volumes, with their list files."""
    root = tmp_path_factory.mktemp("volumes")
    rng = np.random.default_rng(3)
    syn, acdc, lists = root / "synapse", root / "acdc", root / "lists"
    for d in (syn, acdc / "train", acdc / "valid", lists):
        d.mkdir(parents=True)
    names = {k: [] for k in ("train", "test_vol", "acdc_train", "valid",
                             "test")}
    for i in range(3):
        image, label = _slice(rng)
        np.savez(syn / f"case{i}_slice000.npz", image=image, label=label)
        names["train"].append(f"case{i}_slice000")
        with h5py.File(syn / f"case{i}.npy.h5", "w") as f:
            f["image"] = rng.random((4, SIDE, SIDE)).astype(np.float32)
            f["label"] = rng.integers(0, 14, (4, SIDE, SIDE)).astype(np.uint8)
        names["test_vol"].append(f"case{i}")
        for split in ("train", "valid"):
            image, label = _slice(rng, low=-1.0)
            np.savez(acdc / split / f"p{i}_{split}.npz", img=image,
                     label=label % 4)
            names["acdc_train" if split == "train" else "valid"].append(
                f"p{i}_{split}.npz")
        np.savez(acdc / f"p{i}_vol.npz",
                 img=rng.random((3, SIDE, SIDE)).astype(np.float32),
                 label=rng.integers(0, 4, (3, SIDE, SIDE)))
        names["test"].append(f"p{i}_vol.npz")
    (lists / "syn").mkdir()
    (lists / "acdc").mkdir()
    for split in ("train", "test_vol"):
        (lists / "syn" / f"{split}.txt").write_text(
            "\n".join(names[split]) + "\n")
    for split, key in (("train", "acdc_train"), ("valid", "valid"),
                       ("test", "test")):
        (lists / "acdc" / f"{split}.txt").write_text(
            "\n".join(names[key]) + "\n")
    return root


def _dataset_pairs(root, split, kind, transform, raw=False):
    if kind == "synapse":
        make = lambda mod, tf: mod.SynapseDataset(
            str(root / "synapse"), str(root / "lists" / "syn"), split,
            nclass=9, transform=tf, raw=raw)
        gen = "RandomGenerator"
    else:
        make = lambda mod, tf: mod.ACDCDataset(
            str(root / "acdc"), str(root / "lists" / "acdc"), split,
            transform=tf, raw=raw)
        gen = "RandomGeneratorACDC"
    tf = lambda mod: (getattr(mod, gen)((32, 32), seed=7) if transform
                      else None)
    return make(port_volumes, tf(port_volumes)), make(jax_volumes,
                                                      tf(jax_volumes))


@pytest.mark.parametrize("kind,split,transform,raw", [
    ("synapse", "train", True, False), ("synapse", "train", False, False),
    ("synapse", "train", False, True), ("synapse", "test_vol", False, False),
    ("acdc", "train", True, False), ("acdc", "train", False, True),
    ("acdc", "valid", False, False), ("acdc", "test", False, False)],
    ids=["synapse_train_aug", "synapse_train", "synapse_raw",
         "synapse_test_h5", "acdc_train_aug", "acdc_raw", "acdc_valid",
         "acdc_test"])
def test_datasets_equal_jax(synthetic_sets, kind, split, transform, raw):
    port, ref = _dataset_pairs(synthetic_sets, split, kind, transform, raw)
    assert len(port) == len(ref) == 3
    for i in range(3):
        assert port.case_name(i) == ref.case_name(i)
        (gi, gl), (wi, wl) = port[i], ref[i]
        assert gi.dtype == wi.dtype == np.float32
        assert gl.dtype == wl.dtype == np.int32
        if wi.ndim == 3 and wi.shape[-1] == 1:  # a slice: channel-first here
            assert gi.shape == (1, *wi.shape[:2])
            wi = wi[..., 0][None]
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    if kind == "synapse" and split != "test_vol":
        assert int(gl.max()) <= 8  # 9 classes: the 13 organs remapped

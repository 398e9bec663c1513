"""The volume zoom (``pranet2_tpu_torch/ops/volume_zoom.py``) against
``scipy.ndimage.zoom``, slice by slice, on the CPU: the plain versions
that the CPU runs and that the card's kernel is held to.

* ``zoom_slices`` (order 3) at a CT slice to EMCAD's patch, ACDC-like
  sizes zoomed up, a small volume down, a slice that already fits and an
  odd pair; float32 and float64 volumes: at least 99.99% of the pixels
  bit-equal to scipy's, the rest within one float32 ulp.
* ``zoom_labels`` (order 0) back to those sizes, exactly, with a pair
  where scipy's constant mode gives cval on the last row and column.
* The banded operator, its blocks as the kernel reads them, the wrappers'
  refusals; ``zoom_to_patch``.

The tests marked ``cuda`` hold the kernel to the plain version on a card
and the predictor's path through it, and skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_port_volume_zoom.py
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import zoom

from pranet2_tpu_torch.ops import volume_zoom
from pranet2_tpu_torch.train.multiclass import zoom_to_patch

# (x, y) -> (ph, pw): a Synapse CT slice to EMCAD's patch, an ACDC-like
# slice zoomed up, a small volume down, one that fits, an odd pair
SLICE_PAIRS = [((512, 512), (224, 224)), ((154, 210), (224, 224)),
               ((96, 96), (64, 64)), ((224, 224), (224, 224)),
               ((333, 287), (224, 160))]
# (ph, pw) -> (x, y): the labels back; 224 -> 147 x 200 takes scipy's cval
# on its last row and column
LABEL_PAIRS = [((224, 224), (512, 512)), ((224, 224), (154, 210)),
               ((64, 64), (96, 96)), ((224, 224), (147, 200))]


def _scipy_slices(volume, size):
    x, y = volume.shape[1:]
    return np.stack([zoom(s, (size[0] / x, size[1] / y), order=3)
                     for s in volume]).astype(np.float32)[:, None]


def _assert_near_scipy(got, want):
    """At least 99.99% bit-equal, the rest within one float32 ulp."""
    assert got.shape == want.shape and got.dtype == np.float32
    equal = got == want
    assert equal.mean() >= 0.9999, equal.mean()
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(got - want) <= ulp).all()


@pytest.mark.parametrize("shape,size", SLICE_PAIRS,
                         ids=lambda v: "x".join(map(str, v)))
def test_zoom_slices_matches_scipy(shape, size):
    v = np.random.default_rng(sum(shape)).random((2, *shape),
                                                  dtype=np.float32)
    got = volume_zoom.zoom_slices(torch.from_numpy(v), size)
    _assert_near_scipy(got.numpy(), _scipy_slices(v, size))


@pytest.mark.parametrize("shape,size", SLICE_PAIRS[:2],
                         ids=lambda v: "x".join(map(str, v)))
def test_zoom_slices_float64_volume_matches_scipy(shape, size):
    """A float64 volume read as its own values (HU-like, not rounded to
    float32 first), against scipy's zoom of the same float64 slices."""
    v = np.random.default_rng(7).normal(0.0, 300.0, (2, *shape))
    got = volume_zoom.zoom_slices(torch.from_numpy(v), size)
    _assert_near_scipy(got.numpy(), _scipy_slices(v, size))


@pytest.mark.parametrize("size,shape", LABEL_PAIRS,
                         ids=lambda v: "x".join(map(str, v)))
def test_zoom_labels_matches_scipy(size, shape):
    lab = np.random.default_rng(size[0] + shape[1]).integers(
        1, 9, (3, *size)).astype(np.int32)
    got = volume_zoom.zoom_labels(torch.from_numpy(lab), shape).numpy()
    want = np.stack([zoom(s, (shape[0] / size[0], shape[1] / size[1]),
                          order=0) for s in lab])
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if shape == (147, 200):  # scipy's cval, which no label here is
        assert not want[:, -1].any() and not want[:, :, -1].any()


def test_cubic_operator_is_banded_and_exact():
    """512 -> 224: 64 taps a row, each band inside the axis, scipy's zero
    row past the last input point; dense, the operator is scipy's
    zoom of an identity but for entries below ``BAND_TOL`` of their
    row's largest."""
    first, weights = volume_zoom.cubic_operator(512, 224)
    assert first.shape == (224,) and weights.shape == (224, 64)
    assert first.min() >= 0 and first.max() <= 512 - 64
    assert not weights[-1].any()
    dense = np.zeros((224, 512))
    for i in range(224):
        dense[i, first[i]:first[i] + 64] = weights[i]
    full = zoom(np.eye(512), (224 / 512, 1), order=3, output=np.float64)
    out = dense != full
    assert (dense[out] == 0).all()
    row_max = np.abs(full).max(axis=1, keepdims=True)
    assert (np.abs(full) <= volume_zoom.BAND_TOL * row_max)[out].all()
    np.testing.assert_array_equal(
        volume_zoom._dense(torch.device("cpu"), 512, 224).numpy(), dense)


@pytest.mark.parametrize("n,m", [(512, 224), (154, 224), (287, 160),
                                 (224, 224), (30, 7)])
def test_row_blocks_are_the_operator(n, m):
    """The kernel's first pass reads the operator by blocks of
    ``ROW_BLOCK`` rows, each over ``span`` input rows inside the axis:
    laid back in place, the blocks are the dense operator, and the last
    block's padding rows weigh nothing."""
    lo, table = volume_zoom.row_blocks(n, m)
    blocks, span, rows = table.shape
    assert rows == volume_zoom.ROW_BLOCK and blocks == -(-m // rows)
    assert lo.min() >= 0 and lo.max() + span <= n
    back = np.zeros((blocks * rows, n))
    for b in range(blocks):
        back[b * rows:(b + 1) * rows, lo[b]:lo[b] + span] = table[b].T
    np.testing.assert_array_equal(
        back[:m], volume_zoom._dense(torch.device("cpu"), n, m).numpy())
    assert not back[m:].any()


@pytest.mark.parametrize("fn,good", [
    (volume_zoom.zoom_slices, torch.zeros((2, 8, 8))),
    (volume_zoom.zoom_labels, torch.zeros((2, 8, 8), dtype=torch.int32))],
    ids=["slices", "labels"])
def test_wrappers_refuse_bad_inputs(fn, good):
    with pytest.raises(ValueError):
        fn(good[0], (4, 4))                        # not (D, H, W)
    with pytest.raises(ValueError):
        fn(good[:, :, :0], (4, 4))                 # empty
    with pytest.raises(ValueError):
        fn(good.transpose(1, 2), (4, 4))           # not contiguous
    with pytest.raises(ValueError):
        fn(good, (0, 4))                           # empty size
    with pytest.raises(ValueError):
        fn(good.to("meta"), (4, 4))                # neither CPU nor CUDA
    with pytest.raises(TypeError):
        fn(good.to(torch.float16), (4, 4))
    with pytest.raises(TypeError):
        fn(good.to(torch.int64), (4, 4))


def test_zoom_to_patch():
    """The predictor's order-3 zoom on the host: scipy's slices, and a
    float32 copy where they already fit."""
    v = np.random.default_rng(3).random((3, 40, 30), dtype=np.float32)
    _assert_near_scipy(zoom_to_patch(v, (24, 36)), _scipy_slices(v, (24, 36)))
    same = zoom_to_patch(v.astype(np.float64), (40, 30))
    assert same.dtype == np.float32 and same.shape == (3, 1, 40, 30)
    np.testing.assert_array_equal(same[:, 0], v)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU or interpret "
                    "mode (chip_smoke.py checks it on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,size", SLICE_PAIRS,
                         ids=lambda v: "x".join(map(str, v)))
def test_zoom_kernels_match_plain(cuda, shape, size, dtype):
    """The kernel against the plain version on the same card: every pixel
    within one float32 ulp (float64 sums in another order), the labels
    back equal."""
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    v = torch.rand((5, *shape), generator=g, device=cuda, dtype=dtype)
    before = volume_zoom.zoom_slices.launches
    got = volume_zoom.zoom_slices(v, size)
    torch.cuda.synchronize()
    assert volume_zoom.zoom_slices.launches == before + 1
    want = volume_zoom.zoom_slices_plain(v, size)
    top = torch.maximum(got.abs(), want.abs())
    ulp = torch.nextafter(top, torch.full_like(top, float("inf"))) - top
    assert ((got - want).abs() <= ulp).all()
    lab = torch.randint(0, 9, (5, *size), generator=g, device=cuda,
                        dtype=torch.int32)
    before = volume_zoom.zoom_labels.launches
    back = volume_zoom.zoom_labels(lab, shape)
    torch.cuda.synchronize()
    assert volume_zoom.zoom_labels.launches == before + 1
    assert torch.equal(back, volume_zoom.zoom_labels_plain(lab, shape))


@pytest.mark.cuda
def test_predictor_zooms_on_the_card(cuda, monkeypatch):
    """A CUDA model's predictor zooms through the kernels, one launch of
    each a volume, and calls no scipy zoom once the tables are built;
    its labels are the CPU model's."""
    from pranet2_tpu_torch import get_model
    from pranet2_tpu_torch.train.multiclass import make_slice_predictor

    model = get_model("emcad", device="cpu", num_classes=4,
                      encoder="resnet18",
                      generator=torch.Generator().manual_seed(0)).eval()
    vol = np.random.default_rng(1).random((5, 96, 80), dtype=np.float32)
    want = make_slice_predictor(model, (64, 64), "fg_only", 2)(vol)
    predict = make_slice_predictor(model.to(cuda), (64, 64), "fg_only", 2)
    predict(vol)  # the tables on the card
    monkeypatch.setattr(volume_zoom, "zoom", None)
    counts = volume_zoom.zoom_slices.launches, volume_zoom.zoom_labels.launches
    got = predict(vol)
    assert (volume_zoom.zoom_slices.launches,
            volume_zoom.zoom_labels.launches) == (counts[0] + 1,
                                                  counts[1] + 1)
    assert got.dtype == np.int32 and got.shape == vol.shape
    assert (got == want).mean() > 0.99

"""The served masks at native size (``ops.native_masks``) on the CPU: the
plain version against the host chain the predictor ran before it
(``resize_bilinear_np``, ``expit``, min-max, uint8), the packing, and the
CPU predictor's hand-back.  The CUDA kernel is held against the plain
version on a GPU by test_torch_port_kernels.py."""

import numpy as np
import pytest
import torch
from scipy.special import expit

from pranet2_tpu_torch import get_model
from pranet2_tpu_torch.ops import native_mask
from pranet2_tpu_torch.ops.resize import resize_bilinear_np
from pranet2_tpu_torch.serve import BinaryPredictor


def host_chain(logit: np.ndarray, hw) -> np.ndarray:
    """(S, S) float32 logits -> the uint8 mask at ``hw``, as the predictor's
    exact path computed it on the host."""
    x = expit(resize_bilinear_np(logit[None], hw)[0])
    x = (x - x.min()) / (x.max() - x.min() + 1e-8)
    return (x * 255).astype(np.uint8)


def _unpack(packed, offsets, sizes):
    flat = packed.numpy()
    return [flat[o:o + h * w].reshape(h, w) for o, (h, w) in zip(offsets,
                                                                 sizes)]


@pytest.mark.parametrize("side,sizes", [
    (64, [(120, 150), (200, 97)]),          # up along both sides
    (64, [(40, 80), (29, 33)]),             # down along H, and both
    (96, [(96, 96), (1, 1), (7, 300)]),     # the map's own size; a pixel
    (35, [(288, 384), (500, 574)]),         # ClinicDB's and CVC-300's sides
])
def test_plain_matches_the_host_chain(side, sizes):
    rng = np.random.default_rng(side + len(sizes))
    logits = (rng.standard_normal((len(sizes) + 1, 1, side, side)) * 4
              ).astype(np.float32)   # one padded slot at the end
    packed, offsets = native_mask.native_masks_plain(
        torch.from_numpy(logits), sizes)
    assert packed.dtype == torch.uint8 and packed.dim() == 1
    for got, lg, hw in zip(_unpack(packed, offsets, sizes), logits, sizes):
        want = host_chain(lg[0], hw)
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1, diff.max()
        assert (diff > 0).mean() <= 2e-3, (diff > 0).mean()


@pytest.mark.parametrize("sizes", [[(30, 40)], [(500, 574), (1, 1)]])
def test_constant_map_gives_zero_masks(sizes):
    """Min equals max: ``(x - min) / (0 + 1e-8)`` is 0 everywhere, as in
    the host chain."""
    logits = torch.full((2, 1, 16, 16), 3.5)
    packed, offsets = native_mask.native_masks_plain(logits, sizes)
    for got, hw in zip(_unpack(packed, offsets, sizes), sizes):
        assert not got.any()
        np.testing.assert_array_equal(got, host_chain(logits[0, 0].numpy(),
                                                      hw))


def test_offsets_are_aligned_and_disjoint():
    sizes = [(3, 5), (16, 1), (1, 1), (288, 384)]
    offsets, total = native_mask.mask_offsets(sizes)
    assert offsets[0] == 0
    ends = [o + h * w for o, (h, w) in zip(offsets, sizes)]
    assert all(o % native_mask.ALIGN == 0 for o in offsets)
    assert all(e <= o for e, o in zip(ends, offsets[1:]))
    assert ends[-1] <= total < ends[-1] + native_mask.ALIGN
    assert native_mask.mask_offsets([]) == ([], 0)


def test_plain_refuses_bad_inputs():
    x = torch.zeros((2, 1, 8, 8))
    with pytest.raises(ValueError):
        native_mask.native_masks(x, [(4, 4)] * 3)      # more than the batch
    with pytest.raises(ValueError):
        native_mask.native_masks(x[:, :, None], [(4, 4)])
    with pytest.raises(ValueError):
        native_mask.native_masks(x, [(0, 4)])
    with pytest.raises(TypeError):
        native_mask.native_masks(x.double(), [(4, 4)])


@pytest.mark.parametrize("where", [{"device": "cpu"},
                                   {"devices": ["cpu", "cpu"]}])
def test_predictor_masks_own_their_memory(where):
    """Six images at batch 4 (the second batch padded, its second replica
    empty when split in two): each mask is its own array at its image's
    size, no view of the batch's buffer or of another mask."""
    torch.manual_seed(0)
    sd = get_model("pranet_v2", device="cpu", num_class=1,
                   layers=(1, 1, 1, 1)).state_dict()
    pred = BinaryPredictor("pranet_v2", sd, batch_size=4, testsize=32,
                           host_workers=0, model_kwargs={"layers": (1, 1, 1, 1)},
                           **where)
    rng = np.random.default_rng(1)
    images = [(rng.random((20 + 9 * i, 45 - 4 * i, 3)) * 255).astype(np.uint8)
              for i in range(6)]
    masks = pred(images)
    pred.close()
    assert len(masks) == 6
    for m, im in zip(masks, images):
        assert m.shape == im.shape[:2] and m.dtype == np.uint8
        assert m.base is None and m.flags.owndata and m.flags.c_contiguous
    for i, a in enumerate(masks):
        assert not any(np.shares_memory(a, b) for b in masks[i + 1:])

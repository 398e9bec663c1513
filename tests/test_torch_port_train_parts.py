"""The parts of the port's binary training against the JAX package's, on the
CPU: the losses, the schedule and optimizer, the multi-scale rescale, the
training stem pool (fault F6), the metric suite and the loader's order.

Inputs are numpy from a seed; the port is NCHW, the JAX package NHWC.
Float64 comparisons run JAX under x64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pranet2_tpu.data.loader import BatchLoader as JaxBatchLoader
from pranet2_tpu.evalx import binary_metrics as jmetrics
from pranet2_tpu.losses import binary as jlosses
from pranet2_tpu.ops import pooling as jpooling
from pranet2_tpu.ops.resize import resize_bilinear as jax_resize
from pranet2_tpu.train import optim as joptim
from pranet2_tpu_torch import ops
from pranet2_tpu_torch.data import BatchLoader, DevicePrefetcher
from pranet2_tpu_torch.evalx import binary_metrics
from pranet2_tpu_torch.losses import binary as losses
from pranet2_tpu_torch.models.backbones.res2net import Res2Net
from pranet2_tpu_torch.train import optim


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs files in parallel workers, and
    each worker's default of one thread a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def x64():
    with jax.enable_x64(True):
        yield


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _maps(seed, binary_mask, shape=(2, 40, 36, 1)):
    """Logits fg and bg, and a mask (binary, or soft as a bilinear resize
    of a binary mask gives), float64 NHWC."""
    rng = np.random.default_rng(seed)
    pred, pred_bg = (3 * rng.standard_normal(shape) for _ in range(2))
    mask = rng.random(shape)
    if binary_mask:
        mask = (mask > 0.6).astype(np.float64)
    return pred, pred_bg, mask


@pytest.mark.parametrize("k", [31, 5])
def test_avg_pool_same_matches_jax(x64, k):
    _, _, mask = _maps(0, False)
    want = jpooling.avg_pool_same(jnp.asarray(mask), k)
    got = ops.avg_pool_same(_nchw(mask), k)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("binary_mask", [True, False],
                         ids=["binary", "soft"])
def test_structure_losses_match_jax(x64, binary_mask):
    """structure_loss (with and without a given weight), _multi and _v1 in
    float64, values and the gradient in the logits."""
    pred, pred_bg, mask = _maps(1, binary_mask)
    bg = 1.0 - mask
    jp, jb, jm, jbg = map(jnp.asarray, (pred, pred_bg, mask, bg))
    tp, tb, tm, tbg = (_nchw(a).requires_grad_(i < 2)
                       for i, a in enumerate((pred, pred_bg, mask, bg)))
    weit = jlosses._boundary_weight(jm)
    np.testing.assert_allclose(_nhwc(losses._boundary_weight(tm)),
                               np.asarray(weit), rtol=1e-12, atol=1e-14)
    cases = [
        (lambda a, b: jlosses.structure_loss(a, b, jm, jbg),
         lambda a, b: losses.structure_loss(a, b, tm, tbg)),
        (lambda a, b: jlosses.structure_loss(a, b, jm, jbg, weit=weit),
         lambda a, b: losses.structure_loss(
             a, b, tm, tbg, weit=losses._boundary_weight(tm))),
        (lambda a, b: jlosses.structure_loss_multi([a, 2 * a], [b, -b], jm,
                                                   jbg),
         lambda a, b: losses.structure_loss_multi([a, 2 * a], [b, -b], tm,
                                                  tbg)),
        (lambda a, b: jlosses.structure_loss_v1(a, jm) + 0 * jnp.sum(b),
         lambda a, b: losses.structure_loss_v1(a, tm) + 0 * b.sum()),
    ]
    for jfn, tfn in cases:
        want, (ga, gb) = jax.value_and_grad(jfn, argnums=(0, 1))(jp, jb)
        tp.grad = tb.grad = None
        got = tfn(tp, tb)
        got.backward()
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-12)
        np.testing.assert_allclose(_nhwc(tp.grad), np.asarray(ga),
                                   rtol=1e-10, atol=1e-16)
        np.testing.assert_allclose(_nhwc(tb.grad), np.asarray(gb),
                                   rtol=1e-10, atol=1e-16)


def test_structure_loss_promotes_bf16_to_f32():
    pred, pred_bg, mask = _maps(2, True)
    t = [_nchw(a).float() for a in (pred, pred_bg, mask, 1.0 - mask)]
    want = losses.structure_loss(*(x.bfloat16().float() for x in t[:2]),
                                 *t[2:])
    got = losses.structure_loss(t[0].bfloat16(), t[1].bfloat16(), *t[2:])
    assert got.dtype == torch.float32
    assert got.item() == want.item()


def test_step_decay_schedule_matches_jax():
    port = optim.step_decay_schedule(1e-4, 0.1, 3, 5)
    ref = joptim.step_decay_schedule(1e-4, 0.1, 3, 5)
    for step in (0, 4, 5, 9, 10, 14, 15, 29, 30):
        np.testing.assert_allclose(port(step), ref(step), rtol=1e-15)
    assert port(9) == 1e-4 and port(10) == pytest.approx(1e-5)


def _adam_moments(state):
    """(mu, nu) trees of an optax chain's adam state."""
    for s in jax.tree_util.tree_leaves(
            state, is_leaf=lambda n: hasattr(n, "mu")):
        if hasattr(s, "mu"):
            return s.mu, s.nu
    raise AssertionError("no adam state")


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2], ids=["adam", "adamw"])
def test_optimizer_matches_optax(x64, weight_decay):
    """Three updates of a small tree through clip + Adam(W) with a step
    decay crossed at the second update, against the JAX package's optax
    chain: the parameters and the moments after each, and a parameter with
    no gradient as optax takes it, a zero gradient (left alone by Adam,
    decayed by AdamW)."""
    rng = np.random.default_rng(3)
    shapes = {"w": (3, 4), "b": (4,), "unused": (2,)}
    init = {k: rng.standard_normal(s) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s) * (0.2 if k == "b" else 2.0)
              for k, s in shapes.items()} for _ in range(3)]
    schedule_j = joptim.step_decay_schedule(1e-2, 0.1, 2, 1)
    tx = joptim.make_optimizer(schedule_j, clip_value=0.5,
                               weight_decay=weight_decay)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    opt = optim.make_optimizer(
        params.values(), optim.step_decay_schedule(1e-2, 0.1, 2, 1),
        clip_value=0.5, weight_decay=weight_decay)
    for g in grads:
        jg = {k: jnp.asarray(v if k != "unused" else np.zeros_like(v))
              for k, v in g.items()}
        updates, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = None if k == "unused" else torch.from_numpy(g[k].copy())
        opt.step()
        mu, nu = _adam_moments(jstate)
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-12,
                                       atol=1e-15, err_msg=k)
            if k == "unused" and not weight_decay:
                assert p.grad is None and not opt.inner.state[p]
                continue
            st = opt.inner.state[p]
            np.testing.assert_allclose(st["exp_avg"].numpy(),
                                       np.asarray(mu[k]), rtol=1e-12,
                                       atol=1e-18, err_msg=k)
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                       np.asarray(nu[k]), rtol=1e-12,
                                       atol=1e-18, err_msg=k)
    assert opt.count == 3
    # the clamp happened in place: no gradient left beyond +/-0.5
    assert all(p.grad is None or p.grad.abs().max() <= 0.5
               for p in params.values())


@pytest.mark.parametrize("size", [48, 80])
def test_multiscale_rescale_matches_jax(size):
    """The train step's rescale (bilinear, align_corners=True) of images and
    soft masks, 64 -> 48 and 64 -> 80.  float64: the same arithmetic.
    float32 (the recipe's type): ATen takes the source coordinate in
    float32 and JAX's interpolation matrices hold float64 weights cast
    once, so a weight may differ by about 63 * 2^-24 relative and the
    value by that times a neighbour difference (|x| < 6 here): 1e-4."""
    rng = np.random.default_rng(size)
    images = rng.standard_normal((2, 64, 64, 3))
    masks = rng.random((2, 64, 64, 1))
    for a in (images, masks):
        with jax.enable_x64(True):
            want = jax_resize(jnp.asarray(a), (size, size),
                              align_corners=True)
        got = ops.resize_bilinear(_nchw(a), (size, size), align_corners=True)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-12,
                                   atol=1e-13)
        a = a.astype(np.float32)
        want = jax_resize(jnp.asarray(a), (size, size), align_corners=True)
        got = ops.resize_bilinear(_nchw(a), (size, size), align_corners=True)
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                                   atol=1e-4)


TIES = np.array([[1, 1, 1, 0], [1, 1, 1, 0], [0, 0, 0, 0], [0, 0, 0, 0]],
                np.float32)


def _identity_bn1(model):
    """bn1 as the exact identity in eval: var + eps = 1, mean 0, scale 1."""
    bn = model.bn1
    with torch.no_grad():
        bn.running_var.fill_(1.0 - bn.eps)
    return model


def _stem_grad_port(z_nhwc, dtype):
    """The gradient of sum(stem_tail(z)) in z: the route the port trains
    on (autograd on; bn1 the identity, so ReLU and the pool remain)."""
    model = _identity_bn1(Res2Net(layers=(1, 1, 1, 1))).eval().to(dtype)
    model.bn1.float()
    z = _nchw(z_nhwc).to(dtype).requires_grad_()
    model.stem_tail(z).sum().backward()
    return _nhwc(z.grad.float())


def _stem_grad_jax(z_nhwc, dtype):
    return np.asarray(jax.grad(lambda z: jnp.sum(
        jpooling.max_pool(jax.nn.relu(z), 3, 2, 1)).astype(jnp.float32))(
        jnp.asarray(z_nhwc, dtype)).astype(jnp.float32))


def test_training_stem_pool_sends_tied_gradients_as_jax():
    """F6: the map [[1,1,1,0],[1,1,1,0],0,0] pooled 3x3/2 pad 1; each
    window's gradient goes to its first maximum, as JAX's reduce_window
    max sends it, not split over the ties as the plain ``ops.max_pool``
    (the kernel's yardstick, on no training route) would."""
    z = np.broadcast_to(TIES[:, :, None], (1, 4, 4, 64)).copy()
    want = np.zeros((4, 4), np.float32)
    want[:2, :2] = 1
    want = np.broadcast_to(want[:, :, None], (1, 4, 4, 64))
    np.testing.assert_array_equal(_stem_grad_jax(z, jnp.float32), want)
    np.testing.assert_array_equal(_stem_grad_port(z, torch.float32), want)
    t = _nchw(z).requires_grad_()
    ops.max_pool(t, 3, 2, 1).sum().backward()
    assert not np.array_equal(t.grad[0, 0].numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_stem_pool_grad_matches_jax_on_tied_maps(dtype):
    """F6 on maps with forced ties (values on a coarse grid, many equal
    within a window, negatives cut to tied zeros by the ReLU): the port's
    training-route gradient equals ``jax.grad`` of JAX's ``max_pool``."""
    rng = np.random.default_rng(6)
    z = (np.round(rng.standard_normal((2, 17, 16, 64)) * 2) / 2).astype(
        np.float32)
    tdt = getattr(torch, dtype)
    got = _stem_grad_port(z, tdt)
    want = _stem_grad_jax(z, getattr(jnp, dtype))
    assert (want == 1).sum() > 0 and (want > 1).sum() > 0
    np.testing.assert_array_equal(got, want)


def test_binary_metrics_match_jax():
    """The port's copy of the metric suite against the JAX package's on
    random maps: per image and aggregated."""
    rng = np.random.default_rng(7)
    per_port, per_jax = [], []
    for i in range(4):
        h, w = 30 + i, 41 - i
        pred = (rng.random((h, w)) * 255).astype(np.uint8)
        gt = (rng.random((h, w)) > 0.7).astype(np.float32)
        if i == 3:
            gt[:] = 0  # an empty GT takes its own branches
        per_port.append(binary_metrics.binary_image_metrics(pred, gt))
        per_jax.append(jmetrics.binary_image_metrics(pred, gt))
        for k, v in per_jax[-1].items():
            np.testing.assert_array_equal(per_port[-1][k], v, err_msg=k)
    got = binary_metrics.aggregate_dataset_metrics(per_port)
    want = jmetrics.aggregate_dataset_metrics(per_jax)
    assert set(got) == set(binary_metrics.BINARY_METRIC_NAMES) == set(want)
    assert got == want


class _Indexed:
    def __len__(self):
        return 21

    def __getitem__(self, i):
        return (np.full((2, 3, 1), i, np.float32), np.array([i]))


def test_batch_loader_visits_jax_order():
    """The shuffle draws from numpy's default_rng(seed) as JAX's loader
    does: the same batches over two epochs; the CPU prefetcher passes
    them through as tensors."""
    port, ref = BatchLoader(_Indexed(), 4, seed=5), JaxBatchLoader(
        _Indexed(), 4, seed=5)
    assert len(port) == len(ref) == 5
    for _ in range(2):
        for (a, i), (b, j) in zip(DevicePrefetcher(port, device="cpu"), ref):
            assert isinstance(a, torch.Tensor) and a.shape == (4, 2, 3, 1)
            np.testing.assert_array_equal(a.numpy(), b)
            np.testing.assert_array_equal(i.numpy(), j)

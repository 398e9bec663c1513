"""The port's multiclass losses and training extras against the JAX
package's, on the CPU.

``mutation_loss`` is held in float64 (JAX under x64) within 1e-10
relative, with its gradient in every map against ``jax.grad``, for the
three supervision modes, dual and single; the helpers, ``focal_loss`` and
``poly_lr_schedule`` likewise; ``upsample_nearest`` exactly.  Inputs are
numpy from a seed: NCHW on the port's side, NHWC on JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pranet2_tpu.losses import multiclass as jax_mc
from pranet2_tpu.ops import upsample_nearest as jax_upsample_nearest
from pranet2_tpu.train import extras as jax_extras
from pranet2_tpu_torch import ops
from pranet2_tpu_torch.losses import multiclass as port_mc
from pranet2_tpu_torch.train import extras as port_extras

N, C, H, W = 2, 4, 6, 5
TOL = 1e-10   # float64 on both sides: summation order only


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _maps(seed, k=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((N, H, W, C)) * 3 for _ in range(k)]


def _labels(seed=9):
    return np.random.default_rng(seed).integers(0, C, (N, H, W))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


@pytest.mark.parametrize("dual", [True, False], ids=["dual", "single"])
@pytest.mark.parametrize("supervision",
                         ["mutation", "deep_supervision", "last_layer"])
def test_mutation_loss_and_grad_match_jax_f64(supervision, dual):
    fg, bg, lab = _maps(1), _maps(2), _labels()
    with jax.enable_x64(True):
        def jax_loss(fg, bg):
            return jax_mc.mutation_loss(fg, jnp.asarray(lab), C,
                                        bg if dual else None,
                                        supervision=supervision)

        want, (g_fg, g_bg) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
            [jnp.asarray(a) for a in fg], [jnp.asarray(a) for a in bg])
        want, g_fg, g_bg = (float(want), [np.asarray(g) for g in g_fg],
                            [np.asarray(g) for g in g_bg])
    t_fg = [_nchw(a).requires_grad_() for a in fg]
    t_bg = [_nchw(a).requires_grad_() for a in bg]
    got = port_mc.mutation_loss(t_fg, torch.from_numpy(lab), C,
                                t_bg if dual else None,
                                supervision=supervision)
    assert got.dtype == torch.float64
    got.backward()
    _close(got.item(), want)
    for t, g in zip(t_fg, g_fg):
        _close(_nhwc(t.grad), g)
    for t, g in zip(t_bg, g_bg):
        if dual:
            _close(_nhwc(t.grad), g)
        else:
            assert t.grad is None and not np.any(g)


def test_mutation_loss_orders_and_counts_subsets():
    assert port_mc.powerset([0, 1, 2]) == jax_mc.powerset([0, 1, 2])
    for mode in ("mutation", "deep_supervision", "last_layer"):
        assert (port_mc.supervision_subsets(4, mode)
                == jax_mc.supervision_subsets(4, mode))
    assert len(port_mc.supervision_subsets(4)) == 15
    with pytest.raises(ValueError):
        port_mc.supervision_subsets(4, "every_other")


def test_mutation_loss_promotes_bf16_to_f32():
    fg = [_nchw(a).to(torch.bfloat16) for a in _maps(3)]
    bg = [_nchw(a).to(torch.bfloat16) for a in _maps(4)]
    lab = torch.from_numpy(_labels())
    got = port_mc.mutation_loss(fg, lab, C, bg)
    want = port_mc.mutation_loss([t.float() for t in fg], lab, C,
                                 [t.float() for t in bg])
    assert got.dtype == torch.float32 and got.item() == want.item()


@pytest.mark.parametrize("name", ["softmax_ce_loss", "dice_loss",
                                  "bce_with_logits", "one_hot_bg"])
def test_loss_helpers_match_jax_f64(name):
    logits, lab = _maps(5, 1)[0], _labels(6)
    target = (np.random.default_rng(7).random((N, H, W, C)) > 0.5) * 1.0
    with jax.enable_x64(True):
        jl, jlab = jnp.asarray(logits), jnp.asarray(lab)
        want = {"softmax_ce_loss": lambda: jax_mc.softmax_ce_loss(jl, jlab),
                "dice_loss": lambda: jax_mc.dice_loss(jl, jlab, C),
                "bce_with_logits": lambda: jax_mc.bce_with_logits(
                    jl, jnp.asarray(target)),
                "one_hot_bg": lambda: jax_mc.one_hot_bg(jlab, C,
                                                        jnp.float64)}[name]()
        want = np.asarray(want)
    tl, tlab = _nchw(logits), torch.from_numpy(lab)
    got = {"softmax_ce_loss": lambda: port_mc.softmax_ce_loss(tl, tlab),
           "dice_loss": lambda: port_mc.dice_loss(tl, tlab, C),
           "bce_with_logits": lambda: port_mc.bce_with_logits(
               tl, _nchw(target)),
           "one_hot_bg": lambda: port_mc.one_hot_bg(tlab, C,
                                                    torch.float64)}[name]()
    assert got.dtype == torch.float64
    if name == "one_hot_bg":
        np.testing.assert_array_equal(_nhwc(got), want)
    else:
        _close(got.item(), want)


def test_dice_loss_without_softmax_matches_jax():
    probs = np.random.default_rng(8).random((N, H, W, C))
    lab = _labels(10)
    with jax.enable_x64(True):
        want = float(jax_mc.dice_loss(jnp.asarray(probs), jnp.asarray(lab),
                                      C, softmax=False))
    got = port_mc.dice_loss(_nchw(probs), torch.from_numpy(lab), C,
                            softmax=False)
    _close(got.item(), want)


@pytest.mark.parametrize("weighted", [False, True])
def test_focal_loss_matches_jax(weighted):
    logits, lab = _maps(11, 1)[0].astype(np.float32), _labels(12)
    weight = np.linspace(0.5, 2.0, C).astype(np.float32)
    want = float(jax_extras.focal_loss(
        jnp.asarray(logits), jnp.asarray(lab), 2.0,
        jnp.asarray(weight) if weighted else None))
    got = port_extras.focal_loss(_nchw(logits), torch.from_numpy(lab), 2.0,
                                 torch.from_numpy(weight) if weighted
                                 else None)
    assert got.dtype == torch.float32
    _close(got.item(), want, 1e-6)


def test_poly_lr_schedule_matches_jax():
    """JAX under x64: the port's schedule is Python floats."""
    want = jax_extras.poly_lr_schedule(1e-2, 100)
    got = port_extras.poly_lr_schedule(1e-2, 100)
    with jax.enable_x64(True):
        for step in (0, 1, 37, 99, 100, 150):
            _close(got(step), float(want(step)), 1e-14)
    assert got(100) == 0.0 == got(150)


@pytest.mark.parametrize("scale", [2, 3])
def test_upsample_nearest_is_jax_exactly(scale):
    x = np.random.default_rng(13).standard_normal((2, 5, 7, 3)).astype(
        np.float32)
    want = np.asarray(jax_upsample_nearest(jnp.asarray(x), scale))
    got = ops.upsample_nearest(_nchw(x), scale)
    assert got.shape == (2, 3, 5 * scale, 7 * scale) and got.is_contiguous()
    np.testing.assert_array_equal(_nhwc(got), want)

"""The port's training routes and gradients, on the CPU.

* A PVTv2 and a Res2Net in ``.train()`` call none of the forward-only
  kernel wrappers (the JAX package trains on its module chains,
  ``pranet2_tpu/models/backbones/pvtv2.py:445-464``,
  ``res2net.py:317,350``), and a backward reaches the first convolution.
* The DSRA gate's gradient: ``gradcheck`` in float64, and against
  ``jax.vjp`` of the JAX gate (its custom VJP) under x64.
* The gate's and LayerNorm's plain math in float64 against JAX under x64.

Inputs are numpy from a seed; the port is NCHW, the JAX package NHWC.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pranet2_tpu.ops import dsra as jdsra
from pranet2_tpu_torch.models.backbones import pvtv2, res2net
from pranet2_tpu_torch.nn import LayerNorm, init_weights_, set_compute_dtype
from pranet2_tpu_torch.ops import dsra

PVT_KERNELS = ("mlp_block", "sra_attention", "sra_block", "pvt_block")


def _record(monkeypatch, module, names, calls, refuse):
    """Replace ``module``'s ``names`` with wrappers that note each call in
    ``calls`` and then raise (``refuse``) or call the original."""
    for name in names:
        orig = getattr(module, name)

        def wrapped(*a, _name=name, _orig=orig, **kw):
            calls.append(_name)
            if refuse:
                raise AssertionError(f"{_name} called in training")
            return _orig(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("kw", [{}, {"attn_impl": "v2"},
                                {"blockfuse": True}],
                         ids=["v1", "attn_impl_v2", "blockfuse"])
def test_pvt_trains_on_the_module_chain(monkeypatch, kw):
    """A bf16 PVTv2 of depth 1 a stage: eval reaches the kernel wrappers,
    ``.train()`` none of them, and its backward reaches the first patch
    embed."""
    g = torch.Generator().manual_seed(0)
    model = pvtv2.PVTv2(embed_dims=(32, 64, 64, 64), depths=(1, 1, 1, 1),
                        num_heads=(1, 2, 2, 2), mlp_ratios=(2, 2, 2, 2),
                        **kw)
    model = set_compute_dtype(init_weights_(model, g), torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 3, 32, 32)).astype(np.float32)).bfloat16()
    calls = []
    with monkeypatch.context() as m:
        _record(m, pvtv2, PVT_KERNELS, calls, refuse=False)
        with torch.no_grad():
            model.eval()(x)
    assert calls, "the eval forward reached no kernel wrapper"
    _record(monkeypatch, pvtv2, PVT_KERNELS, calls := [], refuse=True)
    outs = model.train()(x)
    sum(o.float().square().mean() for o in outs).backward()
    assert not calls
    grad = model.patch_embed1.proj.weight.grad
    assert grad is not None and bool(torch.isfinite(grad).all())
    assert grad.abs().max().item() > 0


def test_res2net_trains_without_the_maxpool_kernel(monkeypatch):
    """Res2Net-v1b of depth 1 a layer: eval calls the stem kernel's
    wrapper (bn1, ReLU and the maxpool), ``.train()`` the plain pooling,
    and its backward reaches ``conv1``."""
    g = torch.Generator().manual_seed(1)
    model = init_weights_(res2net.Res2Net(layers=(1, 1, 1, 1)), g)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, 32, 32)).astype(np.float32))
    calls = []
    with monkeypatch.context() as m:
        _record(m, res2net, ("stem_pool",), calls, refuse=False)
        with torch.no_grad():
            model.eval()(x)
    assert calls == ["stem_pool"]
    _record(monkeypatch, res2net, ("stem_pool",), calls := [],
            refuse=True)
    sum(o.square().mean() for o in model.train()(x)).backward()
    assert not calls
    grad = model.conv1[0].weight.grad
    assert grad is not None and bool(torch.isfinite(grad).all())
    assert grad.abs().max().item() > 0


def _gate_inputs(seed, shape=(2, 3, 4, 5)):
    """fg, crop_fg, crop_bg and the output gradient, float64 NHWC numpy."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(4)]


def _nchw(a):
    return torch.from_numpy(a.transpose(0, 3, 1, 2).copy())


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("use_softmax", [True, False])
def test_dsra_gate_gradcheck_f64(use_softmax):
    ins = [_nchw(a).requires_grad_() for a in _gate_inputs(2)[:3]]
    assert torch.autograd.gradcheck(
        lambda *t: dsra.dsra_gate(*t, use_softmax), ins)


@pytest.fixture
def x64():
    with jax.enable_x64(True):
        yield


@pytest.mark.parametrize("use_softmax", [True, False])
def test_dsra_gate_grad_matches_jax_vjp(x64, use_softmax):
    """float64: the port's gradient in all three inputs against ``jax.vjp``
    of the JAX package's Pallas gate (interpreted off a TPU; backward by
    its custom VJP through the XLA math)."""
    *ins, cot = _gate_inputs(3)
    want, vjp = jax.vjp(
        lambda a, b, c: jdsra.dsra_gate_pallas(a, b, c, use_softmax),
        *map(jnp.asarray, ins))
    want_grads = vjp(jnp.asarray(cot))
    ts = [_nchw(a).requires_grad_() for a in ins]
    got = dsra.dsra_gate(*ts, use_softmax)
    got.backward(_nchw(cot))
    assert got.dtype == torch.float64 and want.dtype == jnp.float64
    # the Pallas forward takes its softmax in float32 (pranet2_tpu/ops/
    # dsra.py:73), the port's in float64: a float32 rounding apart
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # the gradients: float64 both sides, the same math in another order
    for t, w in zip(ts, want_grads):
        np.testing.assert_allclose(_nhwc(t.grad), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)


def test_dsra_gate_plain_and_layer_norm_f64_match_jax(x64):
    """The plain gate and LayerNorm keep float64 inputs in float64, as the
    JAX package computes under x64; a float32 cast would miss by ~1e-7."""
    fg, cf, cb, _ = _gate_inputs(4)
    want = jdsra.dsra_gate(*map(jnp.asarray, (fg, cf, cb)))
    got = dsra.dsra_gate_plain(_nchw(fg), _nchw(cf), _nchw(cb))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    rng = np.random.default_rng(5)
    x = 3.0 + rng.standard_normal((2, 3, 16))
    w = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    b = (0.1 * rng.standard_normal(16)).astype(np.float32)
    jln = fnn.LayerNorm(epsilon=1e-6, dtype=jnp.float64,
                        param_dtype=jnp.float32)
    want = jln.apply({"params": {"scale": jnp.asarray(w),
                                 "bias": jnp.asarray(b)}}, jnp.asarray(x))
    ln = LayerNorm(16, eps=1e-6)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
        got = ln(torch.from_numpy(x))
    assert got.dtype == torch.float64 and want.dtype == jnp.float64
    # E[x^2] - mu^2 at |x| ~ 3 loses about 4 bits in float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)

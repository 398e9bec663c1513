"""PVT-PraNet-V2 training in the port, on the CPU: stochastic depth (drop
path) and one train step against the JAX package's.

* Drop path is the identity in eval and at rate 0, and leaves the
  ``state_dict`` alone; at rate 0.5 it drops about half the samples and
  scales the others by 1/keep; PVTv2's rates ramp linearly to
  ``drop_path_rate`` (0.1 by default, ``pranet2_tpu/models/backbones/
  pvtv2.py:424,469``); the trainer's generator repeats a step's draws.
* One float64 train step of a PVTv2 of depth 1 a stage at drop-path rate 0
  against JAX's: the loss and every gradient.  JAX's ``fold_in(key(0), step)`` draws cannot be
  matched bit for bit, hence rate 0 here and statistics above.  JAX's
  attention, ``jax.nn.dot_product_attention``, takes its logits and softmax
  in float32 even for float64 inputs (4e-8 relative on the features); the
  test swaps in the same attention in float64, so that the comparison holds
  the semantics at float64's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pranet2_tpu.models.backbones import pvtv2 as jpvtv2
from pranet2_tpu_torch import get_model
from pranet2_tpu_torch.models.backbones import pvtv2
from pranet2_tpu_torch.nn import DropPath, drop_path, init_weights_
from pranet2_tpu_torch.train import TrainState, make_optimizer
from pranet2_tpu_torch.train.binary import make_train_step
from pranet2_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_pranet import random_variables

SIZE, BATCH = 64, 2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs files in parallel workers, and
    each worker's default of one thread a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _small_pvt(rate):
    g = torch.Generator().manual_seed(0)
    return init_weights_(pvtv2.PVTv2(
        embed_dims=(16, 32, 32, 32), depths=(2, 1, 1, 2),
        num_heads=(1, 2, 2, 2), mlp_ratios=(2, 2, 2, 2),
        drop_path_rate=rate), g)


def test_drop_path_ramp_and_state_dict():
    model = _small_pvt(0.1)
    rates = [m.rate for m in model.modules() if isinstance(m, DropPath)]
    np.testing.assert_allclose(rates, [0.1 * i / 5 for i in range(6)])
    assert model.state_dict().keys() == _small_pvt(0.0).state_dict().keys()


def test_drop_path_is_identity_in_eval_and_at_rate_0():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 3, 32, 32)).astype(np.float32))
    ref = _small_pvt(0.0)
    model = _small_pvt(0.5)
    model.load_state_dict(ref.state_dict())
    want = ref.eval()(x)
    for m in model.modules():
        if isinstance(m, DropPath):
            m.generator = torch.Generator().manual_seed(1)
    got = model.eval()(x)  # autograd on: the module chain, drop path idle
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    x.requires_grad_()
    assert drop_path(x, 0.0, True) is x and drop_path(x, 0.5, False) is x


def test_drop_path_rate_half_drops_half_and_rescales():
    """Per sample: about half the samples zeroed (4000 samples, within 4
    standard deviations of 0.5), the others scaled by 1/keep = 2; the same
    generator state repeats the draws, another seed does not."""
    x = torch.ones((4000, 3, 2))
    g = torch.Generator().manual_seed(3)
    out = drop_path(x, 0.5, True, g)
    per_sample = out.reshape(4000, -1)
    assert bool((per_sample == per_sample[:, :1]).all())
    kept = per_sample[:, 0]
    assert set(kept.unique().tolist()) == {0.0, 2.0}
    share = (kept == 0).float().mean().item()
    assert abs(share - 0.5) < 4 * (0.25 / 4000) ** 0.5
    again = drop_path(x, 0.5, True, torch.Generator().manual_seed(3))
    other = drop_path(x, 0.5, True, torch.Generator().manual_seed(4))
    assert torch.equal(out, again) and not torch.equal(out, other)


def _attention_f64(q, k, v):
    """``jax.nn.dot_product_attention`` of (B, T, N, H) q, k, v (no mask,
    scale 1/sqrt(H)) in the inputs' type."""
    s = jnp.einsum("btnh,bsnh->bnts", q, k) / jnp.sqrt(q.shape[-1]).astype(
        q.dtype)
    return jnp.einsum("bnts,bsnh->btnh", jax.nn.softmax(s, axis=-1), v)


@pytest.fixture
def reduced_b2(monkeypatch):
    """The port's PVTv2-b2 cut to one block a stage."""
    monkeypatch.setitem(pvtv2.PVT_CONFIGS, "b2",
                        {**pvtv2.PVT_CONFIGS["b2"], "depths": (1, 1, 1, 1)})


def test_train_step_seeds_drop_path_by_step(reduced_b2):
    """The train step draws every drop-path mask from one generator seeded
    by its seed and the state's step: the same step number repeats the
    masks, another step draws others (the learning rate is 0, so only the
    masks can differ)."""
    model = get_model("pvt_pranet_v2", device="cpu", num_class=1,
                      drop_path_rate=0.5)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 3, 32, 32)).astype(
        np.float32))
    gts = torch.from_numpy((rng.random((2, 1, 32, 32)) > 0.5).astype(
        np.float32))
    step = make_train_step(model, target_size=32, rescale=False, seed=5)
    seen = []
    model.backbone.block4[0].drop_path.register_forward_hook(
        lambda m, a, o: seen.append(o.detach().clone()))

    def masks(n):
        seen.clear()
        state = TrainState(model, make_optimizer(model.parameters(),
                                                         0.0))
        state.step = n
        step(state, x, gts)
        return list(seen)

    first, again, other = masks(7), masks(7), masks(8)
    gens = [m.generator for m in model.modules()
            if isinstance(m, DropPath) and m.rate > 0]
    assert gens[0] is not None and all(g is gens[0] for g in gens)
    assert len(first) == 2
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert not all(torch.equal(a, b) for a, b in zip(first, other))


def _backbone_state_dict(params):
    """A bare PVTv2's flax params -> its torch state_dict (the converter
    names a backbone under PraNet's ``backbone`` prefix)."""
    sd = state_dict_from_jax({"params": {"backbone": params}})
    return {k.removeprefix("backbone."): t for k, t in sd.items()}


def test_pvt_train_step_at_rate_0_matches_jax(monkeypatch):
    """A PVTv2 of depth 1 a stage (the widths of
    ``tests/test_torch_port_training.py``) in train mode at drop-path rate
    0, float64: a loss over its four stage maps and every gradient against
    ``jax.value_and_grad`` of the JAX package's PVTv2."""
    monkeypatch.setattr(jax.nn, "dot_product_attention", _attention_f64)
    cfg = dict(embed_dims=(32, 64, 64, 64), depths=(1, 1, 1, 1),
               num_heads=(1, 2, 2, 2), mlp_ratios=(2, 2, 2, 2))
    x = np.random.default_rng(9).standard_normal((BATCH, SIZE, SIZE, 3))
    with jax.enable_x64(True):
        jmodel = jpvtv2.PVTv2(**cfg, drop_path_rate=0.0)
        v = jax.tree.map(lambda a: np.array(a, np.float64), random_variables(
            jmodel, jnp.zeros((1, SIZE, SIZE, 3), jnp.float32), seed=2))

        def loss_fn(params, xj):
            outs = jmodel.apply({"params": params}, xj, True,
                                rngs={"dropout": jax.random.key(0)})
            return sum(jnp.mean(o * o) + jnp.mean(o) for o in outs)

        want, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
            jax.tree.map(jnp.asarray, v["params"]), jnp.asarray(x))
        grads = _backbone_state_dict(jax.tree.map(np.array, jgrads))

    model = pvtv2.PVTv2(**cfg, drop_path_rate=0.0).double()
    model.load_state_dict(_backbone_state_dict(v["params"]))
    outs = model.train()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    loss = sum((o * o).mean() + o.mean() for o in outs)
    loss.backward()
    assert abs(loss.item() - float(want)) <= 1e-9 * abs(float(want))
    named = dict(model.named_parameters())
    assert named.keys() == grads.keys()
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), grads[k].numpy(),
                                   atol=1e-8, rtol=1e-6, err_msg=k)

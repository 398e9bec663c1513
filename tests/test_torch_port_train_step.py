"""One train step of the port's PraNet-V2 against the JAX package's, on the
CPU, in float64: full depth, 64 x 64, batch 2.

Mirrors ``tests/test_train_parity.py:124-182`` with the JAX package as the
reference: the weights fill the tree of JAX's ``init`` (its shapes by
``eval_shape``, the values drawn with numpy from a seed by
``tests/test_torch_port_pranet.py::random_variables``, every BatchNorm away
from the identity; jitting ``init`` itself would cost about 20 s more) and enter
the port through ``utils.convert.state_dict_from_jax``; the batch is numpy
from a seed.  The port's side is its own train step
(``train.binary.make_train_step`` with ``train.make_optimizer``); JAX's is
``value_and_grad`` of the four structure losses in train mode and its
``make_optimizer``'s clip + Adam update.  Both run in float64: train-mode
BatchNorm renormalises every layer and would carry float32 ordering noise
through about 50 layers into percent-level gradient differences.

Checks, in dependency order:
1. the loss, within 1e-9 relative;
2. every gradient, in flax layout, within atol 1e-8 and rtol 1e-6 (the
   grayscale stem, which an RGB batch does not reach, has no gradient in
   torch and no parameter in JAX's tree: it counts as zero);
3. the BatchNorm running statistics after the step;
4. the parameters after one clip + Adam step through the port's
   ``make_optimizer``, within atol 5e-9 and rtol 1e-8, given JAX's
   gradients; and the port's own step took exactly that update of its own
   gradients.  The two sides' gradients are not fed to one comparison of
   updates: Adam's direction g / (|g| + 1e-8) turns fast where |g| is near
   1e-8, so float64 ordering noise (a few 1e-12 on such an element) moves
   the update there by up to ~1e-8.

JAX's jitted ``value_and_grad`` of this model in x64 takes about half a
minute with its compile on this host; it runs once, in a module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pranet2_tpu.losses import structure_loss as jax_structure_loss
from pranet2_tpu.models import get_model as jax_get_model
from pranet2_tpu.train.optim import make_optimizer as jax_make_optimizer
from pranet2_tpu.utils.torch_convert import convert_state_dict, pranet_key_map
from pranet2_tpu_torch import get_model
from pranet2_tpu_torch.train import TrainState, make_optimizer
from pranet2_tpu_torch.train.binary import make_train_step
from pranet2_tpu_torch.utils.convert import (load_jax_variables,
                                            state_dict_from_jax)
from test_torch_port_pranet import random_variables

SIZE, BATCH, LR, CLIP = 64, 2, 1e-4, 0.5


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs files in parallel workers, and
    each worker's default of one thread a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch():
    rng = np.random.default_rng(42)
    x = rng.standard_normal((BATCH, SIZE, SIZE, 3))
    gts = (rng.random((BATCH, SIZE, SIZE, 1)) > 0.6).astype(np.float64)
    return x, gts


def _tree_to_np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float64), tree)


def _variables(model):
    """A float64 flax tree in the shapes of ``model``'s init, drawn with
    numpy from a seed (``test_torch_port_pranet.random_variables``)."""
    return _tree_to_np(random_variables(
        model, jnp.zeros((1, SIZE, SIZE, 3), jnp.float32), seed=7))


@pytest.fixture(scope="module")
def jax_side():
    """JAX's float64 step: initial variables, loss, gradients, BatchNorm
    statistics after the forward and parameters after clip + Adam."""
    with jax.enable_x64(True):
        model = jax_get_model("pranet_v2", num_class=1)
        x, gts = _batch()
        variables = _variables(model)

        def loss_fn(params, xj, gj):
            outs, upd = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                xj, True, mutable=["batch_stats"])
            return sum(jax_structure_loss(f, b, gj, 1.0 - gj)
                       for f, b in zip(outs[:4], outs[4:])), upd["batch_stats"]

        params = jax.tree.map(jnp.asarray, variables["params"])
        # the batch as arguments: as constants XLA would fold the 31x31
        # boundary pool at compile time
        (loss, stats), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, jnp.asarray(x), jnp.asarray(gts))
        tx = jax_make_optimizer(LR, clip_value=CLIP)
        updates, _ = tx.update(grads, tx.init(params), params)
        after = optax.apply_updates(params, updates)
        return dict(variables=variables, loss=float(loss),
                    grads=_tree_to_np(grads), stats=_tree_to_np(stats),
                    params=_tree_to_np(after))


@pytest.fixture(scope="module")
def port_side(jax_side):
    """The port's float64 step on the same weights and batch, through its
    train step; the gradients are read as ``apply_gradients`` takes them."""
    x, gts = _batch()
    model = get_model("pranet_v2", device="cpu", num_class=1).double()
    load_jax_variables(model, jax_side["variables"])
    state = TrainState(
        model, make_optimizer(model.parameters(), LR, clip_value=CLIP))
    grads = {}
    apply = TrainState.apply_gradients

    def spy(self):
        grads.update({k: None if p.grad is None else p.grad.clone()
                      for k, p in self.model.named_parameters()})
        apply(self)

    step = make_train_step(model, target_size=SIZE, rescale=False)
    to_t = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())
    TrainState.apply_gradients = spy
    try:
        state, loss, losses = step(state, to_t(x), to_t(gts))
    finally:
        TrainState.apply_gradients = apply
    assert state.step == 1 and loss.dtype == torch.float64
    return dict(loss=loss.item(), losses=losses, grads=grads,
                after={k: v.numpy() for k, v in model.state_dict().items()})


def _port_update(variables, grads):
    """The port's clip + Adam (``make_optimizer``) applied once to
    ``grads`` (torch names -> tensors, None for none) from ``variables``;
    returns the model's state_dict as numpy."""
    model = get_model("pranet_v2", device="cpu", num_class=1).double()
    load_jax_variables(model, variables)
    named = dict(model.named_parameters())
    opt = make_optimizer(named.values(), LR, clip_value=CLIP)
    for k, p in named.items():
        p.grad = None if grads[k] is None else grads[k].clone()
    opt.step()
    return {k: v.numpy() for k, v in model.state_dict().items()}


KEY_MAP = pranet_key_map("v2", "res2net50")


def _flax(sd, part):
    """A torch-named dict of arrays in flax layout, the grayscale stem
    (``stem_conv``, ``stem_bn``: not in JAX's RGB tree) left out."""
    with jax.enable_x64(True):
        tree = convert_state_dict(sd, KEY_MAP)[part]
    return _tree_to_np({k: v for k, v in tree.items()
                        if k not in ("stem_conv", "stem_bn")})


def _assert_trees_close(got, want, atol, rtol, what):
    g = jax.tree_util.tree_leaves_with_path(got)
    w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol,
                                   err_msg=f"{what}: "
                                           f"{jax.tree_util.keystr(path)}")


def test_loss_matches_jax(jax_side, port_side):
    assert abs(port_side["loss"] - jax_side["loss"]) <= 1e-9 * abs(
        jax_side["loss"]), (port_side["loss"], jax_side["loss"])
    assert port_side["losses"].shape == (4,)


def test_gradients_match_jax(jax_side, port_side):
    grads = port_side["grads"]
    stem = [k for k in grads if k.startswith("conv.")]
    assert stem and all(grads[k] is None for k in stem)
    missing = [k for k, g in grads.items() if g is None and k not in stem]
    assert not missing, missing
    # the buffers' entries only carry them through the conversion
    sd = {k: v if grads.get(k) is None else grads[k].numpy()
          for k, v in port_side["after"].items()}
    _assert_trees_close(_flax(sd, "params"), jax_side["grads"], atol=1e-8,
                        rtol=1e-6, what="grad")


def test_batchnorm_stats_match_jax(jax_side, port_side):
    _assert_trees_close(_flax(port_side["after"], "batch_stats"),
                        jax_side["stats"], atol=1e-10, rtol=1e-8,
                        what="batch_stat")


def test_params_after_clip_adam_match_jax(jax_side, port_side):
    """JAX's gradients through the port's optimizer against JAX's update;
    the port's own step against its optimizer on its own gradients."""
    with jax.enable_x64(True):
        sd = {k: np.asarray(v) for k, v in state_dict_from_jax(
            {"params": jax_side["grads"]}).items()}
    jax_grads = {k: (torch.from_numpy(sd[k]) if k in sd else None)
                 for k in port_side["grads"]}
    after = _port_update(jax_side["variables"], jax_grads)
    _assert_trees_close(_flax(after, "params"), jax_side["params"],
                        atol=5e-9, rtol=1e-8, what="post-step param")
    own = _port_update(jax_side["variables"], port_side["grads"])
    for k in port_side["grads"]:
        np.testing.assert_array_equal(port_side["after"][k], own[k],
                                      err_msg=k)


def test_two_rank_step_matches_jax(jax_side, tmp_path):
    """The same step data-parallel: 2 gloo ranks of 1 row each
    (``tests/torch_parallel_ranks.py``; ``SyncBatchNorm``, DDP) against
    JAX's one-device step on both rows, with this file's tolerances.
    ``tests/test_parallel.py`` holds JAX's 8-device step equal to its
    1-device one."""
    import torch_parallel_ranks as ranks

    x, gts = _batch()
    model = get_model("pranet_v2", device="cpu", num_class=1).double()
    sd = load_jax_variables(model, jax_side["variables"]).state_dict()
    got = ranks.launch(ranks.binary_steps, 2, tmp_path, x, gts, 1, False,
                       sd)[0]
    assert got["kind"] == "DistributedDataParallel"
    (loss,) = got["losses"]
    assert abs(loss - jax_side["loss"]) <= 1e-9 * abs(jax_side["loss"])
    grads = got["grads"]
    assert all(grads[k] is None for k in grads if k.startswith("conv."))
    with_grads = {k: v if grads.get(k) is None else grads[k].numpy()
                  for k, v in got["first"].items()}
    _assert_trees_close(_flax(with_grads, "params"), jax_side["grads"],
                        atol=1e-8, rtol=1e-6, what="grad")
    _assert_trees_close(_flax(got["first"], "batch_stats"),
                        jax_side["stats"], atol=1e-10, rtol=1e-8,
                        what="batch_stat")
    own = _port_update(jax_side["variables"], grads)
    for k in grads:
        np.testing.assert_array_equal(got["first"][k].numpy(), own[k],
                                      err_msg=k)

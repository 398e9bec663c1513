"""The port's MIST against the JAX package's, on the CPU.

``mist_cam`` at full width, its ``maxxvit_rmlp_small_rw_256`` encoder cut
to one block a stage on both sides (``monkeypatch.setitem`` of each
package's ``MAXVIT_CONFIGS``), its encoder input cut to 64^2: the stage
maps are 16, 8, 4 and 2 px, the bottleneck pools to 1.  Weights are numpy
from a seed (``test_torch_port_maxvit.random_state``) put in JAX's layout
by the JAX package's ``split_packed_mha`` and ``convert_state_dict`` with
``mist_key_map``, and carried back into the port by ``state_dict_from_jax``
(which packs the in-projections again); dual and single share the encoder
and the decoder blocks, so one draw serves both.  Inputs are numpy from a
seed (NCHW on the port's side, NHWC on JAX's).  Float32: the models within
1e-4 of the largest |map|, the CBAM and SE blocks within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pranet2_tpu.models import get_model as jax_get_model
from pranet2_tpu.models import mist as jmist
from pranet2_tpu.models.backbones import maxvit as jmv
from pranet2_tpu.utils.torch_convert import (convert_state_dict, mist_key_map,
                                             split_packed_mha)
from pranet2_tpu_torch import ops
from pranet2_tpu_torch.models import mist
from pranet2_tpu_torch.models.backbones import maxvit
from pranet2_tpu_torch.utils.convert import (load_reference,
                                            load_reference_state_dict,
                                            state_dict_from_jax)
from test_torch_port_emcad import _block_vars, _input, _nchw, _record, _rel_err
from test_torch_port_maxvit import random_state

NC, SIDE = 4, 64
MODEL_TOL, BLOCK_TOL = 1e-4, 1e-5
KW = dict(num_classes=NC, img_size_s1=(SIDE, SIDE))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs files in parallel workers, and
    each worker's default of one thread a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def depth1():
    """Both sides' ``maxxvit_rmlp_small_rw_256`` cut to one block a stage,
    for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        for configs in (jmv.MAXVIT_CONFIGS, maxvit.MAXVIT_CONFIGS):
            name = "maxxvit_rmlp_small_rw_256"
            mp.setitem(configs, name, {**configs[name],
                                       "depths": (1, 1, 1, 1)})
        yield


def _to_jax(sd):
    return convert_state_dict(split_packed_mha(sd), mist_key_map())


@pytest.fixture(scope="module")
def trees(depth1):
    """(input, {dual: flax tree}, {dual: JAX maps}) at batch 2, one
    compile for both modes."""
    with torch.device("meta"):
        shell = mist.MISTCAM(**KW)
    dual = _to_jax(random_state(shell, seed=1))
    # the single mode: the same encoder and blocks, its own 4 heads
    rng = np.random.default_rng(2)
    params = {k: t for k, t in dual["params"].items()}
    params["decoder"] = {k: t for k, t in params["decoder"].items()
                         if not k.startswith("out_head")}
    for i, c in enumerate((768, 384, 192, 96), start=1):
        params[f"out_head{i}"] = {
            "kernel": rng.standard_normal((1, 1, c, NC), np.float32)
            / np.float32(np.sqrt(c)),
            "bias": rng.normal(0.0, 0.1, NC).astype(np.float32)}
    v = {True: dual, False: {**dual, "params": params}}
    x = _input(1, seed=3, side=SIDE)
    models = {d: jax_get_model("mist_cam", **KW, dual=d) for d in v}
    want = jax.jit(lambda vd, vs, x: (models[True].apply(vd, x),
                                      models[False].apply(vs, x)))(
        v[True], v[False], x)
    return x, v, dict(zip((True, False), want))


def _port(variables, dual=True):
    """The port's MIST holding ``variables`` (built on the meta device, its
    parameters the converted arrays themselves)."""
    with torch.device("meta"):
        model = mist.MISTCAM(**KW, dual=dual)
    model.load_state_dict(state_dict_from_jax(variables), assign=True)
    return model.eval()


@pytest.fixture(scope="module")
def port_dual(trees):
    return _port(trees[1][True])


@pytest.mark.parametrize("dual", [True, False], ids=["dual", "single"])
def test_mist_matches_jax(trees, port_dual, dual):
    x, v, want = trees
    with torch.no_grad():
        got = (port_dual if dual else _port(v[False], False))(_nchw(x))
    assert len(got) == len(want[dual]) == (8 if dual else 4)
    for g, w in zip(got, want[dual]):
        assert tuple(g.shape) == (2, NC, SIDE, SIDE)
        assert _rel_err(g, w) < MODEL_TOL


def test_state_dict_round_trip_and_packed_attention(trees, port_dual):
    """A JAX tree -> ``state_dict_from_jax`` (q, k and v packed into
    ``attention.in_proj_weight`` (3C, C), in that order) -> the port -> its
    state_dict -> ``split_packed_mha`` and ``convert_state_dict`` with
    ``mist_key_map`` -> the same tree."""
    _, v, _ = trees
    attn = port_dual.decoder.block_5.trans.attention_output.attention
    assert tuple(attn.in_proj_weight.shape) == (3 * 1536, 1536)
    jattn = v[True]["params"]["decoder"]["block_5"]["trans"][
        "attention_output"]
    np.testing.assert_array_equal(
        attn.in_proj_weight[1536:3072].detach().numpy(),
        np.asarray(jattn["in_proj_k"]["kernel"]).T)
    back = _to_jax({k: t.numpy() for k, t in port_dual.state_dict().items()})
    g = jax.tree_util.tree_leaves_with_path(back)
    w = jax.tree_util.tree_leaves_with_path(v[True])
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(p))


def test_load_reference_drops_the_dead_conv3(trees, port_dual, tmp_path):
    """A reference-style MIST ``.pth``: ``module.`` keys in a ``model``
    container, the packed ``in_proj_weight``, and the decoder blocks'
    ``conv3``, defined but dead in the reference forward: the port loads
    it, drops and reports the ``conv3`` keys, and serves JAX's maps."""
    x, _, want = trees
    sd = port_dual.state_dict()
    dead = [f"decoder.block_{i}.conv3.{k}" for i in (6, 7) for k in
            ("bias", "weight")]
    for k in dead:
        sd[k] = torch.zeros(2)
    torch.save({"model": {f"module.{k}": t for k, t in sd.items()}},
               tmp_path / "mist.pth")
    with torch.device("meta"):
        model = mist.MISTCAM(**KW)
    model = model.to_empty(device="cpu")  # load_reference fills it all
    assert load_reference(model, load_reference_state_dict(
        str(tmp_path / "mist.pth"))) == sorted(dead)
    with torch.no_grad():
        got = model.eval()(_nchw(x))
    for g, w in zip(got, want[True]):
        assert _rel_err(g, w) < MODEL_TOL


def test_eval_with_autograd_reaches_every_parameter(port_dual, monkeypatch):
    """MIST in eval: 3 gates a forward (the autograd Function) with
    autograd off and on; a backward gives every parameter a finite
    gradient (the class of faults F1 and F5)."""
    calls = []
    _record(monkeypatch, calls, [(mist, "dsra_gate")])
    x = _nchw(_input(1, seed=4, side=32))
    with torch.no_grad():
        port_dual(x)
    assert calls == ["dsra_gate"] * 3
    calls.clear()
    try:
        sum(o.square().mean() for o in port_dual(x)).backward()
        assert calls == ["dsra_gate"] * 3
        missing = [n for n, p in port_dual.named_parameters() if
                   p.grad is None or not bool(torch.isfinite(p.grad).all())]
        assert not missing, missing
    finally:
        port_dual.zero_grad(set_to_none=True)


def test_bottleneck_pools_with_max_pool2d_as_jax(monkeypatch):
    """F6: the bottleneck pools 2x2 with ``F.max_pool2d`` in every mode,
    which sends a tied window's whole gradient to its first maximum, as
    ``jax.grad`` of JAX's ``max_pool(y, 2, 2, 0)`` (``reduce_window``)
    does; ``ops.max_pool`` splits a tie and would not."""
    from pranet2_tpu.ops import max_pool as jax_max_pool

    pools = []
    orig = mist.F.max_pool2d
    monkeypatch.setattr(mist.F, "max_pool2d",
                        lambda *a: pools.append(a[1:]) or orig(*a))
    block = mist._Bottleneck(8, 16, 2).train()
    block(torch.zeros((2, 8, 4, 4)))
    assert pools == [(2, 2)]
    monkeypatch.undo()
    # ties: every window of a 0/1 map holds several equal maxima
    z = (np.arange(2 * 16 * 4 * 4).reshape(2, 4, 4, 16) % 3 == 0).astype(
        np.float32)
    r = np.random.default_rng(5).standard_normal((2, 2, 2, 16)).astype(
        np.float32)
    want = np.asarray(jax.grad(lambda y: jnp.sum(
        jax_max_pool(y, 2, 2, 0) * r))(jnp.asarray(z)))
    t = _nchw(z).requires_grad_()
    (torch.nn.functional.max_pool2d(t, 2, 2) * _nchw(r)).sum().backward()
    np.testing.assert_array_equal(t.grad.permute(0, 2, 3, 1).numpy(), want)
    t.grad = None
    (ops.max_pool(t, 2, 2, 0) * _nchw(r)).sum().backward()
    assert not np.array_equal(t.grad.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("name", ["cbam", "se", "channel", "spatial3"])
def test_attention_utilities_match_jax(name):
    """The reference MIST module's CBAM, SE, channel and spatial (3x3)
    gates at 32 channels (reduction 16)."""
    x = _input(32, seed=7, side=6)
    ref, port = {
        "cbam": (jmist.CBAM(), mist.CBAM(32)),
        "se": (jmist.SEBlock(), mist.SEBlock(32)),
        "channel": (jmist.ChannelAttentionCBAM(), mist.ChannelAttentionCBAM(
            32)),
        "spatial3": (jmist.SpatialAttentionCBAM(3),
                     mist.SpatialAttentionCBAM(3))}[name]
    v = _block_vars(ref, x)
    sd = state_dict_from_jax(v)
    # flax's Dense names for the SE's Sequential (``excitation_0``, ``_2``)
    port.load_state_dict({k.replace("excitation_", "excitation."): t
                          for k, t in sd.items()})
    with torch.no_grad():
        assert _rel_err(port.eval()(_nchw(x)), ref.apply(v, x)) < BLOCK_TOL
    with pytest.raises(ValueError):
        mist.SpatialAttentionCBAM(5)

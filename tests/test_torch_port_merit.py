"""The port's CASCADE decoders, MERIT and the MaxViT zoo against the JAX
package's, on the CPU.

Each model's weights are numpy from a seed, drawn for its ``state_dict``
(``test_torch_port_maxvit.random_state``: every kernel, BatchNorm and
bias randomised) and put in JAX's layout by the JAX package's
``convert_state_dict``; the port loads that tree by
``state_dict_from_jax``.  No JAX init is traced (one test holds a tree's
structure to ``eval_shape`` of JAX's init), and JAX's six forwards are one
compile.  Inputs are numpy from a seed (NCHW on the port's side, NHWC on
JAX's).  Float32: the models within 1e-4 of the largest |output|
(summation order only).

The models run on the JAX package's compile-test backbone
(``model_scale="dryrun"``: ``maxvit_dryrun`` twice) with the backbones'
inputs cut to 64^2 and 32^2: ``merit_cascaded`` dual at 64^2 (no flip) and
single at 56^2 (56 is a multiple of 14: the backbones swap scales),
``merit_parallel`` at 48^2 (resizes to and from odd sides), the zoo at
64^2 (``maxvit_cascade`` with the concatenating decoder); together they
hold the three decoders.  The 'tiny' scale's bias table is held at 224
and 256 by shapes alone (no forward).  One float64 train step of
``maxvit_cascade`` 'tiny' at ``img_size=224`` (its backbone the
bias-table ``maxvit_tiny_rw_224``, no dropout, window 7) runs against
JAX's, the backbone cut to one block a stage and to the dryrun widths on
both sides (full widths would add the compute of a float64 step at 224 on
the CPU, not semantics).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.flatten_util import ravel_pytree

from pranet2_tpu.models import get_model as jax_get_model
from pranet2_tpu.models import merit as jmerit
from pranet2_tpu.models.backbones import maxvit as jmv
from pranet2_tpu.train import multiclass as jax_mc
from pranet2_tpu.train.optim import make_optimizer as jax_make_optimizer
from pranet2_tpu.train.state import TrainState as JaxTrainState
from pranet2_tpu.utils.torch_convert import (convert_state_dict,
                                             maxvit_single_key_map,
                                             merit_key_map)
from pranet2_tpu_torch import get_model
from pranet2_tpu_torch.models import decoders, merit
from pranet2_tpu_torch.models.backbones import maxvit
from pranet2_tpu_torch.train import TrainState, make_optimizer
from pranet2_tpu_torch.train import multiclass as port_mc
from pranet2_tpu_torch.utils.convert import (load_jax_variables,
                                            load_reference,
                                            load_reference_state_dict)
from test_torch_port_emcad import _input, _nchw, _record, _rel_err
from test_torch_port_maxvit import random_state

NC = 4
MODEL_TOL, BLOCK_TOL = 1e-4, 1e-5
SMALL = dict(model_scale="dryrun", img_size_s1=(64, 64), img_size_s2=(32, 32))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs files in parallel workers, and
    each worker's default of one thread a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tree_equal(got, want):
    g = jax.tree_util.tree_leaves_with_path(got)
    w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))


# ---------------------------------------------------------------- models

# case -> (registry name, JAX and port keyword arguments, the port's
# extra ones, input side, input channels)
CASES = {
    "cascaded_dual": ("merit_cascaded", dict(SMALL), dict(img_size=64), 64,
                      1),
    "cascaded_single_flip": ("merit_cascaded", dict(SMALL, dual=False),
                             dict(img_size=56), 56, 1),
    "parallel": ("merit_parallel", dict(SMALL), {}, 48, 3),
    "maxvit_seg": ("maxvit_seg", dict(model_scale="dryrun", img_size=64), {},
                   64, 1),
    "maxvit4out": ("maxvit4out", dict(model_scale="dryrun", img_size=64), {},
                   64, 3),
    "maxvit_cascade_cat": ("maxvit_cascade", dict(
        model_scale="dryrun", img_size=64,
        decoder_aggregation="concatenation"), {}, 64, 1),
}


def _key_map(case):
    return (merit_key_map() if CASES[case][0].startswith("merit")
            else maxvit_single_key_map())


def _port(case, variables=None, dtype=None, device="cpu"):
    name, kw, extra, _, _ = CASES[case]
    model = get_model(name, device=device, dtype=dtype, num_classes=NC, **kw,
                      **extra)
    if variables is not None:
        load_jax_variables(model, variables)
    return model.eval()


@pytest.fixture(scope="module")
def trees():
    """(input, flax tree, JAX outputs) of each case, batch 2; JAX's six
    forwards in one compile."""
    xs, vs, models = {}, {}, {}
    for case, (name, kw, _, side, cin) in CASES.items():
        xs[case] = _input(cin, seed=6, side=side)
        with torch.device("meta"):
            shell = _port(case, device="meta")
        vs[case] = convert_state_dict(random_state(shell, seed=7),
                                      _key_map(case))
        models[case] = jax_get_model(name, num_classes=NC, **kw)
    want = jax.jit(lambda vs, xs: {c: models[c].apply(vs[c], xs[c])
                                   for c in CASES})(vs, xs)
    return {c: (xs[c], vs[c], want[c] if isinstance(want[c], tuple)
                else (want[c],)) for c in CASES}


def test_tree_is_jax_init_structure(trees):
    """The tree drawn for the port's parameters is the tree JAX's init
    makes (``eval_shape``): the same paths and shapes, nothing left over."""
    x, v, _ = trees["cascaded_dual"]
    name, kw, _, _, _ = CASES["cascaded_dual"]
    shapes = jax.eval_shape(jax_get_model(name, num_classes=NC, **kw).init,
                            jax.random.key(0), jnp.asarray(x))
    as_list = lambda t: [(p, np.shape(a)) for p, a in
                         jax.tree_util.tree_leaves_with_path(t)]
    assert as_list(v) == as_list(shapes)


@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_jax(trees, case):
    """Each model's maps within 1e-4 of JAX's.  The three decoders are
    held here: ``CascadeAddDual`` in the dual cases, ``CascadeAdd`` in the
    single one, ``CascadeCat`` in ``maxvit_cascade_cat``; one ``SA`` is
    shared by every level."""
    x, v, want = trees[case]
    sa = [k for k in v["params"].get("decoder", {}) if k.startswith("SA")]
    assert sa in ([], ["SA"])
    with torch.no_grad():
        got = _port(case, v)(_nchw(x))
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, NC) + x.shape[1:3]
        assert _rel_err(g, w) < MODEL_TOL


@pytest.mark.parametrize("case", ["cascaded_dual", "cascaded_single_flip",
                                  "maxvit_seg", "maxvit_cascade_cat"])
def test_state_dict_round_trip(trees, case):
    """A JAX tree -> ``state_dict_from_jax`` -> the port -> its state_dict
    -> the JAX package's ``convert_state_dict`` with ``merit_key_map`` or
    ``maxvit_single_key_map`` -> the same tree."""
    _, v, _ = trees[case]
    _tree_equal(convert_state_dict(
        {k: t.numpy() for k, t in _port(case, v).state_dict().items()},
        _key_map(case)), v)


def test_load_reference_of_a_dataparallel_pth(trees, tmp_path):
    """A reference-style MERIT ``.pth`` (``module.`` keys in a
    ``state_dict`` container, both backbones' classifier heads) loads into
    the port, dropping the heads, and through the JAX package's loader and
    ``merit_key_map`` gives the JAX tree the port's weights came from."""
    from pranet2_tpu.utils.torch_convert import load_torch_state_dict

    x, v, want = trees["cascaded_dual"]
    sd = _port("cascaded_dual", v).state_dict()
    heads = ["backbone1.head.fc.weight", "backbone2.head.norm.weight"]
    for k in heads:
        sd[k] = torch.zeros(3)
    torch.save({"state_dict": {f"module.{k}": t for k, t in sd.items()}},
               tmp_path / "merit.pth")
    model = _port("cascaded_dual")
    assert load_reference(model, load_reference_state_dict(
        str(tmp_path / "merit.pth"))) == heads
    with torch.no_grad():
        got = model(_nchw(x))
    for g, w in zip(got, want):
        assert _rel_err(g, w) < MODEL_TOL
    _tree_equal(convert_state_dict(load_torch_state_dict(
        str(tmp_path / "merit.pth")), merit_key_map(), strict=False), v)


def test_merit_bf16_runs_in_bf16(trees):
    """bf16 compute (``set_compute_dtype``; BatchNorm, LayerNorm, the
    LayerScales and the gate's softmax float32): maps in bf16 within 0.1
    of the float32 model's."""
    x, v, _ = trees["cascaded_dual"]
    low = load_jax_variables(_port("cascaded_dual", dtype=torch.bfloat16), v)
    with torch.no_grad():
        got, want = low(_nchw(x)), _port("cascaded_dual", v)(_nchw(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert ((g.float() - w).abs().max() / w.abs().max()).item() < 0.1


@pytest.mark.parametrize("case", ["cascaded_dual", "parallel"])
def test_eval_with_autograd_reaches_every_parameter(monkeypatch, case):
    """MERIT in eval: the decoder's gates are the autograd Function, 3 a
    decoder pass (6 a forward) with autograd off and on; a backward gives
    every parameter a finite gradient (the class of faults F1 and F5)."""
    model = _port(case)
    calls = []
    _record(monkeypatch, calls, [(decoders, "dsra_gate")])
    _, _, _, side, cin = CASES[case]
    x = _nchw(_input(cin, seed=8, side=side))
    with torch.no_grad():
        model(x)
    assert calls == ["dsra_gate"] * 6
    calls.clear()
    sum(o.square().mean() for o in model(x)).backward()
    assert calls == ["dsra_gate"] * 6
    skip = "conv." if cin == 3 else "\0"  # the grayscale stem, unused on RGB
    missing = [n for n, p in model.named_parameters() if not n.startswith(
        skip) and (p.grad is None or not bool(torch.isfinite(p.grad).all()))]
    assert not missing, missing


# ------------------------------------------------------- the bias table


@pytest.mark.parametrize("side,window", [(224, 8), (256, 7)])
def test_tiny_bias_table_follows_the_flip(side, window):
    """'tiny' MERIT at its two inputs, built with ``img_size=side`` (on the
    meta device: full depth, no memory): at 224, a multiple of 14, the
    bias-table backbone ``backbone2`` runs at 256 and holds a window-8
    table in every attention; at 256 it runs at 224, window 7.  Each table
    has the shape of JAX's ``RelPosBias`` at that window."""
    with torch.device("meta"):
        model = merit.MERITCascaded(NC, "tiny", img_size=side)
    tables = [(n, tuple(p.shape)) for n, p in model.named_parameters()
              if n.endswith("relative_position_bias_table")]
    assert len(tables) == 22 and all(n.startswith("backbone2.")
                                     for n, _ in tables)
    for n, shape in tables:
        heads = shape[1]
        want = jax.eval_shape(jmv.RelPosBias(window, heads).init,
                              jax.random.key(0))
        assert shape == want["params"]["relative_position_bias_table"].shape
        assert shape[0] == (2 * window - 1) ** 2


# ------------------------------------------------------ float64 training

STEP_TOL = {"params": dict(atol=1e-8, rtol=1e-6),
            "batch_stats": dict(atol=1e-9, rtol=1e-8)}


def _attention_f64(q, k, v, bias=None):
    """``jax.nn.dot_product_attention`` of (B, T, N, H) q, k, v with an
    additive bias (scale 1/sqrt(H)) in the inputs' type."""
    s = jnp.einsum("btnh,bsnh->bnts", q, k) / jnp.sqrt(q.shape[-1]).astype(
        q.dtype)
    if bias is not None:
        s = s + bias
    return jnp.einsum("bnts,bsnh->btnh", jax.nn.softmax(s, axis=-1), v)


@pytest.fixture
def tiny_cut(monkeypatch):
    """Both sides' ``maxvit_tiny_rw_224`` cut to one block a stage at the
    dryrun widths, and the 'tiny' decoder to match."""
    dry = maxvit.MAXVIT_CONFIGS["maxvit_dryrun"]
    for configs in (jmv.MAXVIT_CONFIGS, maxvit.MAXVIT_CONFIGS):
        monkeypatch.setitem(configs, "maxvit_tiny_rw_224", {
            **configs["maxvit_tiny_rw_224"], "depths": (1, 1, 1, 1),
            "embed_dim": dry["embed_dim"], "stem_width": dry["stem_width"]})
    for channels in (jmerit._SCALE_CHANNELS, merit._SCALE_CHANNELS):
        monkeypatch.setitem(channels, "tiny", channels["dryrun"])


def test_train_step_matches_jax_f64(tiny_cut, monkeypatch):
    """One step of the multiclass recipe (AdamW, MUTATION over the 4 maps,
    single supervision) of ``maxvit_cascade`` 'tiny' at ``img_size=224``,
    float64, batch 2: the loss within 1e-9 relative, every parameter
    within 1e-8 + 1e-6 relative and every BatchNorm statistic within
    1e-9 + 1e-8 relative of JAX's.  JAX's side is its train step's loss
    (``pranet2_tpu/train/multiclass.py:143-180``) under ``value_and_grad``
    and its optimizer and ``TrainState`` on the raveled tree (AdamW is
    elementwise): one compile for the gradient, a small one for the
    update."""
    monkeypatch.setattr(jax.nn, "dot_product_attention", _attention_f64)
    rng = np.random.default_rng(9)
    side = 224
    images = rng.standard_normal((2, side, side, 1))
    labels = rng.integers(0, NC, (2, side, side))
    kw = dict(num_classes=NC, model_scale="tiny", img_size=side)
    cfg = port_mc.MulticlassTrainConfig(num_classes=NC, batch_size=2,
                                        img_size=side, dual=False)
    with torch.device("meta"):
        shell = get_model("maxvit_cascade", device="meta", **kw)
    v = jax.tree.map(lambda a: np.array(a, np.float64), convert_state_dict(
        random_state(shell, seed=10), maxvit_single_key_map()))
    model = jax_get_model("maxvit_cascade", **kw)

    def loss_fn(params, batch_stats, x, y):
        outs, upd = model.apply(
            {"params": params, "batch_stats": batch_stats}, x, True,
            mutable=["batch_stats"],
            rngs={"dropout": jax.random.fold_in(jax.random.key(cfg.seed),
                                                0)})
        loss = jax_mc.mutation_loss(list(outs), y, NC,
                                    single_weights=cfg.single_weights,
                                    supervision=cfg.supervision)
        return loss, upd["batch_stats"]

    with jax.enable_x64(True):
        (loss, stats), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v["params"], v["batch_stats"], images,
                                    labels)
        flat, unravel = ravel_pytree(v["params"])
        tx = jax_make_optimizer(cfg.lr, clip_value=None,
                                weight_decay=cfg.weight_decay)
        state = JaxTrainState(step=0, params=flat, batch_stats=None,
                              opt_state=tx.init(flat), tx=tx)
        state = jax.jit(lambda s, g: s.apply_gradients(g))(
            state, ravel_pytree(grads)[0])
        want = {"params": jax.tree.map(np.asarray, unravel(state.params)),
                "batch_stats": jax.tree.map(np.asarray, stats)}

    port = load_jax_variables(get_model("maxvit_cascade", device="cpu", **kw)
                              .to(torch.float64), v)
    pstate = TrainState(port, make_optimizer(
        port.parameters(), cfg.lr, clip_value=None,
        weight_decay=cfg.weight_decay))
    pstate, ploss = port_mc.make_multiclass_train_step(port, cfg)(
        pstate, torch.from_numpy(images.transpose(0, 3, 1, 2).copy()),
        torch.from_numpy(labels))
    assert ploss.dtype == torch.float64 and pstate.step == 1
    assert abs(ploss.item() - float(loss)) <= 1e-9 * abs(float(loss))
    with jax.enable_x64(True):
        got = jax.tree.map(np.asarray, convert_state_dict(
            {k: t.numpy() for k, t in port.state_dict().items()},
            maxvit_single_key_map()))
    for part, tol in STEP_TOL.items():
        g = jax.tree_util.tree_leaves_with_path(got[part])
        w = jax.tree_util.tree_leaves_with_path(want[part])
        assert [p for p, _ in g] == [p for p, _ in w]
        for (path, a), (_, b) in zip(g, w):
            np.testing.assert_allclose(a, b, **tol,
                                       err_msg=jax.tree_util.keystr(path))

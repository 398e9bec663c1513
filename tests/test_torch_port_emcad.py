"""The port's EMCAD against the JAX package's, on the CPU.

Weights are drawn as in ``test_torch_port_pranet.random_variables`` (every
BatchNorm randomised) and carried into the port by ``state_dict_from_jax``;
a block's tree is converted under its decoder name (e.g. ``decoder.mscb4``)
and loaded into the port's block.  Inputs are numpy from a seed: NCHW on
the port's side, NHWC on JAX's.  Float32 on both sides: every forward
within 1e-4 of the largest |output| (the blocks 1e-5); summation order only.

Models: ``pvt_v2_b0`` (dual, on a grayscale input, which builds the stem;
and single), ``resnet18`` (dual, grayscale), all at 64 x 64, batch 2,
their JAX trees drawn once a module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pranet2_tpu.models import emcad as jax_emcad
from pranet2_tpu.models import get_model as jax_get_model
from pranet2_tpu.utils.torch_convert import convert_state_dict, emcad_key_map
from pranet2_tpu_torch import get_model
from pranet2_tpu_torch.models import emcad
from pranet2_tpu_torch.models.backbones import pvtv2, resnet
from pranet2_tpu_torch.utils.convert import (load_jax_variables,
                                            load_reference,
                                            load_reference_state_dict,
                                            state_dict_from_jax)
from test_torch_port_pranet import random_variables

SIZE, BATCH, NC = 64, 2, 4
MODEL_TOL, BLOCK_TOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs files in parallel workers, and
    each worker's default of one thread a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _rel_err(port, ref):
    b = np.asarray(ref, np.float32)
    return float(np.abs(_nhwc(port) - b).max() / max(np.abs(b).max(), 1e-6))


def _input(channels, seed=1, side=SIZE, n=BATCH):
    return np.random.default_rng(seed).standard_normal(
        (n, side, side, channels)).astype(np.float32)


# ---------------------------------------------------------------- blocks


def _block_vars(module, *xs, seed=0):
    """A numpy flax tree for ``module`` on inputs ``xs`` (as
    ``random_variables``, for several inputs)."""
    return random_variables(_Args(module, len(xs)),
                            jnp.concatenate([jnp.asarray(x) for x in xs],
                                            -1), seed)


class _Args:
    """``random_variables`` takes one input: split it back into the
    block's inputs along the channels."""

    def __init__(self, module, n):
        self.module, self.n = module, n

    def init(self, key, x):
        return self.module.init(key, *jnp.split(x, self.n, -1))


def _load_block(block, tree, name):
    """Load the flax ``tree`` of one decoder block into the port's
    ``block``, through the converter's names for ``decoder.<name>`` (an
    MSCB is the first module of ``decoder.mscb<i>``)."""
    wrapped = {k: {"decoder": {name: v}} for k, v in tree.items()}
    prefix = f"decoder.{name}.0." if name.startswith("mscb") else (
        f"decoder.{name}.")
    sd = {k[len(prefix):]: v
          for k, v in state_dict_from_jax(wrapped).items()}
    block.load_state_dict(sd)
    return block.eval()


@pytest.mark.parametrize("name", ["relu", "relu6", "gelu", "leakyrelu",
                                  "hswish"])
def test_activations_match_jax(name):
    x = np.linspace(-8, 8, 97, dtype=np.float32)
    want = np.asarray(jax_emcad._act(name)(jnp.asarray(x)))
    got = emcad.act_layer(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("groups", [1, 2, 3, 6])
def test_channel_shuffle_is_jax_order(groups):
    x = _input(12, seed=2, side=3)
    want = np.asarray(jax_emcad.channel_shuffle(jnp.asarray(x), groups))
    np.testing.assert_array_equal(
        _nhwc(emcad.channel_shuffle(_nchw(x), groups)), want)


@pytest.mark.parametrize("cin,cout,add,dw_parallel,act", [
    (16, 16, True, True, "relu6"), (16, 16, False, True, "relu6"),
    (16, 16, True, False, "gelu"), (12, 20, False, False, "hswish")],
    ids=["default", "concat", "cumulative", "conv1x1"])
def test_mscb_matches_jax(cin, cout, add, dw_parallel, act):
    x = _input(cin, seed=3, side=8)
    ref = jax_emcad.MSCB(cout, 1, (1, 3, 5), 2, dw_parallel, add, act)
    v = _block_vars(ref, x)
    port = _load_block(emcad.MSCB(cin, cout, 1, (1, 3, 5), 2, dw_parallel,
                                  add, act), v, "mscb4")
    assert hasattr(port, "conv1x1") == (cin != cout)
    with torch.no_grad():
        assert _rel_err(port(_nchw(x)), ref.apply(v, x)) < BLOCK_TOL


def test_eucb_matches_jax():
    x = _input(16, seed=4, side=5)
    ref = jax_emcad.EUCB(24, 3, "relu")
    v = _block_vars(ref, x)
    port = _load_block(emcad.EUCB(16, 24), v, "eucb3")
    with torch.no_grad():
        got = port(_nchw(x))
    assert got.shape == (BATCH, 24, 10, 10)
    assert _rel_err(got, ref.apply(v, x)) < BLOCK_TOL


@pytest.mark.parametrize("k", [3, 1])
def test_lgag_matches_jax(k):
    """Grouped W_g and W_x (``channels // 2`` groups), one group at k 1."""
    g, x = _input(16, seed=5, side=6), _input(16, seed=6, side=6)
    ref = jax_emcad.LGAG(8, k, 8, "relu")
    v = _block_vars(ref, g, x)
    port = _load_block(emcad.LGAG(16, 16, 8, k, 8), v, "lgag2")
    assert port.W_g[0].groups == (8 if k == 3 else 1)
    with torch.no_grad():
        assert _rel_err(port(_nchw(g), _nchw(x)), ref.apply(v, g, x)) \
            < BLOCK_TOL


@pytest.mark.parametrize("c", [8, 48])
def test_cab_and_sab_match_jax(c):
    """CAB's ratio is min(16, c): 8 channels reduce to 1, 48 to 3."""
    x = _input(c, seed=7, side=7)
    for ref, port, name in ((jax_emcad.CAB(), emcad.CAB(c), "cab1"),
                            (jax_emcad.SAB(), emcad.SAB(), "sab")):
        v = _block_vars(ref, x)
        port = _load_block(port, v, name)
        with torch.no_grad():
            assert _rel_err(port(_nchw(x)), ref.apply(v, x)) < BLOCK_TOL
    assert emcad.CAB(c).fc1.out_channels == c // min(16, c)


# ---------------------------------------------------------------- models

CASES = {"pvt_dual": ("pvt_v2_b0", True, 1),
         "pvt_single": ("pvt_v2_b0", False, 3),
         "resnet_dual": ("resnet18", True, 1)}


@pytest.fixture(scope="module")
def trees():
    """(input, flax tree, JAX outputs) of each case."""
    out = {}
    for case, (enc, dual, cin) in CASES.items():
        x = _input(cin, seed=8)
        model = jax_get_model("emcad", num_classes=NC, encoder=enc,
                              dual=dual)
        v = random_variables(model, jnp.asarray(x), seed=9)
        out[case] = (x, v, jax.jit(model.apply)(v, x))
    return out


def _port(case, variables, dtype=None):
    enc, dual, _ = CASES[case]
    model = get_model("emcad", device="cpu", dtype=dtype, num_classes=NC,
                      encoder=enc, dual=dual)
    return load_jax_variables(model, variables).eval()


@pytest.mark.parametrize("case", list(CASES))
def test_emcad_matches_jax(trees, case):
    x, v, want = trees[case]
    with torch.no_grad():
        got = _port(case, v)(_nchw(x))
    assert len(got) == len(want) == (8 if CASES[case][1] else 4)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (BATCH, NC, SIZE, SIZE)
        assert _rel_err(g, w) < MODEL_TOL


@pytest.mark.parametrize("case", ["pvt_dual", "resnet_dual"])
def test_state_dict_round_trip(trees, case):
    """The port's state_dict -> the JAX package's converter
    (``emcad_key_map``) -> the same tree."""
    _, v, _ = trees[case]
    back = convert_state_dict(
        {k: t.numpy() for k, t in _port(case, v).state_dict().items()},
        emcad_key_map(CASES[case][0]))
    want = jax.tree_util.tree_leaves_with_path(v)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))


def test_shared_sab_has_one_torch_key(trees):
    _, v, _ = trees["pvt_dual"]
    keys = [k for k in _port("pvt_dual", v).state_dict()
            if ".sab." in k or k.startswith("decoder.sab")]
    assert keys == ["decoder.sab.conv.weight"]


def test_load_reference_of_a_dataparallel_pth(trees, tmp_path):
    """A reference-style ``.pth`` (a ``state_dict`` container, every key
    ``module.``-prefixed, a stray ``backbone.head``) loads into the port
    and, through the JAX package's loader and ``emcad_key_map``, gives the
    JAX tree the port's weights came from."""
    from pranet2_tpu.utils.torch_convert import load_torch_state_dict

    x, v, want = trees["resnet_dual"]
    sd = _port("resnet_dual", v).state_dict()
    sd["backbone.fc.weight"] = torch.zeros((1000, 512))
    path = tmp_path / "emcad.pth"
    torch.save({"state_dict": {f"module.{k}": t for k, t in sd.items()},
                "epoch": 3}, path)
    model = get_model("emcad", device="cpu", num_classes=NC,
                      encoder="resnet18")
    assert load_reference(model, load_reference_state_dict(str(path))) == [
        "backbone.fc.weight"]
    with torch.no_grad():
        got = model.eval()(_nchw(x))
    for g, w in zip(got, want):
        assert _rel_err(g, w) < MODEL_TOL
    back = convert_state_dict(load_torch_state_dict(str(path)),
                              emcad_key_map("resnet18"), strict=False)
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                              jax.tree_util.tree_leaves_with_path(v)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))


def test_emcad_bf16_runs_in_bf16(trees):
    """bf16 compute (``set_compute_dtype``): maps in bf16 within 0.1 of
    the float32 model's on the CPU's plain kernel versions."""
    x, v, _ = trees["pvt_dual"]
    ref = _port("pvt_dual", v)
    low = _port("pvt_dual", v, torch.bfloat16)
    with torch.no_grad():
        got, want = low(_nchw(x)), ref(_nchw(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert ((g.float() - w).abs().max() / w.abs().max()).item() < 0.1


def _record(monkeypatch, calls, sites):
    for module, name in sites:
        orig = getattr(module, name)

        def wrapped(*a, _name=name, _orig=orig, **kw):
            calls.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("encoder", ["pvt_v2_b0", "resnet18"])
def test_eval_with_autograd_reaches_every_parameter(monkeypatch, encoder):
    """bf16 EMCAD in eval: under no_grad the encoder's forward-only kernel
    sites run (PVT's attention and MLP, ResNet's ``stem_pool``); with
    autograd on none of them runs, the three gates still do (the autograd
    Function), and a backward gives every parameter a finite gradient
    (fault F5's class)."""
    model = get_model("emcad", device="cpu", dtype=torch.bfloat16,
                      num_classes=NC, encoder=encoder).eval()
    kernels = ([(pvtv2, "mlp_block"), (pvtv2, "sra_attention")]
               if encoder.startswith("pvt") else [(resnet, "stem_pool")])
    calls = []
    _record(monkeypatch, calls, kernels + [(emcad, "dsra_gate")])
    x = _nchw(_input(1, seed=10, side=32))
    with torch.no_grad():
        model(x)
    assert {k for _, k in kernels} <= set(calls)
    assert calls.count("dsra_gate") == 3
    calls.clear()
    sum(o.float().square().mean() for o in model(x)).backward()
    assert calls == ["dsra_gate"] * 3
    missing = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    assert not missing, missing


def test_encoders_and_names():
    """PVTv2 keeps its drop path (0.1 at the last block, in training), as
    JAX's EMCAD builds it; an unknown encoder, activation or keyword is
    refused."""
    m = get_model("emcad", device="cpu", num_classes=NC, encoder="pvt_v2_b0")
    assert m.backbone.block4[-1].drop_path.rate == pytest.approx(0.1)
    with pytest.raises(ValueError):
        get_model("emcad", device="cpu", encoder="vgg16")
    with pytest.raises(ValueError):
        emcad.act_layer("swish")
    with pytest.raises(TypeError):
        get_model("emcad", device="cpu", encoder="resnet18",
                  drop_path_rate=0.0)

"""The port's PraNet-V1 family and ResNet against the JAX package's, on the
CPU.

Weights are drawn as in ``test_torch_port_pranet.random_variables`` (every
BatchNorm randomised) and carried into the port by ``state_dict_from_jax``,
the encoder renamed ``resnet`` where the reference names it so.  Inputs are
numpy from a seed; the port is NCHW, JAX NHWC.  PraNet-V1 runs at full
depth once (float32); every other V1 model has its encoder cut to one block
a stage on both sides, and the ResNet variants are held on the backbone
alone.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pranet2_tpu.models import get_model as jax_get_model
from pranet2_tpu.models import pranet as jax_pranet
from pranet2_tpu.models.backbones import pvtv2 as jax_pvtv2
from pranet2_tpu.models.backbones.res2net import Res2Net as JaxRes2Net
from pranet2_tpu.models.backbones.resnet import ResNet as JaxResNet
from pranet2_tpu.models.backbones.resnet import resnet as jax_resnet
from pranet2_tpu.nn import PartialDecoder as JaxPartialDecoder
from pranet2_tpu.ops import max_pool as jax_max_pool
from pranet2_tpu.ops import reverse_attention as jax_reverse_attention
from pranet2_tpu.utils.torch_convert import convert_state_dict, pranet_key_map
from pranet2_tpu_torch import get_model, ops
from pranet2_tpu_torch.models.backbones import pvtv2 as port_pvtv2
from pranet2_tpu_torch.models.backbones import resnet as port_resnet
from pranet2_tpu_torch.nn import PartialDecoder
from pranet2_tpu_torch.utils.convert import (load_jax_variables,
                                            load_reference,
                                            load_reference_state_dict,
                                            state_dict_from_jax)
from test_torch_port_pranet import random_variables

SIZE, BATCH = 64, 2
ONE = (1, 1, 1, 1)
BACKBONES = {"pranet_v1": "res2net50", "pvt_pranet_v1": "pvt_v2_b2",
             "pranet_v1_resnet": "resnet50"}


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
    """max |port - ref| over max |ref|, port NCHW, ref NHWC."""
    b = np.asarray(jnp.asarray(ref, jnp.float32))
    return float(np.abs(_nhwc(port) - b).max() / max(np.abs(b).max(), 1e-6))


def _input(seed=1, side=SIZE):
    return np.random.default_rng(seed).standard_normal(
        (BATCH, side, side, 3)).astype(np.float32)


def _one_block_pvt(monkeypatch):
    """PVTv2-b2 cut to one block a stage, in the JAX package and the port."""
    for configs in (jax_pvtv2.PVT_CONFIGS, port_pvtv2.PVT_CONFIGS):
        monkeypatch.setitem(configs, "b2", {**configs["b2"], "depths": ONE})


def _jax_v1(name, monkeypatch=None, dtype=None):
    """JAX's ``name``; with ``monkeypatch``, its encoder cut to one block a
    stage (the encoders' widths kept; PVTv2 in the port too)."""
    if monkeypatch is not None:
        if name == "pvt_pranet_v1":
            _one_block_pvt(monkeypatch)
        else:
            _one_block_jax_encoder(monkeypatch)
    return jax_get_model(name, dtype=dtype)


def _one_block_jax_encoder(monkeypatch):
    """JAX's Res2Net-50 and ResNet-50 encoders cut to one block a stage."""
    make = {"res2net50": lambda dt: JaxRes2Net(layers=ONE, dtype=dt,
                                               name="backbone"),
            "resnet50": lambda dt: JaxResNet(kind="bottleneck", layers=ONE,
                                             dtype=dt, name="backbone")}
    monkeypatch.setattr(jax_pranet, "_make_backbone", lambda kind, dt: (
        make[kind](dt), (512, 1024, 2048)))


def _port(name, variables, dtype=None, reduced=False):
    """The port's ``name`` with ``variables``; ``reduced``: one block a
    stage (PVTv2's from ``_one_block_pvt``)."""
    kw = {"layers": ONE} if reduced and name != "pvt_pranet_v1" else {}
    model = get_model(name, device="cpu", dtype=dtype, **kw)
    return load_jax_variables(model, variables).eval()


# ------------------------------------------------------------------ ops


def test_reverse_attention_matches_jax():
    rng = np.random.default_rng(0)
    crop = (rng.standard_normal((2, 11, 9, 1)) * 4).astype(np.float32)
    feat = rng.standard_normal((2, 11, 9, 7)).astype(np.float32)
    want = np.asarray(jax_reverse_attention(jnp.asarray(crop),
                                            jnp.asarray(feat)))
    got = ops.reverse_attention(_nchw(crop), _nchw(feat))
    assert tuple(got.shape) == (2, 7, 11, 9)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-6, atol=1e-6)


def test_single_head_partial_decoder_matches_jax():
    """``num_class=None``: one biased 1x1 ``conv5`` to one channel."""
    rng = np.random.default_rng(1)
    c = 8
    xs = [rng.standard_normal((2, s, s, c)).astype(np.float32)
          for s in (4, 8, 16)]
    xs_j = tuple(map(jnp.asarray, xs))
    dec = JaxPartialDecoder(c, None)

    class ThreeInputs:  # random_variables takes one input
        init = staticmethod(lambda key, xs: dec.init(key, *xs))

    v = random_variables(ThreeInputs, xs_j, seed=2)
    want = dec.apply(v, *xs_j)
    port = PartialDecoder(c, None)
    assert not hasattr(port, "conv5_fg")
    port.load_state_dict(state_dict_from_jax(v))
    with torch.no_grad():
        got = port.eval()(*map(_nchw, xs))
    assert tuple(got.shape) == (2, 1, 16, 16)
    assert _rel_err(got, want) < 2e-5


# --------------------------------------------------------------- ResNet


@pytest.mark.parametrize("variant", ["resnet18", "resnet50"])
def test_resnet_features_match_jax(variant):
    x = _input(seed=3)
    model = jax_resnet(variant)
    v = random_variables(model, jnp.asarray(x), seed=4)
    want = jax.jit(model.apply)(v, x)
    port = port_resnet.resnet(variant)
    port.load_state_dict(state_dict_from_jax(v))
    with torch.no_grad():
        got = port.eval()(_nchw(x))
    for g, w in zip(got, want, strict=True):
        assert tuple(g.shape) == (w.shape[0], w.shape[3], *w.shape[1:3])
        assert _rel_err(g, w) < 2e-5


def test_resnet_variants_have_torchvision_layouts():
    """Blocks per stage, the downsample shortcuts and the stage widths of
    every variant, and torchvision's key names (built on the meta device:
    no weights are drawn)."""
    for variant, (kind, layers) in port_resnet.LAYERS.items():
        with torch.device("meta"):
            net = port_resnet.resnet(variant)
        exp = 1 if kind == "basic" else 4
        for li, n in enumerate(layers, start=1):
            stage = getattr(net, f"layer{li}")
            assert len(stage) == n
            assert [b.downsample is not None for b in stage] == (
                [li > 1 or exp > 1] + [False] * (n - 1))
            last_bn = stage[-1].bn2 if kind == "basic" else stage[-1].bn3
            assert last_bn.num_features == 64 * 2 ** (li - 1) * exp
    with torch.device("meta"):
        keys = set(port_resnet.resnet("resnet50").state_dict())
    for k in ("conv1.weight", "bn1.running_var", "layer1.0.conv3.weight",
              "layer1.0.bn3.bias", "layer2.0.downsample.0.weight",
              "layer4.2.bn2.num_batches_tracked"):
        assert k in keys
    with pytest.raises(ValueError):
        port_resnet.resnet("resnet20")


# ------------------------------------------------------------- PraNet-V1


@pytest.fixture(scope="module")
def reduced_v1():
    """``get(name, monkeypatch)``: JAX's ``name`` with its encoder cut to
    one block a stage (patched for the calling test) and its variables,
    drawn once for the module."""
    drawn = {}

    def get(name, monkeypatch):
        model = _jax_v1(name, monkeypatch)
        if name not in drawn:
            drawn[name] = random_variables(
                model, jnp.zeros((1, SIZE, SIZE, 3)), seed=7)
        return model, drawn[name]

    return get


@pytest.mark.parametrize("dtype,tol", [("f32", 2e-5), ("bf16", 0.1)])
def test_pranet_v1_matches_jax(monkeypatch, reduced_v1, dtype, tol):
    """f32 at full depth: summation order only.  bf16 with one Res2Net
    block a stage: JAX's TPU restructures and per-step BatchNorm roundings,
    as for PraNet-V2."""
    x = _input()
    jdt, tdt = {"f32": (None, None),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    reduced = tdt is not None
    v = (reduced_v1("pranet_v1", monkeypatch)[1] if reduced else
         random_variables(jax_get_model("pranet_v1"), jnp.asarray(x), seed=5))
    want = jax.jit(jax_get_model("pranet_v1", dtype=jdt).apply)(v, x)
    with torch.no_grad():
        got = _port("pranet_v1", v, tdt, reduced=reduced)(_nchw(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == (BATCH, 1, SIZE, SIZE)
        if tdt is not None:
            assert g.dtype == tdt
        assert _rel_err(g, w) < tol


@pytest.mark.parametrize("name", ["pvt_pranet_v1", "pranet_v1_resnet"])
def test_v1_models_match_jax(monkeypatch, reduced_v1, name):
    """f32, the encoder one block a stage on both sides."""
    x = _input(seed=6)
    model, v = reduced_v1(name, monkeypatch)
    want = jax.jit(model.apply)(v, x)
    with torch.no_grad():
        got = _port(name, v, reduced=True)(_nchw(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == (BATCH, 1, SIZE, SIZE)
        assert _rel_err(g, w) < 2e-5


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_v1_state_dict_round_trip(monkeypatch, reduced_v1, name):
    """The port's state_dict -> the JAX package's converter with
    ``pranet_key_map("v1", backbone)`` -> the same tree; the encoder is
    ``resnet.*`` on Res2Net and ResNet, ``backbone.*`` on PVTv2."""
    v = reduced_v1(name, monkeypatch)[1]
    sd = _port(name, v, reduced=True).state_dict()
    enc, other = (("backbone", "resnet") if name == "pvt_pranet_v1"
                  else ("resnet", "backbone"))
    assert {k.split(".")[0] for k in sd} >= {enc, "agg1", "rfb2_1",
                                            "ra4_conv5", "ra2_conv4"}
    assert "agg1.conv5.bias" in sd
    assert not any(k.startswith(other + ".") for k in sd)
    back = convert_state_dict({k: t.numpy() for k, t in sd.items()},
                              pranet_key_map("v1", BACKBONES[name]))
    want = jax.tree_util.tree_leaves_with_path(v)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))


def test_load_jax_variables_refuses_a_v2_tree_for_v1(monkeypatch):
    _one_block_jax_encoder(monkeypatch)
    x = jnp.zeros((1, 32, 32, 3))
    v2 = random_variables(jax_get_model("pranet_v2", num_class=1), x)
    with pytest.raises(KeyError, match="conv5_fg"):
        load_jax_variables(get_model("pranet_v1", device="cpu", layers=ONE),
                           v2)


def test_v1_takes_no_num_class_and_passes_backbone_kw(monkeypatch):
    """As JAX's PraNetV1: no ``num_class``; the backbone's keyword
    arguments reach the backbone."""
    _one_block_pvt(monkeypatch)
    with pytest.raises(TypeError):
        get_model("pranet_v1", device="cpu", num_class=1)
    m = get_model("pranet_v1", device="cpu", fused=True, tailfuse=True,
                  layers=ONE)
    assert m.resnet.layer1[0].fused and m.resnet.layer1[0].tailfuse
    m = get_model("pvt_pranet_v1", device="cpu", blockfuse=True)
    assert m.backbone.blockfuse
    with pytest.raises(TypeError):
        get_model("pranet_v1_resnet", device="cpu", fused=True)


# ---------------------------------------------- F5 and F6 on the ResNet stem


def test_resnet_eval_backward_reaches_the_stem(monkeypatch):
    """F5's rule: pranet_v1_resnet in eval with autograd on takes the stem's
    module chain (no ``stem_pool`` call) and a backward gives every
    parameter, the 7x7 stem conv's too, a gradient; under no_grad the stem
    is one ``stem_pool`` call, whose maps agree with the chain's."""
    model = get_model("pranet_v1_resnet", device="cpu", layers=ONE).eval()
    calls = []
    orig = port_resnet.stem_pool

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(port_resnet, "stem_pool", counted)
    x = _nchw(_input(seed=9, side=32))
    maps = model(x)
    assert not calls
    with torch.no_grad():
        served = model(x)
    assert len(calls) == 1
    for a, b in zip(maps, served):
        assert ((a.detach() - b).abs().max() / b.abs().max()).item() < 1e-4
    sum(m.square().mean() for m in maps).backward()
    missing = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    assert not missing, missing
    assert model.resnet.conv1.weight.grad.abs().max().item() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet_training_stem_pool_sends_tied_gradients_as_jax(dtype):
    """F6's rule on the ResNet stem: with forced ties (a coarse grid, the
    ReLU's zeros) the training route's gradient in z equals ``jax.grad`` of
    JAX's ``max_pool(relu(z))`` (bn1 the identity)."""
    rng = np.random.default_rng(10)
    z = (np.round(rng.standard_normal((2, 17, 16, 64)) * 2) / 2).astype(
        np.float32)
    tdt = getattr(torch, dtype)
    net = port_resnet.resnet("resnet18").eval()  # autograd on: the chain
    with torch.no_grad():  # bn1 the identity in eval
        net.bn1.running_var.fill_(1.0 - net.bn1.eps)
    zt = _nchw(z).to(tdt).requires_grad_()
    net.stem_tail(zt).float().sum().backward()
    got = _nhwc(zt.grad)
    want = np.asarray(jax.grad(lambda a: jnp.sum(
        jax_max_pool(jax.nn.relu(a), 3, 2, 1)).astype(jnp.float32))(
        jnp.asarray(z, getattr(jnp, dtype))).astype(jnp.float32))
    assert (want == 1).sum() > 0 and (want > 1).sum() > 0
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ reference .pth


@pytest.fixture(scope="module")
def reference_sd():
    """The state dict of a one-block-a-stage pranet_v1 drawn from seed 3."""
    return get_model("pranet_v1", device="cpu", layers=ONE,
                     generator=torch.Generator().manual_seed(3)).state_dict()


@pytest.mark.parametrize("container", [None, "state_dict", "model", "net",
                                       "model_state_dict"])
def test_load_reference_state_dict_unwraps_and_drops(tmp_path, caplog,
                                                     reference_sd, container):
    """A reference-style checkpoint: ``module.`` keys (DataParallel), in a
    container or not, with a stray classifier ``resnet.fc`` and thop
    counters.  It loads into the model bit for bit; the strays are dropped
    and reported; a missing parameter or an unknown key is an error."""
    model = get_model("pranet_v1", device="cpu", layers=ONE)
    sd = reference_sd
    stray = {"resnet.fc.weight": torch.zeros(10, 2048),
             "resnet.fc.bias": torch.zeros(10),
             "total_ops": torch.zeros(()), "agg1.total_params": torch.zeros(())}
    saved = {f"module.{k}": v for k, v in {**sd, **stray}.items()}
    path = tmp_path / "ref.pth"
    torch.save(saved if container is None else
               {container: saved, "epoch": 3}, path)
    loaded = load_reference_state_dict(str(path))
    assert set(loaded) == set(sd) | set(stray)
    with caplog.at_level(logging.WARNING):
        dropped = load_reference(model, loaded)
    assert dropped == sorted(stray)
    assert "resnet.fc.weight" in caplog.text
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    with pytest.raises(KeyError, match=r"missing \['agg1.conv5.weight'\]"):
        load_reference(model, {k: v for k, v in loaded.items()
                               if k != "agg1.conv5.weight"})
    with pytest.raises(KeyError, match=r"unexpected \['ra4_conv9"):
        load_reference(model, {**loaded, "ra4_conv9.conv.weight": sd[
            "agg1.conv5.weight"]})

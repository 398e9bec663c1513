"""The port's fused Res2Net blocks against the JAX package's, on the CPU.

* The plain versions of the two Res2Net kernels (``ops.res2_tail.
  res2_tail_plain``, ``ops.res2_block.bottle2neck_plain``) against the
  Pallas kernels' bodies run by the Pallas interpreter, on the full-image
  grid and on a forced row tile (the block kernel's 3-row-halo grid).
* The BatchNorm fold and the kernels' weight layouts from a JAX tree.
* ``pranet_v2`` at depths (2, 2, 2, 2), 64x64, with ``fused`` and
  ``tailfuse`` against JAX's ``pranet_v2`` under
  ``PRANET2_FUSED=res2block,tailfuse`` with both kernels interpreted, and
  against the port's own unfused model; the routing of each branch.
* Planted faults in the plain block that the kernel checks must reject.

Inputs and weights are numpy from a seed; the port is NCHW, JAX NHWC.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pranet2_tpu.models.pranet as jax_pranet
from pranet2_tpu.models import get_model as jax_get_model
from pranet2_tpu.models.backbones.res2net import Res2Net as JaxRes2Net
from pranet2_tpu.ops import res2_block as jblock
from pranet2_tpu.ops import res2_tail as jtail
from pranet2_tpu_torch import get_model
from pranet2_tpu_torch.ops import res2_block, res2_tail
from pranet2_tpu_torch.testing import excess
from pranet2_tpu_torch.utils.convert import load_jax_variables
from test_torch_port_pranet import random_variables
import torch_res2_faults

SIZE, BATCH, LAYERS = 64, 2, (2, 2, 2, 2)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# the kernel bodies against the plain versions (testing.excess, base the
# shortcut or x, which dominate |out|): f32 differs by summation order;
# bf16 rounds at the same points, and an f32 ulp can move one rounding by
# a bf16 step (2^-7 relative at most)
KERNEL_TOL = {"f32": 2e-5, "bf16": 2 ** -7}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PRANET2_PALLAS_INTERPRET", "1")


def _bf16_values(a):
    """float32 array holding bfloat16-representable values."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _nchw(a, dtype=torch.float32):
    return _t(np.asarray(a, np.float32).transpose(0, 3, 1, 2), dtype)


def _excess(port, ref, base, dtype):
    """testing.excess of an NCHW port output against an NHWC JAX one."""
    want = _nchw(np.asarray(jnp.asarray(ref, jnp.float32)))
    return excess(port, want.to(port.dtype), base, KERNEL_TOL[dtype])


def _raw_bn(rng, c):
    """(scale, bias, mean, var) as ``testing.random_bottle2neck`` draws
    them."""
    var = 10.0 ** (-3.0 * rng.random(c))
    return [a.astype(np.float32) for a in (
        np.sqrt(var) * (1 + 0.1 * rng.standard_normal(c)),
        0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c), var)]


# ----------------------------------------------------------- kernel bodies


@pytest.mark.parametrize("ht", [None, 2])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_res2_tail_plain_matches_pallas_kernel(rng, interpret, monkeypatch,
                                               dtype, ht):
    if ht is not None:  # force the row-tiled grid on a small image
        monkeypatch.setattr(jtail, "_pick_ht", lambda *a: ht)
    cin, cout = 24, 32
    jdt, tdt = DTYPES[dtype]
    # w = 8: the TPU kernel takes only widths that are multiples of 8
    cc = np.maximum(rng.standard_normal((BATCH, 6, 8, cin)), 0)
    short = rng.standard_normal((BATCH, 6, 8, cout))
    w3 = _bf16_values(rng.standard_normal((cin, cout)) * cin ** -0.5)
    s3, t3 = jblock.fold_bn(*_raw_bn(rng, cout))
    want = jtail.fused_tail(jnp.asarray(cc, jdt), jnp.asarray(short, jdt),
                            w3, s3, t3)
    tshort = _nchw(short, tdt)
    got = res2_tail.fused_tail(_nchw(cc, tdt), tshort, _t(w3.T, tdt),
                               _t(s3), _t(t3))
    assert got.dtype == tdt and tuple(got.shape) == (BATCH, cout, 6, 8)
    assert _excess(got, want, tshort, dtype) <= 1


def _block_case(rng, dtype, raw_bns, cin=64, width=16, h=8, w=6):
    """JAX kernel arguments and the port's, the same values on both; the
    BatchNorms folded on each side by its own ``fold_bn``."""
    mk = lambda s, sc: _bf16_values(rng.standard_normal(s) * sc)
    jdt, tdt = DTYPES[dtype]
    x = rng.standard_normal((BATCH, h, w, cin))
    w1 = mk((cin, 4 * width), cin ** -0.5)
    wd = mk((3, 3, 3 * width, width), (9 * width) ** -0.5)
    w3 = mk((4, width, cin), (4 * width) ** -0.5)
    bn1, bn3 = raw_bns(4 * width), raw_bns(cin)
    bnd = [raw_bns(width) for _ in range(3)]
    jfd = [jblock.fold_bn(*b) for b in bnd]
    jargs = (jnp.asarray(x, jdt), w1, *jblock.fold_bn(*bn1), wd,
             jnp.stack([f[0] for f in jfd]), jnp.stack([f[1] for f in jfd]),
             w3, *jblock.fold_bn(*bn3))
    # [conv, di, (dj, in), out] -> [conv, out, in, di, dj]
    twd = wd.reshape(3, 3, 3, width, width).transpose(0, 4, 3, 1, 2)
    tbn = lambda b: [_t(a) for a in b]
    return jargs, (_nchw(x, tdt), _t(w1.T, tdt), tbn(bn1), _t(twd, tdt),
                   [tbn(b) for b in bnd],
                   _t(w3.reshape(4 * width, cin).T, tdt), tbn(bn3))


def _port_args(targs, fault=None):
    """The port's fused_bottle2neck arguments, BatchNorms folded with the
    port's fold (or with ``fault``'s)."""
    x, w1, bn1, wd, bnd, w3, bn3 = targs
    fold = lambda b: torch_res2_faults.fold(fault, *b)
    sd, td = (torch.stack(v) for v in zip(*map(fold, bnd)))
    return (x, w1, *fold(bn1), wd, sd, td, w3, *fold(bn3))


@pytest.mark.parametrize("ht", [None, 4])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bottle2neck_plain_matches_pallas_kernel(rng, interpret, monkeypatch,
                                                 dtype, ht):
    if ht is not None:  # force the 3-row-halo tiled grid
        monkeypatch.setattr(jblock, "_pick_ht", lambda *a: ht)
    jargs, targs = _block_case(rng, dtype, lambda c: _raw_bn(rng, c))
    want = jblock.fused_bottle2neck(*jargs)
    args = _port_args(targs)
    got = res2_block.fused_bottle2neck(*args)
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    assert _excess(got, want, args[0], dtype) <= 1


@pytest.mark.parametrize("fault", torch_res2_faults.FAULTS)
def test_kernel_checks_reject_planted_faults(rng, interpret, fault):
    """bf16: the Pallas block kernel's body is held to the port's plain
    version, and not to one with a fault planted, whose effect is small
    beside the residual."""
    jargs, targs = _block_case(rng, "bf16", lambda c: _raw_bn(rng, c))
    want = jblock.fused_bottle2neck(*jargs)
    args = _port_args(targs)
    assert _excess(res2_block.bottle2neck_plain(*args), want, args[0],
                   "bf16") <= 1
    bad = torch_res2_faults.bottle2neck(fault, *_port_args(targs, fault))
    assert _excess(bad, want, args[0], "bf16") > 1


# ------------------------------------------------------------------ models


def _input(seed=1):
    return np.random.default_rng(seed).standard_normal(
        (BATCH, SIZE, SIZE, 3)).astype(np.float32)


def _jax_model(monkeypatch, dtype, fused):
    """JAX ``pranet_v2`` with a Res2Net of depths LAYERS; ``fused`` is
    Res2Net's own field (None: the PRANET2_FUSED components decide)."""
    def make(kind, dt):
        assert kind == "res2net50"
        return (JaxRes2Net(layers=LAYERS, dtype=dt, fused=fused,
                           name="backbone"), (512, 1024, 2048))

    monkeypatch.setattr(jax_pranet, "_make_backbone", make)
    return jax_get_model("pranet_v2", num_class=1, dtype=dtype)


@pytest.fixture(scope="module")
def reduced():
    """Input and a flax tree of the depth-LAYERS pranet_v2."""
    x = _input()
    mp = pytest.MonkeyPatch()
    try:
        model = _jax_model(mp, None, None)
        return x, random_variables(model, jnp.asarray(x), seed=11)
    finally:
        mp.undo()


def _port(variables, dtype=None, **kw):
    model = get_model("pranet_v2", device="cpu", dtype=dtype, layers=LAYERS,
                      **kw)
    return load_jax_variables(model, variables).eval()


def _rel_err(port, ref):
    """max |port - ref| over max |ref|, port NCHW, ref NHWC."""
    a = port.float().permute(0, 2, 3, 1).numpy()
    b = np.asarray(jnp.asarray(ref, jnp.float32))
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


@pytest.fixture
def calls(monkeypatch):
    """Counts the calls of the two kernel wrappers (on the CPU the launch
    counters stay still)."""
    n = {"block": 0, "tail": 0}

    def spy(key, fn):
        def wrapped(*a):
            n[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(res2_block, "fused_bottle2neck",
                        spy("block", res2_block.fused_bottle2neck))
    monkeypatch.setattr(res2_tail, "fused_tail",
                        spy("tail", res2_tail.fused_tail))
    return n


# bf16: both sides take the two kernels' arithmetic in the fused blocks
# (JAX's Pallas bodies, the port's plain versions), but the rest of the
# model rounds at other points (XLA rounds each BatchNorm in bf16, the port
# once), a few bf16 steps compounded over the stem, the stage blocks' split
# convs and the heads: measured 0.059 on the maps.  f32 (fused=True only,
# as JAX's explicit field runs it): summation order only, measured 4.4e-6.
@pytest.mark.parametrize("dtype,tol", [("bf16", 0.1), ("f32", 1e-4)])
def test_fused_pranet_v2_matches_jax_kernels(reduced, interpret, monkeypatch,
                                             calls, dtype, tol):
    x, v = reduced
    jdt, tdt = DTYPES[dtype]
    if dtype == "bf16":
        monkeypatch.setenv("PRANET2_FUSED", "res2block,tailfuse")
        jmodel, kw = _jax_model(monkeypatch, jdt, None), dict(tailfuse=True)
    else:
        jmodel, kw = _jax_model(monkeypatch, None, True), {}
    want = jax.jit(jmodel.apply)(v, x)
    port = _port(v, None if dtype == "f32" else tdt, fused=True, **kw)
    with torch.no_grad():
        got = port(_nchw(x))
    # 4 normal blocks through the block kernel; in bf16 the 4 stage blocks'
    # tails through the tail kernel
    assert calls == {"block": 4, "tail": 4 if dtype == "bf16" else 0}
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert tuple(g.shape) == (BATCH, 1, SIZE, SIZE) and g.dtype == tdt
        assert _rel_err(g, w) < tol


def _features_close(got, want):
    """The four Res2Net stages within JAX's own limit for its fused blocks
    against its module chain in bf16 (tests/test_stem_s2d.py)."""
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = w.float()
        assert ((g.float() - w).abs().max() / w.abs().max()).item() < 0.06


def test_fused_res2net_matches_unfused(reduced, calls):
    """bf16, the port's fused Res2Net against its module chain."""
    x, v = reduced
    with torch.no_grad():
        xb = _nchw(x, torch.bfloat16)
        got = _port(v, torch.bfloat16, fused=True, tailfuse=True).backbone(xb)
        assert calls == {"block": 4, "tail": 4}
        want = _port(v, torch.bfloat16).backbone(xb)
    assert calls == {"block": 4, "tail": 4}
    _features_close(got, want)


def test_tailfuse_runs_the_tail_on_all_16_blocks(calls):
    """Full depth, tailfuse only, bf16: every Bottle2neck's tail goes
    through the tail kernel, f32 and training take the module chain."""
    x = _nchw(_input(seed=3), torch.bfloat16)
    kw = dict(device="cpu", dtype=torch.bfloat16)
    fused = get_model("pranet_v2", tailfuse=True, **kw).eval()
    plain = get_model("pranet_v2", **kw).eval()
    with torch.no_grad():
        got = fused.backbone(x)
        assert calls == {"block": 0, "tail": 16}
        want = plain.backbone(x)
        get_model("pranet_v2", device="cpu", tailfuse=True).eval()(x)
        fused.train()(x)
    assert calls == {"block": 0, "tail": 16}
    _features_close(got, want)


def test_fused_branches_keep_the_state_dict(reduced, calls):
    """``fused`` and ``tailfuse`` change no parameter or buffer name or
    shape; in training mode the fused model is the module chain."""
    x, v = reduced
    a = _port(v).state_dict()
    fused = _port(v, fused=True, tailfuse=True)
    b = fused.state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape for k in a)
    with torch.no_grad():
        fused.train()(_nchw(x))
    assert calls == {"block": 0, "tail": 0}
    with pytest.raises(TypeError):
        get_model("pvt_pranet_v2", device="cpu", fused=True)


def test_fold_and_layouts_from_a_jax_tree(reduced):
    """A JAX tree loaded into the port gives the block kernel the JAX
    holders' numbers (res2net.py's fused branch): w1 (Cin, 4w), wd (3, 3,
    3w, w) as [conv, di, (dj, in), out], w3 (4, w, Cout), in the port's
    layouts (4w, Cin), (3, w, w, 3, 3) OIHW, (Cout, 4w); the folds agree
    to float32 rounding."""
    _, v = reduced
    port = _port(v).backbone
    for name, block in (("layer1_1", port.layer1[1]),
                        ("layer4_1", port.layer4[1])):
        p = v["params"]["backbone"][name]
        stats = v["batch_stats"]["backbone"][name]
        w = block.width
        cin, cout = p["conv1"]["kernel"].shape[2], p["conv3"]["kernel"].shape[3]
        fold = lambda bn: jblock.fold_bn(p[bn]["scale"], p[bn]["bias"],
                                         stats[bn]["mean"], stats[bn]["var"])
        w1 = p["conv1"]["kernel"].reshape(cin, 4 * w)
        wd = np.stack([p[f"convs_{i}"]["kernel"].reshape(3, 3 * w, w)
                       for i in range(3)])
        w3 = p["conv3"]["kernel"].reshape(4, w, cout)
        sd, td = zip(*(fold(f"bns_{i}") for i in range(3)))
        want = (w1.T, *fold("bn1"),
                wd.reshape(3, 3, 3, w, w).transpose(0, 4, 3, 1, 2),
                np.stack(sd), np.stack(td),
                w3.reshape(4 * w, cout).T, *fold("bn3"))
        got = block.fused_args()
        assert len(got) == len(want)
        for i, (g, e) in enumerate(zip(got, want)):
            assert g.dtype == torch.float32 and g.is_contiguous()
            if i in (0, 3, 6):  # the weights, carried exactly
                np.testing.assert_array_equal(g.detach().numpy(), e)
            else:  # rsqrt and the products round on each side: a few
                # float32 ulp of the largest value
                e = np.asarray(e)
                np.testing.assert_allclose(g.detach().numpy(), e, rtol=0,
                                           atol=1e-6 * np.abs(e).max())

"""The port's PVTv2 slice against the JAX package's, on the CPU.

* The plain versions of the two PVT kernels (``ops.pvt_mlp.mlp_block_plain``
  in its three modes, ``ops.pvt_attn.sra_attention_plain``) against the
  Pallas kernels' bodies run by the Pallas interpreter, with the row tile
  forced small so that the halo tiling runs.
* PVTv2-b2 and ``pvt_pranet_v2`` against the JAX model at 64x64, batch 2:
  in float32 both sides take the module chain; in bfloat16 the port takes
  the kernels' plain versions and JAX its XLA references.
* A PVTv2 of reduced depth in bfloat16 against the JAX model with its
  kernels in the interpreter: the wiring of the stats and final_ln modes.
* The state-dict round trip and the ``BinaryPredictor``.

Inputs and weights are numpy from a seed; the port is NCHW at the model's
boundary and channels-last inside the backbone, JAX NHWC throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pranet2_tpu.models import get_model as jax_get_model
from pranet2_tpu.models.backbones.pvtv2 import PVT_CONFIGS as JAX_CONFIGS
from pranet2_tpu.models.backbones.pvtv2 import PVTv2 as JaxPVTv2
from pranet2_tpu.ops import pvt_attn as jattn
from pranet2_tpu.ops import pvt_mlp as jmlp
from pranet2_tpu.serve import BinaryPredictor as JaxPredictor
from pranet2_tpu.utils.torch_convert import convert_state_dict, pranet_key_map
from pranet2_tpu_torch import get_model
from pranet2_tpu_torch.models.backbones.pvtv2 import PVT_CONFIGS, PVTv2
from pranet2_tpu_torch.nn import LayerNorm, set_compute_dtype
from pranet2_tpu_torch.ops import pvt_attn, pvt_mlp
from pranet2_tpu_torch.serve import BinaryPredictor
from pranet2_tpu_torch.testing import excess
from pranet2_tpu_torch.utils.convert import (load_jax_variables,
                                             state_dict_from_jax)
from test_torch_port_pranet import random_variables
import torch_pvt_faults

SIZE, BATCH = 64, 2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# the kernel bodies against the plain versions (testing.excess: within a
# share of the largest |kernel part|, the output less its residual or, with
# the stage LN, less LN(x), plus half a step of each side's last rounding):
# f32 differs by summation order; bf16 rounds at the same points, and an
# f32 ulp can move one rounding by a bf16 step (2^-7 relative at most)
KERNEL_TOL = {"f32": 1e-5, "bf16": 2 ** -7}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PRANET2_PALLAS_INTERPRET", "1")


def _rel_err(port, ref):
    """max |port - ref| over max |ref|; both channels-last."""
    a = port.float().numpy() if torch.is_tensor(port) else port
    b = np.asarray(jnp.asarray(ref, jnp.float32))
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def _excess(port, ref, base, dtype):
    """testing.excess of the port's output against a JAX output."""
    want = torch.from_numpy(np.asarray(jnp.asarray(ref, jnp.float32)))
    return excess(port, want.to(port.dtype), base, KERNEL_TOL[dtype])


def _mlp_base(targs, **kw):
    """The block without its MLP: fc2 zeroed leaves x, or LN(x)."""
    out = pvt_mlp.mlp_block(*targs[:7], torch.zeros_like(targs[7]),
                            torch.zeros_like(targs[8]), 1e-6, **kw)
    return out[0] if isinstance(out, tuple) else out


def _bf16_values(a):
    """float32 array holding bfloat16-representable values."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


# ----------------------------------------------------------- kernel bodies


def _mlp_case(rng, dtype, n=2, h=6, w=8, d=32, c=64):
    """JAX kernel arguments and the port's, the same values on both."""
    mk = lambda s, sc=0.2, sh=0.0: _bf16_values(
        rng.standard_normal(s) * sc + sh)
    x = rng.standard_normal((n, h, w, d)).astype(np.float32)
    lns, lnb = mk((d,), 0.2, 1.0), mk((d,))
    w1, b1, dwk, dwb = mk((d, c)), mk((c,)), mk((3, 3, c)), mk((c,))
    w2, b2 = mk((c, d)), mk((d,))
    jdt, tdt = DTYPES[dtype]
    jargs = (jnp.asarray(x, jdt), lns, lnb, w1, b1, dwk, dwb, w2, b2)
    targs = (_t(x, tdt), _t(lns), _t(lnb), _t(w1.T, tdt), _t(b1, tdt),
             _t(dwk.transpose(2, 0, 1)[:, None], tdt), _t(dwb, tdt),
             _t(w2.T, tdt), _t(b2, tdt))
    return jargs, targs


@pytest.mark.parametrize("ht", [2, 3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["plain", "stats", "final_ln"])
def test_mlp_plain_matches_pallas_kernel(rng, interpret, monkeypatch, mode,
                                         dtype, ht):
    monkeypatch.setattr(jmlp, "_pick_ht", lambda *a: ht)
    jargs, targs = _mlp_case(rng, dtype)
    d = jargs[0].shape[-1]
    tol = KERNEL_TOL[dtype]
    kw = {}
    if mode == "plain":
        want = jmlp.fused_mlp_block(*jargs, 1e-6)
        got = pvt_mlp.mlp_block(*targs, 1e-6)
    elif mode == "stats":
        want, mu, rstd = jmlp.fused_mlp_block_stats(*jargs, 1e-6, 1e-6)
        got, tmu, trstd = pvt_mlp.mlp_block(*targs, 1e-6, stats_eps=1e-6)
        assert tmu.dtype == trstd.dtype == torch.float32
        # the statistics of outputs that agree to a bf16 step
        assert _rel_err(tmu, mu) < tol
        assert _rel_err(trstd, rstd) < tol
    else:
        fs = _bf16_values(rng.standard_normal(d) * 0.2 + 1.0)
        fb = _bf16_values(rng.standard_normal(d) * 0.2)
        want = jmlp.fused_mlp_block_final_ln(*jargs, fs, fb, 1e-6, 1e-6)
        kw = {"final_ln": (_t(fs), _t(fb))}
        got = pvt_mlp.mlp_block(*targs, 1e-6, **kw)
    assert got.dtype == targs[0].dtype and tuple(got.shape) == want.shape
    assert _excess(got, want, _mlp_base(targs, **kw), dtype) <= 1


def _sra_case(rng, dtype, n=2, h=6, w=8, d=64, nh=2, tkv=6):
    """JAX kernel arguments and the port's, the same values on both."""
    hd = d // nh
    mk = lambda s, sc=0.2, sh=0.0: _bf16_values(
        rng.standard_normal(s) * sc + sh)
    x = rng.standard_normal((n, h, w, d)).astype(np.float32)
    lns, lnb = mk((d,), 0.2, 1.0), mk((d,))
    wq, bq = mk((nh, d, hd)), mk((nh, hd))
    kt, v = mk((n, nh, hd, tkv), 1.0), mk((n, nh, tkv, hd), 1.0)
    wp, bp = mk((d, d)), mk((d,))
    jdt, tdt = DTYPES[dtype]
    jargs = (jnp.asarray(x, jdt), lns, lnb, wq, bq, kt, v, wp, bp)
    k_tok = kt.transpose(0, 3, 1, 2).reshape(n, tkv, d)
    v_tok = v.transpose(0, 2, 1, 3).reshape(n, tkv, d)
    targs = (_t(x, tdt), _t(lns), _t(lnb),
             _t(wq.transpose(0, 2, 1).reshape(d, d), tdt),
             _t(bq.reshape(d), tdt),
             _t(np.concatenate([k_tok, v_tok], -1), tdt), _t(wp.T, tdt),
             _t(bp, tdt), nh)
    return jargs, targs


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sra_attention_plain_matches_pallas_kernel(rng, interpret,
                                                   monkeypatch, dtype):
    monkeypatch.setattr(jattn, "_pick_ht", lambda *a: 3)
    jargs, targs = _sra_case(rng, dtype)
    want = jattn.fused_sra_attention(*jargs, 1e-6)
    got = pvt_attn.sra_attention(*targs, 1e-6)
    assert got.dtype == targs[0].dtype and tuple(got.shape) == want.shape
    assert _excess(got, want, targs[0], dtype) <= 1


@pytest.mark.parametrize("fault", ["dw_bias_dropped", "pad_before_bias",
                                   "q_bias_dropped",
                                   *torch_pvt_faults.ATTN_FAULTS])
def test_kernel_checks_reject_planted_faults(rng, interpret, fault):
    """bf16: the Pallas kernel bodies are held to the port's plain version,
    and not to one with a fault planted in the kernel's part, whose effect
    is small beside the residual."""
    if fault in torch_pvt_faults.ATTN_FAULTS:
        jargs, targs = _sra_case(rng, "bf16")
        want = jattn.fused_sra_attention(*jargs, 1e-6)
        got = pvt_attn.sra_attention(*targs, 1e-6)
        bad = torch_pvt_faults.sra_attention(fault, *targs, 1e-6)
        base = targs[0]
    elif fault == "q_bias_dropped":
        jargs, targs = _sra_case(rng, "bf16")
        want = jattn.fused_sra_attention(*jargs, 1e-6)
        got = pvt_attn.sra_attention(*targs, 1e-6)
        bad = pvt_attn.sra_attention(*targs[:4], torch.zeros_like(targs[4]),
                                     *targs[5:], 1e-6)
        base = targs[0]
    else:
        jargs, targs = _mlp_case(rng, "bf16")
        if fault == "pad_before_bias":
            # with a zero LN bias, a ring of zero tokens around x gives fc1
            # outputs equal to b1 there: zero padding applied before the
            # bias
            jargs = (*jargs[:2], np.zeros_like(jargs[2]), *jargs[3:])
            targs = (*targs[:2], torch.zeros_like(targs[2]), *targs[3:])
            ring = torch.nn.functional.pad(targs[0], (0, 0, 1, 1, 1, 1))
            bad = pvt_mlp.mlp_block(ring, *targs[1:], 1e-6)[:, 1:-1, 1:-1]
        else:
            bad = pvt_mlp.mlp_block(*targs[:6], torch.zeros_like(targs[6]),
                                    *targs[7:], 1e-6)
        want = jmlp.fused_mlp_block(*jargs, 1e-6)
        got = pvt_mlp.mlp_block(*targs, 1e-6)
        base = _mlp_base(targs)
    assert _excess(got, want, base, "bf16") <= 1
    assert _excess(bad, want, base, "bf16") > 1


def test_gelu_poly_is_close_to_exact_gelu():
    x = torch.linspace(-8, 8, 4001)
    # the fit's erf error is under 8.9e-4 inside the clip and the clip
    # adds at most 4.7e-4 beyond it: GELU within |x| * (8.9e-4 + 4.7e-4) / 2
    err = (pvt_mlp.gelu_poly(x) - torch.nn.functional.gelu(x)).abs()
    assert bool((err <= 6.8e-4 * x.abs() + 1e-7).all()), err.max()


# ------------------------------------------------------------------ models


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _input(channels, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (BATCH, SIZE, SIZE, channels)).astype(np.float32)


@pytest.fixture(scope="module")
def rgb():
    x = _input(3)
    model = jax_get_model("pvt_pranet_v2", num_class=1)
    return x, random_variables(model, jnp.asarray(x), seed=6)


def _port(variables, dtype=None):
    model = get_model("pvt_pranet_v2", device="cpu", dtype=dtype)
    return load_jax_variables(model, variables).eval()


# f32: both sides take the module chain, so only the summation order
# differs (measured 2e-6).  bf16: the port takes the kernels' arithmetic (polynomial erf,
# f32 hidden, one rounding per kernel output) and JAX on the CPU its XLA
# references (exact erf, a bf16 rounding at each op), so the two bf16
# programs differ by a few bf16 steps compounded over 16 blocks (measured
# 0.018 on the features, 0.034 on the maps).
@pytest.mark.parametrize("dtype,tol", [("f32", 2e-5), ("bf16", 0.1)])
def test_pvt_v2_features_match_jax(rgb, dtype, tol):
    x, v = rgb
    jdt, tdt = DTYPES[dtype]
    sub = {k: v[k]["backbone"] for k in v if "backbone" in v[k]}
    jmodel = JaxPVTv2(**JAX_CONFIGS["b2"],
                      dtype=None if dtype == "f32" else jdt)
    want = jax.jit(jmodel.apply)(sub, x)
    port = _port(v, None if dtype == "f32" else tdt).backbone
    assert isinstance(port, PVTv2)
    with torch.no_grad():
        got = port(_nchw(x).to(tdt))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == (w.shape[0], w.shape[3], *w.shape[1:3])
        assert g.dtype == tdt and g.is_contiguous()
        assert _rel_err(g.permute(0, 2, 3, 1), w) < tol


@pytest.mark.parametrize("dtype,tol", [("f32", 2e-5), ("bf16", 0.1)])
def test_pvt_pranet_v2_matches_jax(rgb, dtype, tol):
    x, v = rgb
    jdt, tdt = DTYPES[dtype]
    jmodel = jax_get_model("pvt_pranet_v2", num_class=1,
                           dtype=None if dtype == "f32" else jdt)
    want = jax.jit(jmodel.apply)(v, x)
    before = (pvt_mlp.mlp_block.launches, pvt_attn.sra_attention.launches)
    with torch.no_grad():
        got = _port(v, None if dtype == "f32" else tdt)(_nchw(x))
    # on the CPU the wrappers run the plain versions and count nothing
    assert (pvt_mlp.mlp_block.launches,
            pvt_attn.sra_attention.launches) == before
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert tuple(g.shape) == (BATCH, 1, SIZE, SIZE) and g.dtype == tdt
        assert _rel_err(g.permute(0, 2, 3, 1), w) < tol


def test_reduced_pvt_bf16_matches_pallas_kernels(interpret):
    """Depths (2, 2, 1, 1) in bf16, JAX with both kernels in the Pallas
    interpreter: stats mode in the first block of stages 1-2, final_ln mode
    in the last block of every stage, held against the port's routing."""
    cfg = dict(JAX_CONFIGS["b2"], depths=(2, 2, 1, 1))
    x = _input(3, seed=7)
    jmodel = JaxPVTv2(**cfg, dtype=jnp.bfloat16)
    v = random_variables(jmodel, jnp.asarray(x), seed=8)
    # every parameter bf16-representable: the Pallas kernels read their
    # biases and taps in f32, the port's bf16 model holds them in bf16
    v = jax.tree.map(_bf16_values, v)
    want = jax.jit(jmodel.apply)(v, x)
    sd = state_dict_from_jax({"params": {"backbone": v["params"]}})
    port = PVTv2(**cfg)
    port.load_state_dict({k.removeprefix("backbone."): t
                          for k, t in sd.items()})
    port = set_compute_dtype(port, torch.bfloat16).eval()
    with torch.no_grad():
        got = port(_nchw(x).bfloat16())
    for g, w in zip(got, want):
        # the K/V path, patch embeds and LayerNorms round at other points
        # on the two sides (XLA adds the conv and dense biases after a
        # bf16 rounding): measured 0.016; a wrong mode or a missing stage
        # LN is O(1)
        assert _rel_err(g.permute(0, 2, 3, 1), w) < 0.04


@pytest.fixture(scope="module")
def gray():
    x = _input(1, seed=2)
    model = jax_get_model("pvt_pranet_v2", num_class=1)
    return x, random_variables(model, jnp.asarray(x), seed=3)


def test_state_dict_round_trip(gray):
    """port state_dict -> the JAX package's converter -> the same tree."""
    _, v = gray
    back = convert_state_dict(
        {k: t.numpy() for k, t in _port(v).state_dict().items()},
        pranet_key_map("v2", "pvt_v2_b2"))
    want = jax.tree_util.tree_leaves_with_path(v)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))


def test_grayscale_stem_matches_jax(gray):
    x, v = gray
    want = jax.jit(jax_get_model("pvt_pranet_v2", num_class=1).apply)(v, x)
    with torch.no_grad():
        got = _port(v)(_nchw(x))
    for g, w in zip(got, want):
        assert _rel_err(g.permute(0, 2, 3, 1), w) < 1e-4


def test_compute_dtype_keeps_layernorm_f32():
    model = get_model("pvt_pranet_v2", device="cpu", dtype=torch.bfloat16)
    blk = model.backbone.block1[0]
    assert blk.mlp.fc1.weight.dtype == blk.attn.kv.bias.dtype == torch.bfloat16
    assert blk.mlp.dwconv.dwconv.weight.dtype == torch.bfloat16
    norms = [m for m in model.modules() if isinstance(m, LayerNorm)]
    # patch_embed, norm1, norm2, and attn.norm where sr > 1, per block;
    # the stage norms
    assert len(norms) == 4 + 4 + 2 * 16 + 13
    assert all(p.dtype == torch.float32 for m in norms
               for p in m.parameters())


def test_pvt_configs_match_jax():
    assert PVT_CONFIGS == JAX_CONFIGS


def test_layer_norm_matches_flax_bf16(rng):
    import flax.linen as fnn

    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = rng.normal(0, 0.1, 64).astype(np.float32)
    want = fnn.LayerNorm(epsilon=1e-6, dtype=jnp.bfloat16).apply(
        {"params": {"scale": scale, "bias": bias}},
        jnp.asarray(x, jnp.bfloat16))
    ln = LayerNorm(64, eps=1e-6)
    with torch.no_grad():
        ln.weight.copy_(_t(scale))
        ln.bias.copy_(_t(bias))
        got = ln(_t(x, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of results that agree in f32 to a few ulp
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2 ** -8, atol=2 ** -8)


# ----------------------------------------------------------------- serving

TESTSIZE = 64


@pytest.fixture(scope="module")
def weights():
    v = random_variables(jax_get_model("pvt_pranet_v2", num_class=1),
                         jnp.zeros((1, TESTSIZE, TESTSIZE, 3)), seed=5)
    port = load_jax_variables(get_model("pvt_pranet_v2", device="cpu"), v)
    return v, port.state_dict()


def test_predictor_matches_jax(weights):
    """Three images of different native sizes at batch 2 (one full batch,
    one padded), float32 on both sides."""
    v, sd = weights
    rng = np.random.default_rng(4)
    images = [(rng.random((40 + 7 * i, 50 + 3 * i, 3)) * 255).astype(np.uint8)
              for i in range(3)]
    port = BinaryPredictor("pvt_pranet_v2", sd, batch_size=BATCH,
                           testsize=TESTSIZE, device="cpu")
    want = JaxPredictor("pvt_pranet_v2", v, batch_size=BATCH,
                        testsize=TESTSIZE)(images)
    got = port(images)
    port.close()
    assert len(got) == len(want) == 3
    for im, g, w in zip(images, got, want):
        assert g.shape == im.shape[:2] and g.dtype == np.uint8
        # f32 logits agree to ~1e-5 relative; a pixel on a uint8
        # quantisation boundary may land one level apart
        diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
        assert diff.max() <= 1, diff.max()

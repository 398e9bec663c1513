"""The port's opt-in PVT kernels against the JAX package's, on the CPU.

* The plain versions of the three kernels of this slice against the Pallas
  kernels' bodies run by the Pallas interpreter: ``sra_block_plain``
  against ``fused_sra_block`` (``_kernel_v2``) and ``pvt_block_plain``
  against ``fused_pvt_block`` (``_kernel_v3``) at every PVTv2-b2 stage's
  (sr, heads), ``depthwise_conv3x3_plain`` against ``_dw_kernel`` (and
  against XLA's convolution at ``precision=HIGHEST``).
* A PVTv2 of reduced depth in bfloat16, the port's ``attn_impl="v2"`` and
  ``blockfuse=True`` against the JAX model with the kernels interpreted
  under ``PVT_ATTN_IMPL=v2`` and ``fused_block=True``.
* ``pvt_pranet_v2`` with each option on the port alone (full depth, 64x64):
  the wrappers each block calls, and the maps against the float32 module
  chain of the same weights.
* The ``attn_impl`` routing against the JAX package's, and planted faults
  (``torch_pvt_faults``) that each check must reject.

Inputs and weights are numpy from a seed; the port's tokens are
channels-last like JAX's, its model input NCHW.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import pranet2_tpu.ops.pvt_attn as jattn
import pranet2_tpu.ops.pvt_block as jblock
from pranet2_tpu.models.backbones.pvtv2 import PVT_CONFIGS as JAX_CONFIGS
from pranet2_tpu.models.backbones.pvtv2 import PVTv2 as JaxPVTv2
from pranet2_tpu.ops import dwconv as jdw
from pranet2_tpu_torch import get_model
from pranet2_tpu_torch.models.backbones import pvtv2
from pranet2_tpu_torch.nn import set_compute_dtype
from pranet2_tpu_torch.ops import dwconv, pvt_attn
from pranet2_tpu_torch.ops.pvt_block import pvt_block
from pranet2_tpu_torch.testing import excess
from pranet2_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_port_pranet import random_variables
import torch_pvt_faults

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# the kernel bodies against the plain versions (testing.excess, base x:
# everything else is the kernels' part): f32 differs by summation order;
# bf16 rounds at the same points, and an f32 ulp can move one rounding by a
# bf16 step (2^-7 relative at most)
KERNEL_TOL = {"f32": 1e-5, "bf16": 2 ** -7}
# (sr, heads) of the four PVTv2-b2 stages
STAGES = [(8, 1), (4, 2), (2, 5), (1, 8)]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PRANET2_PALLAS_INTERPRET", "1")


def _bf16_values(a):
    """float32 array holding bfloat16-representable values."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def _excess(port, ref, base, dtype):
    """testing.excess of the port's output against a JAX output."""
    want = torch.from_numpy(np.asarray(jnp.asarray(ref, jnp.float32)))
    return excess(port, want.to(port.dtype), base, KERNEL_TOL[dtype])


# ----------------------------------------------------------- kernel bodies


def _block_case(rng, dtype, sr, nh, n=2, h=8, w=8, hd=8, ratio=4):
    """The JAX kernels' arguments and the port's, the same values on both:
    the attention half's (sra) and the MLP's (mlp)."""
    d, c = nh * hd, nh * hd * ratio
    mk = lambda s, sc=0.2, sh=0.0: _bf16_values(
        rng.standard_normal(s) * sc + sh)
    x = rng.standard_normal((n, h, w, d)).astype(np.float32)
    lns, lnb = mk((d,), 0.2, 1.0), mk((d,))
    wq, bq = mk((nh, d, hd)), mk((nh, hd))
    ksr = mk((sr, sr, d, d), 0.2 / sr)                   # HWIO
    bsr, lks, lkb = mk((d,)), mk((d,), 0.2, 1.0), mk((d,))
    wkv, bkv, wp, bp = mk((d, 2 * d)), mk((2 * d,)), mk((d, d)), mk((d,))
    jdt, tdt = DTYPES[dtype]
    if sr > 1:
        jsr = (ksr.reshape(sr * sr * d, d), bsr, lks, lkb)
        tsr = (_t(ksr.transpose(3, 2, 0, 1), tdt), _t(bsr, tdt), _t(lks),
               _t(lkb))
    else:
        jsr = (np.zeros((1, d), np.float32), np.zeros(d, np.float32),
               np.ones(d, np.float32), np.zeros(d, np.float32))
        tsr = (None,) * 4
    jsra = (jnp.asarray(x, jdt), lns, lnb, wq, bq, *jsr, wkv, bkv, wp, bp)
    tsra = (_t(x, tdt), _t(lns), _t(lnb),
            _t(wq.transpose(0, 2, 1).reshape(d, d), tdt),
            _t(bq.reshape(d), tdt), *tsr, _t(wkv.T, tdt), _t(bkv, tdt),
            _t(wp.T, tdt), _t(bp, tdt))
    l2s, l2b = mk((d,), 0.2, 1.0), mk((d,))
    w1, b1, dwk, dwb = mk((d, c)), mk((c,)), mk((3, 3, c)), mk((c,))
    w2, b2 = mk((c, d)), mk((d,))
    jmlp = (l2s, l2b, w1, b1, dwk, dwb, w2, b2)
    tmlp = (_t(l2s), _t(l2b), _t(w1.T, tdt), _t(b1, tdt),
            _t(dwk.transpose(2, 0, 1)[:, None], tdt), _t(dwb, tdt),
            _t(w2.T, tdt), _t(b2, tdt))
    return jsra, tsra, jmlp, tmlp


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sr,nh", STAGES)
def test_sra_block_plain_matches_pallas_kernel(rng, interpret, sr, nh,
                                               dtype):
    jsra, tsra, _, _ = _block_case(rng, dtype, sr, nh)
    want = jattn.fused_sra_block(*jsra, sr, nh, 1e-6)
    got = pvt_attn.sra_block(*tsra, nh, sr, 1e-6)
    assert got.dtype == tsra[0].dtype and tuple(got.shape) == want.shape
    assert _excess(got, want, tsra[0], dtype) <= 1


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sr,nh", STAGES)
def test_pvt_block_plain_matches_pallas_kernel(rng, interpret, sr, nh,
                                               dtype):
    jsra, tsra, jmlp, tmlp = _block_case(rng, dtype, sr, nh)
    want = jblock.fused_pvt_block(*jsra, *jmlp, sr, nh, 1e-6, 1e-6)
    got = pvt_block(*tsra, *tmlp, nh, sr, 1e-6, 1e-6)
    assert got.dtype == tsra[0].dtype and tuple(got.shape) == want.shape
    assert _excess(got, want, tsra[0], dtype) <= 1


@pytest.mark.parametrize("h,w", [(9, 13), (7, 5)])
def test_sra_block_plain_takes_the_convolutions_floor(rng, h, w):
    """H, W not multiples of sr: the XLA reference's VALID convolution, in
    float32, where it rounds nowhere, is the plain version's function."""
    jsra, tsra, _, _ = _block_case(rng, "f32", 4, 2, h=h, w=w)
    want = jattn.reference_sra_block(*jsra, sr=4, nh=2)
    got = pvt_attn.sra_block(*tsra, 2, 4)
    assert _excess(got, want, tsra[0], "f32") <= 1


def _dw_pallas(x, w):
    """``_dw_kernel`` in the Pallas interpreter, one image a grid step
    (``depthwise_conv3x3`` takes XLA's convolution off a TPU)."""
    n, h, wd, c = x.shape
    img = pl.BlockSpec((1, h, wd, c), lambda i: (i, 0, 0, 0))
    return pl.pallas_call(
        jdw._dw_kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        grid=(n,),
        in_specs=[img, pl.BlockSpec((3, 3, c), lambda i: (0, 0, 0))],
        out_specs=img, interpret=True)(x, w)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dwconv_plain_matches_pallas_kernel(rng, dtype):
    x = rng.standard_normal((2, 7, 9, 24)).astype(np.float32)
    w = rng.standard_normal((3, 3, 24)).astype(np.float32) / 3
    jdt, tdt = DTYPES[dtype]
    if dtype == "bf16":
        w = _bf16_values(w)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    got = dwconv.depthwise_conv3x3(_t(x, tdt), _t(w, tdt))
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    # f32: the same nine sums in the same order, within 1e-5 of max |out|
    # (XLA may fuse a product into its sum); bf16: the output's rounding,
    # one step
    tol = 1e-5 if dtype == "f32" else 0.0
    for want in (_dw_pallas(jx, jw),
                 jdw._xla_dwconv(jx, jw, precision=jax.lax.Precision.HIGHEST)):
        want = torch.from_numpy(np.asarray(jnp.asarray(want, jnp.float32)))
        assert excess(got, want.to(tdt), None, tol) <= 1


# ------------------------------------------------------------------ faults


def _fault_case(rng, fault):
    """(got, want, bad, base): the port's plain version, the Pallas body's
    output, the faulty copy's, and the check's base."""
    if fault == "dw_taps_transposed":
        x = rng.standard_normal((2, 6, 8, 16)).astype(np.float32)
        w = rng.standard_normal((3, 3, 16)).astype(np.float32) / 3
        want = _dw_pallas(jnp.asarray(x), jnp.asarray(w))
        tx, tw = _t(x), _t(w)
        return (dwconv.depthwise_conv3x3(tx, tw), want,
                torch_pvt_faults.depthwise_conv3x3(fault, tx, tw), None)
    jsra, tsra, jmlp, tmlp = _block_case(rng, "bf16", 4, 2)
    if fault in torch_pvt_faults.BLOCK_FAULTS:
        want = jblock.fused_pvt_block(*jsra, *jmlp, 4, 2, 1e-6, 1e-6)
        return (pvt_block(*tsra, *tmlp, 2, 4),
                want, torch_pvt_faults.pvt_block(fault, *tsra, *tmlp,
                                                 num_heads=2, sr=4),
                tsra[0])
    want = jattn.fused_sra_block(*jsra, 4, 2, 1e-6)
    return (pvt_attn.sra_block(*tsra, 2, 4), want,
            torch_pvt_faults.sra_block(fault, *tsra, 2, 4), tsra[0])


@pytest.mark.parametrize("fault", torch_pvt_faults.FAULTS)
def test_kernel_checks_reject_planted_faults(rng, interpret, fault):
    """bf16 (float32 for the depthwise conv): the Pallas kernel bodies are
    held to the port's plain versions, and not to one with a fault
    planted."""
    got, want, bad, base = _fault_case(rng, fault)
    dtype = "f32" if fault == "dw_taps_transposed" else "bf16"
    assert _excess(got, want, base, dtype) <= 1
    assert _excess(bad, want, base, dtype) > 1


# ------------------------------------------------------------------ models


def test_attn_impl_routing_matches_jax(monkeypatch):
    """Which kernel JAX's model calls in each stage under PVT_ATTN_IMPL,
    traced without compiling, against ``stage_route``."""
    calls = []
    for name in ("fused_sra_attention", "fused_sra_block"):
        f = getattr(jattn, name)
        monkeypatch.setattr(jattn, name, lambda *a, _f=f, _n=name: (
            calls.append(_n), _f(*a))[1])
    jmodel = JaxPVTv2(embed_dims=(8, 16, 32, 64), depths=(1, 1, 1, 1),
                      num_heads=(1, 2, 4, 8), mlp_ratios=(2, 2, 2, 2),
                      dtype=jnp.bfloat16)
    x = jnp.zeros((1, 32, 32, 3))
    names = {"fused_sra_attention": "v1", "fused_sra_block": "v2"}
    for impl in ("v1", "v2", "auto", "auto:1", "auto:2", "auto:4", "auto:8"):
        monkeypatch.setenv("PVT_ATTN_IMPL", impl)
        calls.clear()
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x)
        want = [names[c] for c in calls]
        got = [pvtv2.stage_route(True, False, False, impl, False, sr)
               for sr in pvtv2.SR_RATIOS]
        assert got == want, impl
    with pytest.raises(ValueError):
        pvtv2.PVTv2(depths=(1, 1, 1, 1), attn_impl="v3")
    assert pvtv2.stage_route(False, False, False, "v2", True, 8) == "chain"
    assert pvtv2.stage_route(True, False, False, "v2", True, 8) == "block"
    assert pvtv2.stage_route(True, True, False, "auto:2", True, 2) == "chain"
    assert pvtv2.stage_route(True, False, True, "auto:2", True, 2) == "chain"


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


@pytest.mark.parametrize("option", ["attn_impl_v2", "blockfuse"])
def test_reduced_pvt_bf16_matches_pallas_kernels(interpret, monkeypatch,
                                                 option):
    """Depths (2, 2, 1, 1) in bf16, JAX with the whole-half or whole-block
    kernel (and the MLP kernel) in the Pallas interpreter."""
    cfg = dict(JAX_CONFIGS["b2"], depths=(2, 2, 1, 1))
    x = np.random.default_rng(7).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    if option == "attn_impl_v2":
        monkeypatch.setenv("PVT_ATTN_IMPL", "v2")
        jmodel, kw = JaxPVTv2(**cfg, dtype=jnp.bfloat16), {"attn_impl": "v2"}
    else:
        jmodel = JaxPVTv2(**cfg, dtype=jnp.bfloat16, fused_block=True)
        kw = {"blockfuse": True}
    v = random_variables(jmodel, jnp.asarray(x), seed=8)
    # every parameter bf16-representable: the Pallas kernels read their
    # biases and taps in f32, the port's bf16 model holds them in bf16
    v = jax.tree.map(_bf16_values, v)
    want = jax.jit(jmodel.apply)(v, x)
    sd = state_dict_from_jax({"params": {"backbone": v["params"]}})
    port = pvtv2.PVTv2(**cfg, **kw)
    port.load_state_dict({k.removeprefix("backbone."): t
                          for k, t in sd.items()})
    port = set_compute_dtype(port, torch.bfloat16).eval()
    with torch.no_grad():
        got = port(_nchw(x).bfloat16())
    for g, w in zip(got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        err = np.abs(g.permute(0, 2, 3, 1).float().numpy() - w).max()
        # both sides run the kernels' arithmetic; the patch embeds and
        # stage LayerNorms round at other points (XLA's bf16 convolution):
        # a wrong route or a missing stage LN is O(1)
        assert err / np.abs(w).max() < 0.04


@pytest.mark.parametrize("kw,calls", [
    ({"attn_impl": "v2"}, {"sra_block": 16, "sra_attention": 0,
                           "pvt_block": 0, "mlp_block:plain": 12,
                           "mlp_block:stats": 0, "mlp_block:final_ln": 4}),
    ({"blockfuse": True}, {"sra_block": 0, "sra_attention": 0,
                           "pvt_block": 16, "mlp_block:plain": 0,
                           "mlp_block:stats": 0, "mlp_block:final_ln": 0}),
], ids=["attn_impl_v2", "blockfuse"])
def test_pvt_pranet_v2_options_on_the_port(monkeypatch, kw, calls):
    """Full depth at 64x64, bf16: the wrapper each block reaches, and the
    eight maps within 0.1 of the float32 module chain's."""
    seen = {}
    for name in ("sra_block", "sra_attention", "pvt_block", "mlp_block"):
        f = getattr(pvtv2, name)

        def counted(*a, _f=f, _n=name, **k):
            if _n == "mlp_block":
                _n += (":final_ln" if "final_ln" in k
                       else ":stats" if "stats_eps" in k else ":plain")
            seen[_n] = seen.get(_n, 0) + 1
            return _f(*a, **k)

        monkeypatch.setattr(pvtv2, name, counted)
    g = torch.Generator().manual_seed(3)
    ref = get_model("pvt_pranet_v2", device="cpu", generator=g).eval()
    model = get_model("pvt_pranet_v2", device="cpu", dtype=torch.bfloat16,
                      **kw).eval()
    model.load_state_dict(ref.state_dict())
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        want = ref(x)
        seen.clear()
        got = model(x)
    assert {k: seen.get(k, 0) for k in calls} == calls
    assert len(got) == 8
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 1, 64, 64) and g.dtype == torch.bfloat16
        assert bool(torch.isfinite(g).all())
        assert ((g.float() - w).abs().max() / w.abs().max()).item() < 0.1

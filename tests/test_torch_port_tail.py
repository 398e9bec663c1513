"""The decoder level and the stem tail against the JAX package, and the
routing rule that keeps forward-only kernels out of autograd, on the CPU.

* ``ops.dsra.dsra_level_plain`` (the chain ``dsra_level`` replaces: crops,
  gate, full-size maps) against a JAX composition of
  ``pranet2_tpu/ops/resize.py::resize_bilinear`` and ``dsra_gate_pallas``
  (its Pallas kernel run by the interpreter off a TPU), at PraNet-V2's
  three levels: level 4 crops by downsampling 44 -> 11 and also resizes the
  partial decoder's maps, levels 3 and 2 upsample.
* ``ops.stem.stem_pool_plain`` against the JAX package's bf16 stem tail:
  ``fold_bn``, ``s2d_stem``'s ``bnrelu`` (the affine in the compute type)
  and ``_maxpool_s2d_pallas`` (interpreted) on the packed map.
* The rule for every kernel site, ``self.training or
  torch.is_grad_enabled()`` picks the module chain: an eval forward with
  autograd on routes the stem, the fused Res2Net branches, the PVT stages
  and the decoder levels to their chains, and its backward reaches every
  parameter; under ``torch.no_grad()`` they take the kernel routes (the
  plain versions on the CPU).

Inputs are numpy from a seed; the port is NCHW, the JAX package NHWC.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pranet2_tpu.ops import dsra as jdsra
from pranet2_tpu.ops import resize as jresize
from pranet2_tpu.ops import stem as jstem
from pranet2_tpu.ops.res2_block import fold_bn as jfold_bn
from pranet2_tpu_torch import get_model
from pranet2_tpu_torch.models import pranet
from pranet2_tpu_torch.models.backbones import pvtv2, res2net
from pranet2_tpu_torch.ops import dsra, res2_block, res2_tail, stem

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
PVT_KERNELS = ("mlp_block", "sra_attention", "sra_block", "pvt_block")


def _pair(rng, shape, dtype):
    """The same values as a JAX NHWC array and a torch NCHW tensor."""
    jdt, tdt = DTYPES[dtype]
    x = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x, jdt),
            torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(tdt))


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


# ------------------------------------------------------------ decoder level


def _jax_level(pf, pb, rf, rb, out, use_softmax, emit_prev):
    size = rf.shape[1:3]
    gated = jdsra.dsra_gate_pallas(rf, jresize.resize_bilinear(pf, size),
                                   jresize.resize_bilinear(pb, size),
                                   use_softmax)
    full = (gated, rb, pf, pb) if emit_prev else (gated, rb)
    return (gated, *(jresize.resize_bilinear(t, out) for t in full))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("use_softmax", [True, False])
@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("prev,ra,emit_prev", [
    (44, 11, True),    # level 4: the crop downsamples; map5 resized too
    (11, 22, False),   # level 3
    (22, 44, False),   # level 2
], ids=["level4", "level3", "level2"])
def test_dsra_level_plain_matches_jax(rng, prev, ra, emit_prev, c,
                                      use_softmax, dtype):
    """Batch 2 at the serving sizes, maps out at 352 x 352.  f32: the JAX
    resize contracts float64-built matrices in float32, torch interpolates
    directly, the softmax's exp and sum differ by a few ulp: within 1e-5.
    bf16: both resize in float32 with weights exact at these power-of-two
    ratios and round once; the gate rounds at the same points, and a few
    f32 ulp of the softmax can move one bf16 rounding: gated within one
    bf16 step (2^-7).  The full-size map of gated resizes that step and
    rounds again: two steps; the other maps one."""
    out = (352, 352)
    ins = [_pair(rng, (2, s, s, c), dtype)
           for s in (prev, prev, ra, ra)]
    got = dsra.dsra_level_plain(*(t for _, t in ins), out, use_softmax,
                                emit_prev)
    want = _jax_level(*(a for a, _ in ins), out, use_softmax, emit_prev)
    assert len(got) == len(want) == (5 if emit_prev else 3)
    assert tuple(got[0].shape) == (2, c, ra, ra)
    for i, (g, w) in enumerate(zip(got, want)):
        tol = 1e-5 if dtype == "f32" else 2 ** -7 * (2 if i == 1 else 1)
        assert g.dtype == ins[0][1].dtype
        np.testing.assert_allclose(_nhwc(g), _np(w), atol=tol, rtol=tol)


def test_dsra_level_on_cpu_is_the_plain_version(rng):
    """A CPU call runs the plain version and counts no launch."""
    ins = [_pair(rng, (1, s, s, 2), "f32")[1] for s in (8, 8, 4, 4)]
    before = dsra.dsra_level.launches
    got = dsra.dsra_level(*ins, (16, 16), True, True)
    want = dsra.dsra_level_plain(*ins, (16, 16), True, True)
    assert dsra.dsra_level.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# --------------------------------------------------------------- stem tail


def _pack2(z):
    """(N, H, W, C) -> the stem's 2x2 space-to-depth packing (N, H/2, W/2,
    4C), channel (a*2+b)*C + c holding pixel (2i+a, 2j+b)."""
    n, h, w, c = z.shape
    z = z.reshape(n, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 2, 4, 5)
    return z.reshape(n, h // 2, w // 2, 4 * c)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stem_pool_plain_matches_jax_stem(rng, monkeypatch, dtype):
    """bn1 folded, BN + ReLU, then the Pallas maxpool (interpreted) on the
    packed map, as the JAX package's stem runs them in its compute type.
    The port takes the affine in float32 and rounds once; JAX's bnrelu
    rounds s, t, the product and the sum to bf16, so bf16 is held within
    one bf16 step of the largest output (2^-7), f32 within 1e-6."""
    monkeypatch.setenv("PRANET2_PALLAS_INTERPRET", "1")
    co = 8
    jdt, tdt = DTYPES[dtype]
    # 32x32 -> packed 16x16: two of the Pallas kernel's 8-row tiles
    zj, zt = _pair(rng, (2, 32, 32, co), dtype)
    w, b, mean = (rng.standard_normal(co).astype(np.float32) * sc + sh
                  for sc, sh in ((0.1, 1.0), (0.1, 0.0), (0.1, 0.0)))
    var = (0.5 + rng.random(co)).astype(np.float32)
    s, t = jfold_bn(*map(jnp.asarray, (w, b, mean, var)))
    y = jnp.maximum(zj * s.astype(jdt) + t.astype(jdt), jnp.zeros((), jdt))
    want = _np(jstem._maxpool_s2d_pallas(_pack2(y), co))
    got = stem.stem_pool_plain(zt, *(torch.from_numpy(v)
                                     for v in (w, b, mean, var)), 1e-5)
    assert got.dtype == tdt and tuple(got.shape) == (2, co, 16, 16)
    tol = (1e-6 if dtype == "f32" else 2 ** -7) * np.abs(want).max()
    np.testing.assert_allclose(_nhwc(got), want, atol=tol, rtol=0)


def test_stem_pool_on_cpu_is_the_plain_version(rng):
    _, z = _pair(rng, (1, 9, 7, 3), "f32")
    vecs = [torch.from_numpy(rng.random(3).astype(np.float32) + 0.5)
            for _ in range(4)]
    before = stem.stem_pool.launches
    torch.testing.assert_close(stem.stem_pool(z, *vecs),
                               stem.stem_pool_plain(z, *vecs), rtol=0,
                               atol=0)
    assert stem.stem_pool.launches == before


# ----------------------------------------------------- F5: routing rule


def _record(monkeypatch, calls, sites):
    """Wrap each (module, name) of ``sites`` so that a call is noted in
    ``calls`` (by name) and then runs."""
    for module, name in sites:
        orig = getattr(module, name)

        def wrapped(*a, _name=name, _orig=orig, **kw):
            calls.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)


def _every_parameter_has_a_gradient(model):
    missing = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    assert not missing, missing


def _gray(seed, side):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1, 1, side, side)).astype(np.float32))


def test_res2net_pranet_routes_follow_autograd(monkeypatch):
    """pranet_v2 with its fused blocks, depths (2, 1, 1, 1), float32, in
    eval, on a grayscale 32 x 32 frame.  With autograd on, the stem, the
    fused block and the decoder levels run their chains (bn1 and the plain
    pool, the unfused block, the resizes and ``dsra_gate``), and a backward
    from the maps gives every parameter, the grayscale stem's too, a
    gradient.  Under no_grad they take the kernel routes (``stem_pool``,
    ``fused_bottle2neck``, three ``dsra_level`` calls), whose maps agree
    with the chains' within 1e-4 of the largest |map| (bn1 folded rounds
    other than ATen's BatchNorm, and the convolutions carry it)."""
    model = get_model("pranet_v2", device="cpu", layers=(2, 1, 1, 1),
                      fused=True, tailfuse=True).eval()
    calls = []
    _record(monkeypatch, calls, [
        (res2net, "stem_pool"), (res2_block, "fused_bottle2neck"),
        (res2_tail, "fused_tail"), (pranet, "dsra_level"),
        (pranet, "dsra_gate")])
    x = _gray(0, 32).requires_grad_()
    maps = model(x)
    assert calls == ["dsra_gate"] * 3
    calls.clear()
    with torch.no_grad():
        served = model(x)
    assert sorted(calls) == ["dsra_level"] * 3 + ["fused_bottle2neck",
                                                  "stem_pool"]
    assert len(maps) == 8
    for a, b in zip(maps, served):
        assert a.shape == b.shape == (1, 1, 32, 32)
        a = a.detach()
        assert ((a - b).abs().max() / b.abs().max()).item() < 1e-4
    sum(m.square().mean() for m in maps).backward()
    _every_parameter_has_a_gradient(model)
    assert x.grad is not None and x.grad.abs().max().item() > 0


@pytest.mark.parametrize("branch", ["fused", "tailfuse"])
def test_fused_res2net_branches_follow_autograd(monkeypatch, branch):
    """A bf16 Bottle2neck in eval with one kernel branch on (``fused``: a
    normal block; ``tailfuse``: a stage block's tail): the kernel's wrapper
    is called under no_grad only; with autograd on the block runs its
    module chain and a backward gives every parameter a gradient."""
    from pranet2_tpu_torch.testing import random_bottle2neck

    kw = ({"fused": True} if branch == "fused" else
          {"tailfuse": True, "stride": 2, "has_downsample": True,
           "stype": "stage"})
    block = random_bottle2neck(64, 16, 3, "cpu", torch.bfloat16, **kw)
    name = "fused_bottle2neck" if branch == "fused" else "fused_tail"
    calls = []
    _record(monkeypatch, calls, [(res2_block, "fused_bottle2neck"),
                                 (res2_tail, "fused_tail")])
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 64, 8, 8)).astype(np.float32)).bfloat16()
    with torch.no_grad():
        block(x)
    assert calls == [name]
    calls.clear()
    block(x).float().square().mean().backward()
    assert not calls
    _every_parameter_has_a_gradient(block)


@pytest.mark.parametrize("kw", [{}, {"attn_impl": "v2"},
                                {"blockfuse": True}],
                         ids=["v1", "attn_impl_v2", "blockfuse"])
def test_pvt_routes_follow_autograd(monkeypatch, kw):
    """A bf16 PVTv2 of depth 1 a stage in eval: every stage routes to the
    chain while autograd records (``stage_route``'s ``grad``), and its
    backward gives every parameter a gradient; under no_grad the stages
    take their kernels."""
    g = torch.Generator().manual_seed(0)
    from pranet2_tpu_torch.nn import init_weights_, set_compute_dtype

    model = pvtv2.PVTv2(embed_dims=(32, 64, 64, 64), depths=(1, 1, 1, 1),
                        num_heads=(1, 2, 2, 2), mlp_ratios=(2, 2, 2, 2),
                        **kw)
    model = set_compute_dtype(init_weights_(model, g), torch.bfloat16).eval()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 3, 32, 32)).astype(np.float32)).bfloat16()
    calls = []
    _record(monkeypatch, calls, [(pvtv2, k) for k in PVT_KERNELS])
    with torch.no_grad():
        model(x)
    assert calls, "the no_grad eval forward reached no kernel wrapper"
    calls.clear()
    sum(o.float().square().mean() for o in model(x)).backward()
    assert not calls
    _every_parameter_has_a_gradient(model)
    for sr in pvtv2.SR_RATIOS:
        assert pvtv2.stage_route(True, False, True, "v1", False,
                                 sr) == "chain"
        assert pvtv2.stage_route(True, False, False, "v1", False,
                                 sr) == "v1"

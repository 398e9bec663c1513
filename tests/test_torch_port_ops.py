"""The port's ops (pranet2_tpu_torch.ops) against the JAX package's.

Inputs are made with numpy from a seed and fed to both sides; the port is
NCHW, the JAX package NHWC, and the tests transpose at the boundary.  The
kernels' plain versions are held against the Pallas kernels run by the
Pallas interpreter; the CUDA kernels themselves are held against the plain
versions on a GPU by test_torch_port_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pranet2_tpu import ops as jops
from pranet2_tpu.ops import dsra as jdsra
from pranet2_tpu.ops import stem as jstem
from pranet2_tpu.ops.resize import resize_bilinear_np as jresize_np
from pranet2_tpu_torch import ops
from pranet2_tpu_torch.ops import dsra, stem

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


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


# ------------------------------------------------------------------ resize


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("src,dst", [((11, 11), (44, 44)), ((22, 18), (7, 9)),
                                     ((8, 8), (16, 16))])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_resize_bilinear_matches_jax(rng, src, dst, align_corners, dtype):
    xj, xt = _pair(rng, (2, *src, 3), dtype)
    got = ops.resize_bilinear(xt, dst, align_corners)
    want = jops.resize_bilinear(xj, dst, align_corners)
    assert got.dtype == xt.dtype and tuple(got.shape) == (2, 3, *dst)
    # f32: the JAX op contracts f64-built matrices in f32, torch interpolates
    # directly; both round once per product, so ~1e-6 on O(1) values.  bf16:
    # both compute in f32 and round the result to bf16 once, so at most one
    # bf16 step (2^-8 relative) apart.
    tol = 2e-6 if dtype == "f32" else 2 ** -7
    np.testing.assert_allclose(_nhwc(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("scale", [2, 0.5])
def test_upsample_matches_jax(rng, scale):
    xj, xt = _pair(rng, (1, 10, 12, 2), "f32")
    got = ops.upsample(xt, scale, align_corners=True)
    want = jops.upsample(xj, scale, align_corners=True)
    np.testing.assert_allclose(_nhwc(got), _np(want), atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_bilinear_np_matches_jax(rng, align_corners):
    x = rng.standard_normal((2, 30, 20, 1)).astype(np.float32)
    got = ops.resize_bilinear_np(x.transpose(0, 3, 1, 2), (47, 33),
                                 align_corners)
    want = jresize_np(x, (47, 33), align_corners)
    # same matrices, same einsum order: equal up to f32 summation order
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, atol=1e-6)


# ----------------------------------------------------------------- pooling


@pytest.mark.parametrize("k,s,p,cip,ceil", [
    (3, 1, 1, True, False),    # Bottle2neck stage pool, stride 1
    (3, 2, 1, True, False),    # Bottle2neck stage pool, stride 2
    (2, 2, 0, False, True),    # v1b downsample shortcut, odd input
    (3, 2, 1, False, True),    # ceil mode with padding
])
def test_avg_pool_matches_jax(rng, k, s, p, cip, ceil):
    xj, xt = _pair(rng, (2, 11, 9, 3), "f32")
    got = ops.avg_pool(xt, k, s, p, count_include_pad=cip, ceil_mode=ceil)
    want = jops.avg_pool(xj, k, s, p, count_include_pad=cip, ceil_mode=ceil)
    assert got.shape[-2:] == want.shape[1:3]
    # f32 window sums in different orders: a few ulp on O(1) values
    np.testing.assert_allclose(_nhwc(got), _np(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("k,s,p", [(3, 2, 1), (2, 2, 0), (3, 1, 1)])
def test_max_pool_matches_jax(rng, k, s, p):
    xj, xt = _pair(rng, (2, 13, 10, 3), "f32")
    got = ops.max_pool(xt, k, s, p)
    want = jops.max_pool(xj, k, s, p)
    np.testing.assert_array_equal(_nhwc(got), _np(want))  # max is exact


def _pack2(z):
    """(N, H, W, C) -> the stem's 2x2 space-to-depth packing (N, H/2, W/2,
    4C), channel (a*2+b)*C + c holding pixel (2i+a, 2j+b)."""
    n, h, w, c = z.shape
    z = z.reshape(n, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 2, 4, 5)
    return z.reshape(n, h // 2, w // 2, 4 * c)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stem_maxpool_plain_matches_pallas_kernel(rng, monkeypatch, dtype):
    """The plain version of the stem maxpool kernel against the TPU kernel
    body (run by the Pallas interpreter) fed the packed copy of one map, and
    against the JAX package's max_pool.  Exact: max is order-free."""
    monkeypatch.setenv("PRANET2_PALLAS_INTERPRET", "1")
    co = 8
    # 32x32 -> packed 16x16: two of the kernel's 8-row tiles, so the one-row
    # halo and its -inf mask at the top edge both run
    xj, xt = _pair(rng, (2, 32, 32, co), dtype)
    got = _nhwc(stem.max_pool3x3s2_plain(xt))
    pallas = jstem._maxpool_s2d_pallas(_pack2(xj), co)
    np.testing.assert_array_equal(got, _np(pallas))
    np.testing.assert_array_equal(got, _np(jops.max_pool(xj, 3, 2, 1)))


# -------------------------------------------------------------------- gate


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("use_softmax", [True, False])
@pytest.mark.parametrize("c", [1, 4, 9])
def test_dsra_gate_plain_matches_pallas_kernel(rng, c, use_softmax, dtype):
    """The gate's plain version against ``dsra_gate_pallas``, which runs its
    Pallas kernel in the interpreter off-TPU.  At C = 1 the softmax is
    identically 1, so C = 4 and 9 carry the softmax."""
    shape = (2, 6, 5, c)
    fj, ft = _pair(rng, shape, dtype)
    cfj, cft = _pair(rng, shape, dtype)
    cbj, cbt = _pair(rng, shape, dtype)
    got = ops.dsra_gate(ft, cft, cbt, use_softmax)
    want = jdsra.dsra_gate_pallas(fj, cfj, cbj, use_softmax)
    assert got.dtype == ft.dtype
    # Same rounding points on both sides; the f32 softmax's exp and sum
    # differ by a few ulp, and in bf16 that can move one rounding by one
    # bf16 step (2^-8 relative) of an O(1)-to-O(10) result.
    tol = 1e-5 if dtype == "f32" else 2 ** -7
    np.testing.assert_allclose(_nhwc(got), _np(want), atol=tol, rtol=tol)


def test_cpu_tensors_take_the_plain_path(rng):
    """On CPU tensors the wrappers run the plain versions and launch
    nothing, so the launch counters stay put."""
    stem.max_pool3x3s2.launches = dsra.dsra_gate.launches = 0
    _, x = _pair(rng, (1, 10, 10, 4), "f32")
    torch.testing.assert_close(ops.max_pool3x3s2(x),
                               stem.max_pool3x3s2_plain(x), rtol=0, atol=0)
    torch.testing.assert_close(ops.dsra_gate(x, x * 2, x, True),
                               dsra.dsra_gate_plain(x, x * 2, x, True),
                               rtol=0, atol=0)
    assert stem.max_pool3x3s2.launches == 0
    assert dsra.dsra_gate.launches == 0

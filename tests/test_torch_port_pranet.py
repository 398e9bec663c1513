"""The port's Res2Net and PraNet-V2 against the JAX package's, on the CPU.

Both sides get the same weights: a flax tree of numpy arrays drawn from a
seed (LeCun-normal kernels, BatchNorm scale/bias/mean/var all randomised so
that no BN is the identity), carried into the port by
``state_dict_from_jax``.  Inputs are numpy from a seed; the port is NCHW,
JAX NHWC.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pranet2_tpu.models import get_model as jax_get_model
from pranet2_tpu.models.backbones.res2net import Res2Net as JaxRes2Net
from pranet2_tpu.utils.torch_convert import convert_state_dict, pranet_key_map
from pranet2_tpu_torch import get_model
from pranet2_tpu_torch.models.backbones.res2net import Res2Net
from pranet2_tpu_torch.utils.convert import load_jax_variables

SIZE, BATCH = 64, 2


def random_variables(model, x, seed=0):
    """A flax variable tree for ``model`` on input ``x``, as numpy arrays
    drawn from ``seed``.  Shapes come from ``eval_shape`` (no init run)."""
    shapes = jax.eval_shape(model.init, jax.random.key(0), x)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        kind = path[-1].key
        if kind == "kernel":
            v = rng.standard_normal(s.shape) / math.sqrt(
                math.prod(s.shape[:-1]))
        elif kind in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:  # bias, mean
            v = rng.normal(0.0, 0.1, s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _rel_err(port, ref):
    """max |port - ref| over max |ref|, port NCHW, ref NHWC."""
    a = port.float().permute(0, 2, 3, 1).numpy()
    b = np.asarray(jnp.asarray(ref, jnp.float32))
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def _input(channels, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (BATCH, SIZE, SIZE, channels)).astype(np.float32)


@pytest.fixture(scope="module")
def rgb():
    x = _input(3)
    model = jax_get_model("pranet_v2", num_class=1)
    return x, random_variables(model, jnp.asarray(x))


def _port(variables, dtype=None):
    model = get_model("pranet_v2", device="cpu", dtype=dtype)
    return load_jax_variables(model, variables).eval()


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def test_res2net_features_match_jax(rgb):
    x, v = rgb
    sub = {k: v[k]["backbone"] for k in v}
    want = jax.jit(JaxRes2Net(layers=(3, 4, 6, 3)).apply)(sub, x)
    port = _port(v).backbone
    assert isinstance(port, Res2Net)
    with torch.no_grad():
        got = port(_nchw(x))
    for g, w in zip(got, want):
        assert tuple(g.shape) == (w.shape[0], w.shape[3], *w.shape[1:3])
        # f32 on both sides; 50 convs summed in other orders by XLA and
        # oneDNN leave a relative error around 1e-6
        assert _rel_err(g, w) < 2e-5


# f32: tight, summation order only.  bf16: the JAX model takes its TPU
# restructures (space-to-depth stem, block-diagonal stage convs) and rounds
# BatchNorm in bf16 at each step where the port rounds once, so the two
# bf16 programs differ by a few bf16 steps compounded over ~100 layers.
@pytest.mark.parametrize("dtype,tol", [("f32", 2e-5), ("bf16", 0.1)])
def test_pranet_v2_matches_jax(rgb, dtype, tol):
    x, v = rgb
    jdt, tdt = {"f32": (None, None),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jax.jit(jax_get_model("pranet_v2", num_class=1, dtype=jdt).apply)(
        v, x)
    with torch.no_grad():
        got = _port(v, tdt)(_nchw(x))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert tuple(g.shape) == (BATCH, 1, SIZE, SIZE)
        if tdt is not None:
            assert g.dtype == tdt
        assert _rel_err(g, w) < tol


@pytest.fixture(scope="module")
def gray():
    x = _input(1, seed=2)
    model = jax_get_model("pranet_v2", num_class=1)
    return x, random_variables(model, jnp.asarray(x), seed=3)


def test_grayscale_stem_matches_jax(gray):
    x, v = gray
    want = jax.jit(jax_get_model("pranet_v2", num_class=1).apply)(v, x)
    with torch.no_grad():
        got = _port(v)(_nchw(x))
    for g, w in zip(got, want):
        assert _rel_err(g, w) < 2e-5


def test_state_dict_round_trip(gray):
    """port state_dict -> the JAX package's converter -> the same tree."""
    _, v = gray
    back = convert_state_dict(
        {k: t.numpy() for k, t in _port(v).state_dict().items()},
        pranet_key_map("v2", "res2net50"))
    want = jax.tree_util.tree_leaves_with_path(v)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))


def test_jax_tree_must_fit_model(rgb):
    _, v = rgb
    bad = jax.tree.map(lambda a: a, v)
    bad["params"]["agg1"]["extra"] = {"kernel": np.zeros((1, 1, 2, 2))}
    with pytest.raises(KeyError):
        load_jax_variables(get_model("pranet_v2", device="cpu"), bad)


def test_entry_points_need_a_gpu_unless_told_cpu(monkeypatch):
    from pranet2_tpu_torch.serve import BinaryPredictor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("pranet_v2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BinaryPredictor("pranet_v2", {})
    assert next(get_model("pranet_v2", device="cpu").parameters()).is_cpu

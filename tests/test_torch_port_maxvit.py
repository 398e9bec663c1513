"""The port's MaxViT / MaxxViT backbone against the JAX package's, on the CPU.

Weights are drawn as in ``test_torch_port_pranet.random_variables`` (every
BatchNorm, LayerScale and bias table randomised) and carried into the port
by ``state_dict_from_jax``; a block's tree is converted under a backbone
block's name and loaded into the port's block.  Inputs are numpy from a
seed: NCHW on the port's side for the conv blocks and the backbone,
channels-last for the attention blocks (as on both sides), NHWC on JAX's.
Float32 on both sides: the blocks within 1e-5 of the largest |output|,
the backbone within 1e-4 (summation order only).

The backbone runs at ``maxvit_dryrun`` (one block a stage) at 64 x 64; the
five real configurations are held by their parameter counts (JAX's
``eval_shape``, the port on the meta device) and two of them by
state-dict round trips through ``maxvit_key_map`` at one block a stage,
with no forward.  Also here: the seeded
``Dropout`` and exact GELU that MaxViT and MIST share.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pranet2_tpu.models.backbones import maxvit as jmv
from pranet2_tpu.models import mist as jmist
from pranet2_tpu.utils.torch_convert import convert_state_dict, maxvit_key_map
from pranet2_tpu_torch.models.backbones import maxvit
from pranet2_tpu_torch.nn import (DropPath, Dropout, drop_path_seeder,
                                  init_weights_)
from pranet2_tpu_torch.utils.convert import (load_reference,
                                            load_reference_state_dict,
                                            state_dict_from_jax)
from test_torch_port_emcad import _block_vars, _input, _nchw, _rel_err
from test_torch_port_pranet import random_variables

MODEL_TOL, BLOCK_TOL = 1e-4, 1e-5
REAL = ("maxvit_tiny_rw_224", "maxvit_rmlp_tiny_rw_256",
        "maxvit_rmlp_small_rw_224", "maxvit_rmlp_small_rw_256",
        "maxxvit_rmlp_small_rw_256")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs files in parallel workers, and
    each worker's default of one thread a core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def random_state(model, seed):
    """numpy values, drawn from ``seed``, for every entry of ``model``'s
    ``state_dict`` (``model`` may lie on the meta device), as
    ``random_variables`` draws a JAX tree: kernels LeCun-normal, norm
    scales and running variances in [0.5, 1.5], the rest (biases, running
    means, LayerScale gammas, bias tables) normal with std 0.1."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, t in model.state_dict().items():
        shape, leaf = tuple(t.shape), key.rsplit(".", 1)[1]
        if leaf == "num_batches_tracked":
            out[key] = np.zeros((), np.int64)
        elif leaf.endswith("weight") and len(shape) > 1:
            out[key] = rng.standard_normal(shape, np.float32) / np.float32(
                np.sqrt(np.prod(shape[1:])))
        elif leaf in ("weight", "running_var"):
            out[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            out[key] = rng.normal(0.0, 0.1, shape).astype(np.float32)
    return out


def _cl_err(port, ref):
    """``_rel_err`` of a channels-last port output."""
    b = np.asarray(ref, np.float32)
    return float(np.abs(port.detach().float().numpy() - b).max()
                 / max(np.abs(b).max(), 1e-6))


def _load_block(block, tree, *path):
    """Load the flax ``tree`` of a module at ``path`` inside a backbone
    block into the port's ``block``, through the converter's names."""
    def wrap(node):
        for name in reversed(("stages_0_blocks_0",) + path):
            node = {name: node}
        return {"backbone": node}

    sd = state_dict_from_jax({k: wrap(v) for k, v in tree.items()})
    prefix = ".".join(("backbone.stages.0.blocks.0",) + path) + "."
    block.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    return block.eval()


# ---------------------------------------------------------------- blocks


@pytest.mark.parametrize("cin,cout,stride", [(16, 16, 1), (16, 24, 2)])
def test_mbconv_matches_jax(cin, cout, stride):
    """Stride 1 (identity shortcut) and 2 (avg-pool + bias-free 1x1
    expand)."""
    x = _input(cin, seed=3, side=8)
    ref = jmv.MbConv(cout, stride)
    v = _block_vars(ref, x)
    port = _load_block(maxvit.MbConv(cin, cout, stride), v, "conv")
    assert hasattr(port, "shortcut") == (stride == 2)
    with torch.no_grad():
        assert _rel_err(port(_nchw(x)), ref.apply(v, x)) < BLOCK_TOL


def test_convnext_block_matches_jax():
    """Stride 2 with in != out: the depthwise 7x7 maps 16 -> 32 channels
    with groups=16 (a channel multiplier of 2), the shortcut avg-pools and
    expands (with bias), LayerScale's gamma is ``conv.ls.gamma``."""
    x = _input(16, seed=4, side=8)
    ref = jmv.ConvNeXtBlock(32, 2)
    v = _block_vars(ref, x)
    port = _load_block(maxvit.ConvNeXtBlock(16, 32, 2), v, "conv")
    assert port.conv_dw.groups == 16 and port.conv_dw.out_channels == 32
    assert "ls.gamma" in port.state_dict()
    with torch.no_grad():
        assert _rel_err(port(_nchw(x)), ref.apply(v, x)) < BLOCK_TOL


class _NoInput:
    """``random_variables`` passes an input: the bias modules take none."""

    def __init__(self, module):
        self.module = module

    def init(self, key, _):
        return self.module.init(key)


@pytest.mark.parametrize("kind", ["mlp", "bias"])
def test_rel_pos_matches_jax(kind):
    """The (heads, N, N) bias of both forms at window 3, 4 heads: the MLP
    of the log coordinates and the learned (5^2, 4) table, gathered by the
    same index."""
    win, heads = 3, 4
    if kind == "mlp":
        ref = jmv.RelPosMlp(win, heads)
        port = maxvit.RelPosMlp(heads)
    else:
        ref = jmv.RelPosBias(win, heads)
        port = maxvit.RelPosBias(win, heads)
    v = random_variables(_NoInput(ref), jnp.zeros(()), seed=5)
    port = _load_block(port, v, "attn_block", "attn", "rel_pos")
    with torch.no_grad():
        got = port(win)
    assert got.shape == (heads, win * win, win * win)
    want = np.asarray(ref.apply(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=BLOCK_TOL * np.abs(want).max())
    np.testing.assert_array_equal(maxvit._rel_index(5), jmv._rel_index(5))
    np.testing.assert_array_equal(maxvit._rel_log_coords(5),
                                  jmv._rel_log_coords(5))


@pytest.mark.parametrize("kind", ["mlp", "bias"])
def test_attention_matches_jax(kind):
    """``AttentionCl`` at 64 channels (2 heads of 32), window 3: the q/k/v
    split is per head, timm's layout (``qkv`` viewed as (n, heads, 3 x 32));
    a split into (3, heads, 32) from the same weights is far off."""
    x = _input(64, seed=6, side=3, n=4)
    ref = jmv.AttentionCl(64, 3, rel_pos_type=kind)
    v = _block_vars(ref, x)
    port = _load_block(maxvit.AttentionCl(64, kind, window=3), v,
                       "attn_block", "attn")
    want = ref.apply(v, x)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        assert _cl_err(port(xt, 3), want) < BLOCK_TOL
        # the same attention with q, k, v split as (3, heads, 32)
        q, k, v_ = port.qkv(xt.reshape(4, 9, 64)).view(4, 9, 3, 2, 32) \
            .permute(2, 0, 3, 1, 4)
        s = q @ k.transpose(-1, -2) / 32 ** 0.5 + port.rel_pos(3)
        o = (s.softmax(-1) @ v_).transpose(1, 2).reshape(4, 3, 3, 64)
        assert _cl_err(port.proj(o), want) > 0.05


def test_partitions_match_jax():
    x = np.random.default_rng(7).standard_normal((2, 12, 12, 5)).astype(
        np.float32)
    t = torch.from_numpy(x)
    for part, rev in (("window_partition", "window_reverse"),
                      ("grid_partition", "grid_reverse")):
        want = np.asarray(getattr(jmv, part)(jnp.asarray(x), 3))
        got = getattr(maxvit, part)(t, 3)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            getattr(maxvit, rev)(got, 3, (12, 12)).numpy(), x)


@pytest.mark.parametrize("partition", ["block", "grid"])
def test_partition_attention_with_layer_scale_matches_jax(partition):
    """LN -> window or grid attention -> LayerScale -> +res, then the MLP
    half, at 64 channels on a 6 x 6 map in windows of 3; the LayerScale
    gammas (``ls1.gamma``, ``ls2.gamma``) randomised."""
    x = _input(64, seed=8, side=6)
    ref = jmv.PartitionAttention(64, 3, partition, init_values=1e-6)
    v = _block_vars(ref, x)
    port = _load_block(maxvit.PartitionAttention(64, partition, 1e-6),
                       v, f"attn_{partition}")
    assert {"ls1.gamma", "ls2.gamma"} <= port.state_dict().keys()
    with torch.no_grad():
        assert _cl_err(port(torch.from_numpy(x), 3), ref.apply(v, x)) \
            < BLOCK_TOL


def test_exact_gelu_is_jax_and_not_tanh():
    """MaxViT's and MIST's GELU is exact erf (torch's default), not
    EMCAD's tanh approximation."""
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    got = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    for fn in (jmv._gelu, jmist._gelu):
        np.testing.assert_allclose(got, np.asarray(fn(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6)
    tanh = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    assert np.abs(got - tanh).max() > 1e-4


# -------------------------------------------------------------- backbone


@pytest.fixture(scope="module")
def dryrun():
    """(input, flax tree, JAX features) of ``maxvit_dryrun`` at 64^2."""
    x = _input(3, seed=9)
    ref = jmv.maxvit("maxvit_dryrun")
    v = random_variables(ref, jnp.asarray(x), seed=10)
    return x, v, jax.jit(ref.apply)(v, x)


def _load_backbone(model, v):
    """A bare backbone's flax tree, converted under the name
    ``backbone``, into ``model``."""
    sd = state_dict_from_jax({k: {"backbone": t} for k, t in v.items()})
    model.load_state_dict({k[len("backbone."):]: t for k, t in sd.items()})
    return model.eval()


def _port_dryrun(v):
    return _load_backbone(maxvit.maxvit("maxvit_dryrun"), v)


def test_maxxvit_dryrun_matches_jax(dryrun):
    x, v, want = dryrun
    with torch.no_grad():
        got = _port_dryrun(v)(_nchw(x))
    assert [tuple(t.shape) for t in got] == [
        (2, 32, 16, 16), (2, 32, 8, 8), (2, 64, 4, 4), (2, 128, 2, 2)]
    for g, w in zip(got, want):
        assert _rel_err(g, w) < MODEL_TOL


def test_eval_with_autograd_reaches_every_parameter(dryrun):
    """The backbone in eval with autograd on: a backward gives every
    parameter a finite gradient (the class of faults F1 and F5)."""
    x, v, _ = dryrun
    model = _port_dryrun(v)
    sum(f.square().mean() for f in model(_nchw(x))).backward()
    missing = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    assert not missing, missing


def test_trains_after_serving_in_inference_mode(dryrun):
    """The rel-pos tables are cached per window and device: built first
    under ``torch.inference_mode`` (serving), they still serve a training
    forward and its backward."""
    x, v, _ = dryrun
    model = _port_dryrun(v)
    maxvit._rel_tables.cache_clear()
    with torch.inference_mode():
        model(_nchw(x))
    model.train()
    sum(f.square().mean() for f in model(_nchw(x))).backward()
    assert model.stages[0].blocks[0].attn_block.attn.qkv.weight.grad \
        is not None


def test_load_reference_of_a_dataparallel_pth(dryrun, tmp_path):
    """A timm-style ``.pth`` of the backbone (``module.`` keys, a ``model``
    container, the classifier ``head.*``) loads and drops the head."""
    x, v, want = dryrun
    sd = _port_dryrun(v).state_dict()
    sd["head.norm.weight"] = torch.ones(128)
    sd["head.fc.weight"] = torch.zeros((1000, 128))
    torch.save({"model": {f"module.{k}": t for k, t in sd.items()}},
               tmp_path / "maxvit.pth")
    model = maxvit.maxvit("maxvit_dryrun")
    assert load_reference(model, load_reference_state_dict(
        str(tmp_path / "maxvit.pth"))) == ["head.fc.weight",
                                           "head.norm.weight"]
    with torch.no_grad():
        got = model.eval()(_nchw(x))
    assert _rel_err(got[3], want[3]) < MODEL_TOL


@pytest.fixture(scope="module")
def real_shapes():
    """JAX's ``eval_shape`` tree of each real configuration at the input
    side its name gives (224 or 256)."""
    out = {}
    for name in REAL:
        side = 224 if name.endswith("224") else 256
        out[name] = (side, jax.eval_shape(
            jmv.maxvit(name).init, jax.random.key(0),
            jnp.zeros((1, side, side, 3))))
    return out


@pytest.mark.parametrize("name", REAL)
def test_parameter_count_matches_jax(real_shapes, name):
    """Every real configuration at full depth, built on the meta device
    (no memory, no forward): JAX's parameter and BatchNorm statistic
    counts; ``maxvit_tiny_rw_224``'s table has (2 x 7 - 1)^2 rows at 224."""
    side, shapes = real_shapes[name]
    with torch.device("meta"):
        model = maxvit.maxvit(name, img_size=side)
    count = lambda tree: sum(int(np.prod(s.shape))
                             for s in jax.tree.leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == count(
        shapes["params"])
    assert sum(b.numel() for n, b in model.named_buffers()
               if not n.endswith("num_batches_tracked")) == count(
        shapes.get("batch_stats", {}))
    tables = [tuple(p.shape) for n, p in model.named_parameters()
              if n.endswith("relative_position_bias_table")]
    cfg = maxvit.MAXVIT_CONFIGS[name]
    want = [(169, d // 32) for d, depth in zip(cfg["embed_dim"],
                                               cfg["depths"])
            for _ in range(2 * depth)]
    assert tables == (want if name == "maxvit_tiny_rw_224" else [])


@pytest.mark.parametrize("name", ["maxxvit_rmlp_small_rw_256",
                                  "maxvit_tiny_rw_224"])
def test_state_dict_round_trip(monkeypatch, name):
    """A tree in JAX's layout (ConvNeXt blocks with LayerScale; the bias
    tables), drawn for the port's parameters and put in JAX's layout by
    ``convert_state_dict`` with ``maxvit_key_map`` -> ``state_dict_from_jax``
    -> the port -> its ``state_dict`` -> ``convert_state_dict`` -> the same
    tree.  One block a stage (the parameter counts hold full depth)."""
    monkeypatch.setitem(maxvit.MAXVIT_CONFIGS, name, {
        **maxvit.MAXVIT_CONFIGS[name], "depths": (1, 1, 1, 1)})
    with torch.device("meta"):
        shell = maxvit.maxvit(name, img_size=224)
    v = convert_state_dict(random_state(shell, seed=11), maxvit_key_map)
    model = _load_backbone(maxvit.maxvit(name, img_size=224), v)
    assert any(k.endswith(("ls.gamma", "relative_position_bias_table"))
               for k in model.state_dict())
    back = convert_state_dict(
        {k: t.numpy() for k, t in model.state_dict().items()},
        maxvit_key_map)
    got = jax.tree_util.tree_leaves_with_path(back)
    want = jax.tree_util.tree_leaves_with_path(v)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(p))


def test_bias_table_needs_its_window():
    """The table is sized from ``img_size``; without it the 'bias' form is
    refused, and an input of another window raises."""
    with pytest.raises(ValueError, match="img_size"):
        maxvit.maxvit("maxvit_tiny_rw_224")
    cfg = {**maxvit.MAXVIT_CONFIGS["maxvit_tiny_rw_224"], "depths": (1,) * 4}
    model = maxvit.MaxxVit(**cfg, img_size=64).eval()
    assert model.stages[0].blocks[0].attn_block.attn.rel_pos \
        .relative_position_bias_table.shape == (9, 2)
    with torch.no_grad():
        assert model(torch.zeros((1, 3, 64, 64)))[3].shape == (1, 512, 2, 2)
        with pytest.raises(ValueError, match="window 1"):
            model(torch.zeros((1, 3, 32, 32)))


# ------------------------------------------------------- seeded dropout


def test_seeded_dropout_masks_keep_share_and_scale():
    """``Dropout`` draws from the generator ``drop_path_seeder`` seeds from
    the seed and the step: the same step repeats the mask, another step
    draws another; about 1 - rate of the elements are kept, each scaled by
    1 / keep; identity in eval.  The seeder reaches ``DropPath`` too."""
    model = torch.nn.Sequential(torch.nn.Linear(4, 4), Dropout(0.3),
                                DropPath(0.5))
    init_weights_(model, torch.Generator().manual_seed(0))
    reseed = drop_path_seeder(model, seed=12)
    x = torch.ones((64, 32, 32))
    drop = model[1].train()

    def mask(step):
        reseed(step)
        return drop(x)

    a, b, c = mask(3), mask(3), mask(4)
    assert model[2].generator is model[1].generator is not None
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.7))
    assert torch.equal(drop.eval()(x), x)

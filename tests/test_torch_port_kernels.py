"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

The kernels have no CPU or interpret mode, so every test here is marked
``cuda`` and skips without a GPU.  The file imports neither JAX nor the
JAX package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels.py

(``--noconftest``: tests/conftest.py sets up JAX.)
"""

import pytest
import torch

from pranet2_tpu_torch import get_model, ops
from pranet2_tpu_torch.ops import (dsra, dwconv, native_mask, pvt_attn,
                                   pvt_mlp, res2_block, res2_tail, stem)
from pranet2_tpu_torch.ops.pvt_block import pvt_block, pvt_block_plain
from pranet2_tpu_torch.ops.pvt_mlp import mlp_tile
from pranet2_tpu_torch.testing import (excess, level_excess,
                                       random_bottle2neck)
import torch_pvt_faults
import torch_res2_faults


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU or interpret "
                    "mode (chip_smoke.py checks them on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(2, 64, 176, 176), (1, 3, 7, 10),
                                   (3, 5, 1, 1)])
def test_maxpool_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    before = stem.max_pool3x3s2.launches
    got = ops.max_pool3x3s2(x)
    torch.cuda.synchronize()
    assert stem.max_pool3x3s2.launches == before + 1
    torch.testing.assert_close(got, stem.max_pool3x3s2_plain(x), rtol=0,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_softmax", [True, False])
@pytest.mark.parametrize("c", [1, 4, 9])
def test_dsra_kernel_matches_plain(cuda, c, use_softmax, dtype):
    g = torch.Generator(device=cuda).manual_seed(c)
    fg, cf, cb = (torch.randn((4, c, 44, 44), generator=g,
                              device=cuda).to(dtype) for _ in range(3))
    before = dsra.dsra_gate.launches
    got = ops.dsra_gate(fg, cf, cb, use_softmax)
    torch.cuda.synchronize()
    assert dsra.dsra_gate.launches == before + 1
    # one rounding per op on both sides; expf and the sum order differ by
    # a few f32 ulp, which can move one bf16 rounding by one step
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got, dsra.dsra_gate_plain(fg, cf, cb,
                                                         use_softmax),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_bad_inputs(cuda):
    x = torch.zeros((2, 4, 8, 8), device=cuda)
    with pytest.raises(ValueError):
        ops.max_pool3x3s2(x.to(memory_format=torch.channels_last))
    with pytest.raises(TypeError):
        ops.max_pool3x3s2(x.double())
    with pytest.raises(ValueError):
        ops.dsra_gate(x, x, x.cpu())
    with pytest.raises(TypeError):
        ops.dsra_gate(x, x.half(), x)
    with pytest.raises(ValueError):
        ops.dsra_gate(x, x[:, :2], x[:, :2])


# dsra_level: the three levels of PraNet-V2 at 352 x 352 and an odd size;
# (prev side, branch side, output side, emit_prev)
LEVELS = [(44, 11, 352, True), (11, 22, 352, False), (22, 44, 352, False),
          (13, 27, 101, True)]
GATE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_softmax", [True, False])
@pytest.mark.parametrize("c", [1, 4, 9])
@pytest.mark.parametrize("prev,ra,out,emit_prev", LEVELS,
                         ids=["level4", "level3", "level2", "odd"])
def test_dsra_level_kernel_matches_plain(cuda, prev, ra, out, emit_prev, c,
                                         use_softmax, dtype):
    """One launch; gated within the gate's tolerance of the plain chain's,
    each full-size map within one step of its type (testing.level_excess)."""
    g = torch.Generator(device=cuda).manual_seed(ra * 10 + c)
    ts = [torch.randn((4, c, s, s), generator=g, device=cuda).to(dtype)
          for s in (prev, prev, ra, ra)]
    before = dsra.dsra_level.launches
    got = ops.dsra_level(*ts, (out, out), use_softmax, emit_prev)
    torch.cuda.synchronize()
    assert dsra.dsra_level.launches == before + 1
    want = dsra.dsra_level_plain(*ts, (out, out), use_softmax, emit_prev)
    assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype)
                                                 for t in want]
    assert level_excess(got, want, (out, out), GATE_TOL[dtype]) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape,offset", [
    ((2, 64, 176, 176), 0),   # the stem at 352 x 352, batch 2
    ((1, 3, 7, 10), 0),       # odd height, output rows not 16-byte aligned
    ((3, 5, 1, 1), 0),
    ((2, 4, 33, 65), 1),      # odd sides, the map one element off alignment
])
def test_stem_pool_kernel_matches_plain(cuda, shape, offset, dtype):
    """Bit for bit, NaN and -inf inputs included."""
    g = torch.Generator(device=cuda).manual_seed(shape[-1])
    n = torch.Size(shape).numel()
    z = (torch.randn(n + offset, generator=g, device=cuda) * 2).to(dtype)
    z[offset::97] = float("nan")
    z[offset + 5::89] = float("-inf")
    z = z[offset:].view(shape)
    c = shape[1]
    vecs = [_rand(g, (c,), torch.float32, 0.1, 1.0),
            _rand(g, (c,), torch.float32, 0.1),
            _rand(g, (c,), torch.float32, 0.1),
            0.5 + torch.rand((c,), generator=g, device=cuda)]
    before = stem.stem_pool.launches
    got = ops.stem_pool(z, *vecs, 1e-5)
    torch.cuda.synchronize()
    assert stem.stem_pool.launches == before + 1
    torch.testing.assert_close(got, stem.stem_pool_plain(z, *vecs, 1e-5),
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_level_and_stem_wrappers_refuse_bad_inputs(cuda):
    x = torch.zeros((2, 1, 8, 8), device=cuda)
    p = torch.zeros((2, 1, 4, 4), device=cuda)
    with pytest.raises(ValueError):     # a CPU tensor among CUDA ones
        ops.dsra_level(p, p, x, x.cpu(), (16, 16))
    with pytest.raises(ValueError):     # not contiguous
        ops.dsra_level(p, p, x.transpose(2, 3), x, (16, 16))
    with pytest.raises(ValueError):     # ra_bg of another shape
        ops.dsra_level(p, p, x, x[:, :, :4].contiguous(), (16, 16))
    with pytest.raises(TypeError):
        ops.dsra_level(p, p.half(), x, x, (16, 16))
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.dsra_level(p, p, x.clone().requires_grad_(), x, (16, 16))
    with torch.no_grad():
        ops.dsra_level(p, p, x.clone().requires_grad_(), x, (16, 16))
    z = torch.zeros((2, 4, 8, 8), device=cuda, dtype=torch.bfloat16)
    vecs = [torch.ones(4, device=cuda) for _ in range(4)]
    with pytest.raises(ValueError):     # a vector on the CPU
        ops.stem_pool(z, vecs[0].cpu(), *vecs[1:])
    with pytest.raises(ValueError):     # channels-last memory
        ops.stem_pool(z.to(memory_format=torch.channels_last), *vecs)
    with pytest.raises(TypeError):      # BatchNorm vectors not float32
        ops.stem_pool(z, vecs[0].bfloat16(), *vecs[1:])
    with pytest.raises(ValueError):     # a vector of the wrong length
        ops.stem_pool(z, vecs[0][:3], *vecs[1:])
    weight = torch.nn.Parameter(vecs[0].clone())
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.stem_pool(z, weight, *vecs[1:])
    with torch.inference_mode():
        ops.stem_pool(z, weight, *vecs[1:])


def _forward_only_calls(cuda):
    """Each forward-only wrapper as a call whose first tensor goes through
    ``mark`` (e.g. ``requires_grad_``), at small shapes."""
    g = torch.Generator(device=cuda).manual_seed(11)
    bf = torch.bfloat16
    block = random_bottle2neck(256, 64, 0, cuda, bf)
    fa = [t.detach() for t in block.fused_args()]
    x4 = _rand(g, (1, 256, 8, 8), bf)
    cc, w3 = x4[:, :104].contiguous(), fa[6]
    mlp = _mlp_args(g, 1, 4, 4, 64, 128, bf)
    sra = _sra_block_args(g, 1, 8, 8, 64, 2, 4, bf)
    kv = _rand(g, (1, 4, 128), bf)
    dw = _rand(g, (3, 3, 128), bf)
    vecs = [torch.ones(4, device=cuda) for _ in range(4)]
    z = _rand(g, (1, 4, 8, 8), bf)
    maps = [_rand(g, (1, 1, s, s), bf) for s in (4, 4, 8, 8)]
    return {
        "max_pool3x3s2": lambda m: ops.max_pool3x3s2(m(z)),
        "stem_pool": lambda m: ops.stem_pool(m(z), *vecs),
        "dsra_level": lambda m: ops.dsra_level(m(maps[0]), *maps[1:],
                                               (16, 16)),
        "fused_bottle2neck": lambda m: res2_block.fused_bottle2neck(m(x4),
                                                                    *fa),
        "fused_tail": lambda m: res2_tail.fused_tail(m(cc), x4, w3, *fa[7:]),
        "mlp_block": lambda m: pvt_mlp.mlp_block(m(mlp[0]), *mlp[1:]),
        "sra_attention": lambda m: pvt_attn.sra_attention(
            m(sra[0]), *sra[1:5], kv, *sra[11:], 2),
        "sra_block": lambda m: ops.sra_block(m(sra[0]), *sra[1:], 2, 4),
        "pvt_block": lambda m: ops.pvt_block(
            m(sra[0]), *sra[1:], *_mlp_args(g, 1, 1, 1, 64, 128, bf)[1:9],
            2, 4),
        "depthwise_conv3x3": lambda m: ops.depthwise_conv3x3(
            m(_rand(g, (1, 4, 4, 128), bf)), dw),
    }


FORWARD_ONLY = ("max_pool3x3s2", "stem_pool", "dsra_level",
                "fused_bottle2neck", "fused_tail", "mlp_block",
                "sra_attention", "sra_block", "pvt_block",
                "depthwise_conv3x3")


@pytest.mark.cuda
@pytest.mark.parametrize("name", FORWARD_ONLY)
def test_forward_only_wrappers_refuse_grad(cuda, name):
    """F5's backstop: a forward-only kernel's wrapper raises on an input
    that requires grad while autograd records, rather than return a tensor
    with no grad_fn, and launches under no_grad."""
    call = _forward_only_calls(cuda)[name]
    with pytest.raises(RuntimeError, match="forward-only"):
        call(lambda t: t.detach().requires_grad_())
    with torch.no_grad():
        out = call(lambda t: t.detach().requires_grad_())
    torch.cuda.synchronize()
    assert out is not None
    call(lambda t: t)       # nothing requires grad: runs with grad on


@pytest.mark.cuda
def test_eval_backward_reaches_the_stem_on_the_card(no_tf32):
    """F5 repaired: pranet_v2 (depths 1, 1, 1, 1) float32 in eval with
    autograd on runs its chains on the card (no stem_pool or dsra_level
    launch; the gate's Function three times), and the backward gives the
    stem's three convolutions the gradients the CPU's chain gives them,
    within 1e-4 of the largest (summation orders differ)."""
    cpu = get_model("pranet_v2", device="cpu", layers=(1, 1, 1, 1)).eval()
    gpu = get_model("pranet_v2", device=no_tf32, layers=(1, 1, 1, 1)).eval()
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn((2, 3, 64, 64), generator=torch.Generator().manual_seed(3))
    counts = (stem.stem_pool, dsra.dsra_level, dsra.dsra_gate)
    before = [f.launches for f in counts]
    for model, xin in ((cpu, x), (gpu, x.to(no_tf32))):
        sum(m.square().mean() for m in model(xin)).backward()
    assert [f.launches - b for f, b in zip(counts, before)] == [0, 0, 3]
    for i in (0, 3, 6):
        want = cpu.backbone.conv1[i].weight.grad
        got = gpu.backbone.conv1[i].weight.grad
        assert got is not None and want is not None
        assert ((got.cpu() - want).abs().max()
                / want.abs().max()).item() < 1e-4


# PVT kernels vs their plain versions (testing.excess): within a share of
# the largest |kernel part|, the output less its residual (or, with the
# stage LN, less LN(x)), plus half a step of each side's last rounding.
# float32 differs by summation order only; bfloat16 rounds at the same
# points, and an f32 ulp of difference can move one rounding by a bf16 step,
# so two steps.  The (mu, rstd) are held to their definition, the
# statistics of the kernel's own output.
PVT_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 * 2 ** -7}


def _rand(g, shape, dtype, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=g, device=g.device) * scale
            + shift).to(dtype)


def _assert_held(got, want, tol, base=None):
    over = excess(got, want, base, tol)
    assert over <= 1, (over, (got.float() - want.float()).abs().max().item())


def _mlp_base(args, kw):
    """The block without its MLP: fc2 zeroed leaves x, or LN(x)."""
    out = pvt_mlp.mlp_block_plain(*args[:7], torch.zeros_like(args[7]),
                                  torch.zeros_like(args[8]), *args[9:], **kw)
    return out[0] if isinstance(out, tuple) else out


def _mlp_args(g, n, h, w, d, c, dtype):
    f32 = torch.float32
    return (_rand(g, (n, h, w, d), dtype), _rand(g, (d,), f32, 0.1, 1.0),
            _rand(g, (d,), f32, 0.1), _rand(g, (c, d), dtype, d ** -0.5),
            _rand(g, (c,), dtype, 0.1), _rand(g, (c, 1, 3, 3), dtype, 1 / 3),
            _rand(g, (c,), dtype, 0.1), _rand(g, (d, c), dtype, c ** -0.5),
            _rand(g, (d,), dtype, 0.1), 1e-6)


# mlp_block shapes: (n, h, w, d, c); the launch's tile splits the hidden
# channels over S = 1, 2 and 4 blocks among them (on a 132-SM H100)
MLP_SHAPES = [
    (16, 88, 88, 64, 512),     # stage 1 of PVTv2-b2 at 352x352, batch 16
    (16, 11, 11, 512, 2048),   # stage 4, batch 16
    (2, 88, 88, 64, 512),      # stage 1, batch 2
    (1, 7, 13, 64, 256),       # W not a multiple of any tile
    (2, 11, 11, 320, 1280),    # W = 11; 242 rows, not a multiple of 32
    (3, 5, 3, 32, 64),         # 45 rows, a ragged last tile everywhere
    (1, 1, 1, 512, 2048),      # one token
]


def _mlp_mode_kw(g, d, mode):
    return {"plain": {}, "stats": {"stats_eps": 1e-6},
            "final_ln": {"final_ln": (_rand(g, (d,), torch.float32, 0.1, 1.0),
                                      _rand(g, (d,), torch.float32, 0.1))}
            }[mode]


@pytest.mark.cuda
def test_mlp_shapes_cover_every_split(cuda):
    splits = {mlp_tile(*shape, torch.bfloat16)[2] for shape in MLP_SHAPES}
    assert {1, 2, 4} <= splits, splits


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["plain", "stats", "final_ln"])
@pytest.mark.parametrize("n,h,w,d,c", MLP_SHAPES)
def test_mlp_kernel_matches_plain(cuda, n, h, w, d, c, mode, dtype):
    g = torch.Generator(device=cuda).manual_seed(n * h * w + d)
    args = _mlp_args(g, n, h, w, d, c, dtype)
    kw = _mlp_mode_kw(g, d, mode)
    before = (pvt_mlp.mlp_block.launches,
              pvt_mlp.mlp_block.mode_launches[mode])
    got = pvt_mlp.mlp_block(*args, **kw)
    torch.cuda.synchronize()
    assert (pvt_mlp.mlp_block.launches,
            pvt_mlp.mlp_block.mode_launches[mode]) == (before[0] + 1,
                                                      before[1] + 1)
    want = pvt_mlp.mlp_block_plain(*args, **kw)
    if mode == "stats":
        mu, rstd = pvt_mlp.ln_stats(got[0].float(), 1e-6)
        _assert_held(got[1], mu, 1e-4)
        _assert_held(got[2], rstd, 1e-4)
        got, want = got[0], want[0]
    assert got.dtype == dtype and got.shape == want.shape
    _assert_held(got, want, PVT_TOL[dtype], _mlp_base(args, kw))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "stats", "final_ln"])
def test_mlp_block_is_one_launch(cuda, mode):
    """Stage 4 at batch 16, bf16, where the hidden channels are split: each
    call launches the on-chip MLP kernel once and no other kernel (the
    split counters' zeroing is a memset)."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device=cuda).manual_seed(3)
    args = _mlp_args(g, 16, 11, 11, 512, 2048, torch.bfloat16)
    kw = _mlp_mode_kw(g, 512, mode)
    pvt_mlp.mlp_block(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            pvt_mlp.mlp_block(*args, **kw)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "emset" not in e.name]
    assert len(names) == 3 and all("mlp_kernel" in k for k in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["stats", "final_ln"])
@pytest.mark.parametrize("n,side,d,c", [(4, 22, 320, 1280),
                                        (16, 11, 512, 2048)])
def test_mlp_split_sum_repeats(cuda, n, side, d, c, mode):
    """Stage 3 at batch 4 and stage 4 at batch 16, bf16, where blocks split
    a row tile's hidden channels and the last to finish adds their partial
    sums and runs the mode's epilogue: fifty calls give the first call's
    outputs bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(side + c)
    args = _mlp_args(g, n, side, side, d, c, torch.bfloat16)
    kw = _mlp_mode_kw(g, d, mode)
    assert mlp_tile(n, side, side, d, c, torch.bfloat16)[2] > 1
    first = pvt_mlp.mlp_block(*args, **kw)
    first = first if mode == "stats" else (first,)
    for _ in range(50):
        got = pvt_mlp.mlp_block(*args, **kw)
        got = got if mode == "stats" else (got,)
        assert all(torch.equal(a, b) for a, b in zip(got, first))


@pytest.mark.cuda
@pytest.mark.parametrize("fault", torch_pvt_faults.MLP_FAULTS)
def test_mlp_epilogue_checks_reject_planted_faults(cuda, fault):
    """Stage 2 at batch 2, bf16, x offset by 32 so that a bf16 rounding of
    the output (a step of 0.25 there) lies above the tolerance.  The
    kernel's (mu, rstd) are held to those of its own output, and those of
    a copy that takes them before the rounding fail that check; its
    stage-LN output is held to the plain version's, and not to a copy that
    rounds before the stage LN."""
    g = torch.Generator(device=cuda).manual_seed(11)
    args = _mlp_args(g, 2, 44, 44, 128, 1024, torch.bfloat16)
    args = (args[0] + 32,) + args[1:]
    mode = "stats" if fault == "stats_unrounded" else "final_ln"
    kw = _mlp_mode_kw(g, 128, mode)
    got = pvt_mlp.mlp_block(*args, **kw)
    want = pvt_mlp.mlp_block_plain(*args, **kw)
    bad = torch_pvt_faults.mlp_block(fault, *args, **kw)
    if mode == "stats":
        for out, held in ((got, True), (bad, False)):
            stats = pvt_mlp.ln_stats(out[0].float(), 1e-6)
            over = max(excess(out[i], stats[i - 1], None, 1e-4)
                       for i in (1, 2))
            assert (over <= 1) == held, over
        return
    base = _mlp_base(args, kw)
    _assert_held(got, want, PVT_TOL[torch.bfloat16], base)
    assert excess(got, bad, base, PVT_TOL[torch.bfloat16]) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("use_softmax", [True, False])
def test_dsra_gate_grad_on_the_card(cuda, use_softmax):
    """The gate's gradient through the kernel's autograd.Function on the
    card against the plain version's autograd on the CPU, float32."""
    g = torch.Generator().manual_seed(4)
    ins = [torch.randn((2, 4, 11, 11), generator=g) for _ in range(3)]
    cot = torch.randn((2, 4, 11, 11), generator=g)
    cpu = [t.clone().requires_grad_() for t in ins]
    dsra.dsra_gate_plain(*cpu, use_softmax).backward(cot)
    dev = [t.to(cuda).requires_grad_() for t in ins]
    before = dsra.dsra_gate.launches
    ops.dsra_gate(*dev, use_softmax).backward(cot.to(cuda))
    assert dsra.dsra_gate.launches == before + 1
    for a, b in zip(dev, cpu):
        torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("use_softmax", [True, False])
@pytest.mark.parametrize("c", [1, 4, 9])
def test_dsra_kernel_f64_matches_plain(cuda, c, use_softmax):
    """The gate's float64 instance (softmax in double) within 1e-12 of the
    plain version's largest |out|: exp and the sum order differ by ulps.
    ``dsra_level`` has no float64 instance and refuses it."""
    g = torch.Generator(device=cuda).manual_seed(c)
    fg, cf, cb = (torch.randn((8, c, 56, 56), generator=g, device=cuda,
                              dtype=torch.float64) for _ in range(3))
    before = dsra.dsra_gate.launches
    got = ops.dsra_gate(fg, cf, cb, use_softmax)
    torch.cuda.synchronize()
    assert dsra.dsra_gate.launches == before + 1 and got.dtype == fg.dtype
    want = dsra.dsra_gate_plain(fg, cf, cb, use_softmax)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-12
    p = fg[:, :, :7, :7].contiguous()
    with pytest.raises(TypeError):
        ops.dsra_level(p, p, fg, fg, (112, 112))


@pytest.mark.cuda
@pytest.mark.parametrize("compute", [None, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_train_step_on_the_card_runs_the_gate_kernel(no_tf32, compute):
    """One recipe train step of pranet_v2 (depths 1, 1, 1, 1) on the card:
    three gate launches a step and no stem or level kernel; float32
    parameters under bf16 autocast; a finite loss and gradient step."""
    from pranet2_tpu_torch.train import TrainState, make_optimizer
    from pranet2_tpu_torch.train.binary import make_train_step

    model = get_model("pranet_v2", device=no_tf32, layers=(1, 1, 1, 1))
    state = TrainState(model, make_optimizer(model.parameters(),
                                                     1e-4))
    step = make_train_step(model, target_size=96, rescale=True,
                           compute_dtype=compute)
    g = torch.Generator(device=no_tf32).manual_seed(5)
    x = torch.randn((2, 3, 64, 64), generator=g, device=no_tf32)
    gts = (torch.rand((2, 1, 64, 64), generator=g, device=no_tf32)
           > 0.5).float()
    counts = (stem.stem_pool, dsra.dsra_level, dsra.dsra_gate)
    before = [f.launches for f in counts]
    state, loss, losses = step(state, x, gts)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counts, before)] == [0, 0, 3]
    assert state.step == 1 and bool(torch.isfinite(losses).all())
    assert all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
               for p in model.parameters())


def _replica_masks(devices, batch=4):
    """Masks and launches of a bf16 ``pranet_v2`` predictor (one block a
    stage, ``batch`` at 96) on ``devices`` (one device: ``device=``) over 6
    images."""
    from pranet2_tpu_torch.serve import BinaryPredictor

    sd = get_model("pranet_v2", device="cpu", num_class=1,
                   layers=(1, 1, 1, 1)).state_dict()
    where = ({"device": devices[0]} if len(devices) == 1
             else {"devices": devices})
    pred = BinaryPredictor("pranet_v2", sd, batch_size=batch, testsize=96,
                           dtype=torch.bfloat16, host_workers=0,
                           model_kwargs={"layers": (1, 1, 1, 1)}, **where)
    pred.warmup()
    g = torch.Generator().manual_seed(2)
    images = [torch.randint(0, 256, (70 + 5 * i, 90, 3), generator=g,
                            dtype=torch.uint8).numpy() for i in range(6)]
    counts = (stem.stem_pool, dsra.dsra_level, dsra.dsra_gate,
              native_mask.native_masks)
    before = [f.launches for f in counts]
    masks = pred(images)
    torch.cuda.synchronize()
    pred.close()
    return masks, [f.launches - b for f, b in zip(counts, before)]


def _assert_equal_masks(got, want):
    import numpy as np

    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_two_replicas_on_one_card_launch_the_kernels(cuda):
    """``devices=["cuda:0"] * 2``: each replica runs its stem kernel once
    and its 3 decoder levels per batch (two batches of 4: 4 and 12), and
    its native-size masks once per batch that gives it an image (the
    second batch's 2 images all go to the first replica: 3), and the masks
    are one device's at the chunk's batch of 2 (three batches), bit for
    bit: the same rows through the same convolutions, and each mask made
    from its own map alone."""
    want, n_one = _replica_masks(["cuda:0"], batch=2)
    got, n_two = _replica_masks(["cuda:0"] * 2)
    assert n_one == [3, 9, 0, 3] and n_two == [4, 12, 0, 3]
    _assert_equal_masks(got, want)


@pytest.mark.cuda
def test_two_cards_predictor_launches_on_each(cuda):
    """``devices=["cuda:0", "cuda:1"]``: a replica on each card, the kernels
    launched on both, the masks one card's at the chunk's batch."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    want, _ = _replica_masks(["cuda:0"], batch=2)
    got, n_two = _replica_masks(["cuda:0", "cuda:1"])
    assert n_two == [4, 12, 0, 3]
    _assert_equal_masks(got, want)


# native sizes of served masks: an HD frame; ETIS, CVC-300 and ClinicDB
# (288 rows: down along H from 352); a pixel and sides around 352
MASK_SIZES = {"hd": [(1080, 1920)],
              "polyp_sets": [(966, 1225), (500, 574), (288, 384)],
              "edges": [(1, 1), (351, 353)],
              "full": [(288, 384), (1, 1), (351, 353), (500, 574)]}


def _masks(packed, offsets, sizes):
    flat = packed.cpu().numpy()
    return [flat[o:o + h * w].reshape(h, w) for o, (h, w) in zip(offsets,
                                                                 sizes)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MASK_SIZES))
@pytest.mark.parametrize("side", [352, 96])
def test_native_masks_kernel_matches_plain(cuda, side, case):
    """Against ``native_masks_plain`` (ATen's resize, sigmoid, min-max and
    cast) on the same card, a batch of 4 (every case but ``full`` leaves
    slots padded): each pixel within one level, at most 1e-3 of them
    apart."""
    import numpy as np

    sizes = MASK_SIZES[case]
    g = torch.Generator(device=cuda).manual_seed(side + len(sizes))
    logits = torch.randn((4, 1, side, side), generator=g, device=cuda) * 4
    before = native_mask.native_masks.launches
    packed, offsets = ops.native_masks(logits, sizes)
    torch.cuda.synchronize()
    assert native_mask.native_masks.launches == before + 1
    assert packed.device == logits.device and packed.dtype == torch.uint8
    want = _masks(*native_mask.native_masks_plain(logits, sizes), sizes)
    for got, ref in zip(_masks(packed, offsets, sizes), want):
        diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        assert diff.max() <= 1, diff.max()
        assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()


@pytest.mark.cuda
def test_native_masks_constant_map_is_zero(cuda):
    """Min equals max: every mask all zero, as ``+ 1e-8`` makes the
    reference's."""
    sizes = MASK_SIZES["full"]
    packed, offsets = ops.native_masks(
        torch.full((4, 1, 96, 96), -2.5, device=cuda), sizes)
    torch.cuda.synchronize()
    assert not any(m.any() for m in _masks(packed, offsets, sizes))


@pytest.mark.cuda
def test_native_masks_ignore_slot_and_batch(cuda):
    """An image's mask depends on its map and size alone: the same map in
    another slot of another batch, among other sizes, gives it bit for
    bit."""
    import numpy as np

    g = torch.Generator(device=cuda).manual_seed(7)
    maps = torch.randn((3, 1, 352, 352), generator=g, device=cuda) * 4
    sizes = [(966, 1225), (288, 384), (500, 574)]
    a = _masks(*ops.native_masks(maps, sizes), sizes)
    rev = maps.flip(0).contiguous()
    b = _masks(*ops.native_masks(torch.cat([rev, rev]), sizes[::-1]),
               sizes[::-1])
    one = _masks(*ops.native_masks(maps[1:2], sizes[1:2]), sizes[1:2])
    torch.cuda.synchronize()
    for x, y in zip(a, b[::-1]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a[1], one[0])


@pytest.mark.cuda
def test_native_masks_refuse_bad_inputs(cuda):
    x = torch.zeros((2, 1, 8, 8), device=cuda)
    with pytest.raises(TypeError):
        ops.native_masks(x.bfloat16(), [(4, 4)])
    with pytest.raises(ValueError):
        ops.native_masks(x.transpose(2, 3), [(4, 4)])
    with pytest.raises(ValueError):
        ops.native_masks(x, [(4, 4)] * 3)
    with pytest.raises(ValueError):
        ops.native_masks(x[:, :, None], [(4, 4)])
    with pytest.raises(RuntimeError):
        with torch.enable_grad():
            ops.native_masks(torch.zeros_like(x, requires_grad=True),
                             [(4, 4)])
    before = native_mask.native_masks.launches
    packed, offsets = ops.native_masks(x, [])
    assert packed.numel() == 0 and offsets == []
    assert native_mask.native_masks.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,d,nh,tkv", [
    (2, 88, 88, 64, 1, 121),   # stage 1 of PVTv2-b2 at 352x352, batch 2
    (2, 9, 13, 320, 5, 7),     # nh = 5, W odd, 117 rows a ragged tile
    (1, 4, 4, 512, 8, 1),      # sr = 8 on a tiny map: one K/V token
    (3, 5, 7, 128, 2, 33),
    (2, 12, 12, 64, 1, 200),   # Tkv > 128: two passes, the max first
    (2, 11, 11, 512, 16, 121),  # hd 32: a cluster of 8, two heads a block
    (2, 9, 13, 352, 11, 33),   # nh 11: a cluster of 1, eleven heads a block
])
def test_sra_kernel_matches_plain(cuda, n, h, w, d, nh, tkv, dtype):
    g = torch.Generator(device=cuda).manual_seed(h * w + d + tkv)
    f32 = torch.float32
    args = (_rand(g, (n, h, w, d), dtype), _rand(g, (d,), f32, 0.1, 1.0),
            _rand(g, (d,), f32, 0.1), _rand(g, (d, d), dtype, d ** -0.5),
            _rand(g, (d,), dtype, 0.1), _rand(g, (n, tkv, 2 * d), dtype),
            _rand(g, (d, d), dtype, d ** -0.5), _rand(g, (d,), dtype, 0.1),
            nh, 1e-6)
    before = pvt_attn.sra_attention.launches
    got = pvt_attn.sra_attention(*args)
    torch.cuda.synchronize()
    assert pvt_attn.sra_attention.launches == before + 1
    want = pvt_attn.sra_attention_plain(*args)
    assert got.dtype == dtype and got.shape == want.shape
    _assert_held(got, want, PVT_TOL[dtype], args[0])


@pytest.mark.cuda
def test_pvt_wrappers_refuse_bad_inputs(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    args = list(_mlp_args(g, 1, 4, 4, 32, 64, torch.bfloat16))
    with pytest.raises(TypeError):      # fp16 is not taken
        pvt_mlp.mlp_block(*[a.half() if torch.is_tensor(a) else a
                            for a in args])
    with pytest.raises(TypeError):      # LayerNorm parameters not float32
        pvt_mlp.mlp_block(args[0], args[1].bfloat16(), *args[2:])
    with pytest.raises(ValueError):     # x not channels-last contiguous
        pvt_mlp.mlp_block(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(ValueError):     # C not a multiple of 16
        pvt_mlp.mlp_block(*args[:3], args[3][:40], args[4][:40],
                          args[5][:40], args[6][:40], args[7][:, :40],
                          *args[8:])
    with pytest.raises(ValueError):     # weights on the CPU
        pvt_mlp.mlp_block(*args[:3], args[3].cpu(), *args[4:])
    with pytest.raises(ValueError):
        pvt_mlp.mlp_block(*args, stats_eps=1e-6, final_ln=(args[1], args[2]))
    x, w_ln, b_ln = args[:3]
    wq = _rand(g, (32, 32), torch.bfloat16)
    bq = _rand(g, (32,), torch.bfloat16)
    kv = _rand(g, (1, 4, 64), torch.bfloat16)
    with pytest.raises(ValueError):     # 32 channels in 3 heads
        pvt_attn.sra_attention(x, w_ln, b_ln, wq, bq, kv, wq, bq, 3)
    with pytest.raises(ValueError):     # head width 8, not a multiple of 32
        pvt_attn.sra_attention(x, w_ln, b_ln, wq, bq, kv, wq, bq, 4)
    with pytest.raises(ValueError):     # kv of the wrong width
        pvt_attn.sra_attention(x, w_ln, b_ln, wq, bq, kv[..., :32], wq, bq, 1)
    with pytest.raises(TypeError):
        pvt_attn.sra_attention(x, w_ln, b_ln, wq, bq, kv.float(), wq, bq, 1)
    with pytest.raises(RuntimeError):   # more K/V tokens than shared memory
        pvt_attn.sra_attention(x, w_ln, b_ln, wq, bq,
                               _rand(g, (1, 4096, 64), torch.bfloat16),
                               wq, bq, 1)
    # the refused launch leaves no error behind for the next one
    pvt_attn.sra_attention(x, w_ln, b_ln, wq, bq, kv, wq, bq, 1)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["dw_bias_dropped", "pad_before_bias",
                                   "q_bias_dropped"])
def test_pvt_checks_reject_planted_faults(cuda, fault):
    """The kernels held to a plain version with one fault planted fail the
    check above: it sees faults in the kernel's part that a tolerance
    relative to the residual would pass.  bf16 at stage-2 shapes."""
    g = torch.Generator(device=cuda).manual_seed(5)
    if fault == "q_bias_dropped":
        f32 = torch.float32
        args = (_rand(g, (2, 44, 44, 128), torch.bfloat16),
                _rand(g, (128,), f32, 0.1, 1.0), _rand(g, (128,), f32, 0.1),
                _rand(g, (128, 128), torch.bfloat16, 128 ** -0.5),
                _rand(g, (128,), torch.bfloat16, 0.1),
                _rand(g, (2, 121, 256), torch.bfloat16),
                _rand(g, (128, 128), torch.bfloat16, 128 ** -0.5),
                _rand(g, (128,), torch.bfloat16, 0.1), 2, 1e-6)
        got = pvt_attn.sra_attention(*args)
        _assert_held(got, pvt_attn.sra_attention_plain(*args),
                     PVT_TOL[torch.bfloat16], args[0])
        bad = pvt_attn.sra_attention_plain(*args[:4],
                                           torch.zeros_like(args[4]),
                                           *args[5:])
        assert excess(got, bad, args[0], PVT_TOL[torch.bfloat16]) > 1
        return
    args = _mlp_args(g, 2, 44, 44, 128, 1024, torch.bfloat16)
    if fault == "pad_before_bias":
        # with a zero LN bias, a ring of zero tokens around x gives fc1
        # outputs equal to b1 there: zero padding applied before the bias
        args = args[:2] + (torch.zeros_like(args[2]),) + args[3:]
        ring = torch.nn.functional.pad(args[0], (0, 0, 1, 1, 1, 1))
        bad = pvt_mlp.mlp_block_plain(ring, *args[1:])[:, 1:-1, 1:-1]
    else:
        bad = pvt_mlp.mlp_block_plain(*args[:6], torch.zeros_like(args[6]),
                                      *args[7:])
    got = pvt_mlp.mlp_block(*args)
    base = _mlp_base(args, {})
    _assert_held(got, pvt_mlp.mlp_block_plain(*args),
                 PVT_TOL[torch.bfloat16], base)
    assert excess(got, bad, base, PVT_TOL[torch.bfloat16]) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("fault", torch_pvt_faults.ATTN_FAULTS)
def test_attention_checks_reject_planted_faults(cuda, fault):
    """``sra_attention`` held to its plain version, and not to a copy with
    a head exchange gone wrong or with padded keys in the softmax.  bf16
    at stage-2 shapes; K scaled by 1/4, so that the scores lie near 0 and a
    padded key weighs about what a real one does, and the proj bias zero,
    so that the kernel's part is the attention's alone."""
    g = torch.Generator(device=cuda).manual_seed(9)
    f32, bf16 = torch.float32, torch.bfloat16
    kv = _rand(g, (2, 121, 256), bf16)
    kv[..., :128] *= 0.25
    args = (_rand(g, (2, 44, 44, 128), bf16),
            _rand(g, (128,), f32, 0.1, 1.0), _rand(g, (128,), f32, 0.1),
            _rand(g, (128, 128), bf16, 128 ** -0.5),
            _rand(g, (128,), bf16, 0.1), kv,
            _rand(g, (128, 128), bf16, 128 ** -0.5),
            torch.zeros(128, dtype=bf16, device=cuda), 2, 1e-6)
    got = pvt_attn.sra_attention(*args)
    _assert_held(got, pvt_attn.sra_attention_plain(*args), PVT_TOL[bf16],
                 args[0])
    bad = torch_pvt_faults.sra_attention(fault, *args)
    assert excess(got, bad, args[0], PVT_TOL[bf16]) > 1


@pytest.mark.cuda
def test_attention_cluster_split_repeats(cuda):
    """Stage 4 at batch 16, bf16, the heads split over clusters of 8
    blocks that exchange their outputs: ``sra_block`` and ``pvt_block``
    give the first call's output bit for bit on every later call."""
    g = torch.Generator(device=cuda).manual_seed(12)
    args = _sra_block_args(g, 16, 11, 11, 512, 8, 1, torch.bfloat16)
    mlp = _mlp_args(g, 1, 1, 1, 512, 2048, torch.bfloat16)[1:9]
    first = (ops.sra_block(*args, 8, 1), ops.pvt_block(*args, *mlp, 8, 1))
    for _ in range(10):
        assert torch.equal(ops.sra_block(*args, 8, 1), first[0])
        assert torch.equal(ops.pvt_block(*args, *mlp, 8, 1), first[1])


# Res2Net kernels vs their plain versions (testing.excess, base x or the
# shortcut, which dominate |out|): float32 differs by summation order only;
# bfloat16 rounds at the same points (u, u_i + sp_{i-1}, each sp_i, out),
# and an f32 ulp of difference can move one of those roundings by a bf16
# step, which the next products carry, so two steps.  The plain versions'
# convolutions run in float32, so TF32 is off.
RES2_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 * 2 ** -7}


@pytest.fixture
def no_tf32(cuda):
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def _fold(bn, fault=None):
    return torch_res2_faults.fold(fault, bn.weight, bn.bias, bn.running_mean,
                                  bn.running_var)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("planes,side", [
    (64, 88),      # layer 1 of Res2Net-50 at 352x352: 104 -> 256 channels
    (512, 11),     # layer 4: 832 -> 2048 channels, an odd width
    (128, 7),      # 208 -> 512 on a 49-pixel map
])
def test_res2_tail_kernel_matches_plain(no_tf32, planes, side, dtype):
    block = random_bottle2neck(planes * 2, planes, planes + side, no_tf32,
                               dtype, stride=2, has_downsample=True,
                               stype="stage")
    cout, cin = block.conv3.weight.shape[:2]
    g = torch.Generator(device=no_tf32).manual_seed(side)
    cc = torch.relu(_rand(g, (2, cin, side, side), dtype))
    short = _rand(g, (2, cout, side, side), dtype)
    args = (cc, short, block.conv3.weight.view(cout, cin), *_fold(block.bn3))
    before = res2_tail.fused_tail.launches
    with torch.no_grad():   # the kernel is forward only; args hold params
        got = res2_tail.fused_tail(*args)
    torch.cuda.synchronize()
    assert res2_tail.fused_tail.launches == before + 1
    want = res2_tail.res2_tail_plain(*args)
    assert got.dtype == dtype and got.shape == want.shape
    _assert_held(got, want, RES2_TOL[dtype], short)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("planes,side", [
    (64, 88),      # layer 1 of Res2Net-50 at 352x352: width 26
    (512, 11),     # layer 4: width 208, an odd map width
    (128, 5),      # width 52 on a 25-pixel map
])
def test_bottle2neck_kernel_matches_plain(no_tf32, planes, side, dtype):
    block = random_bottle2neck(planes * 4, planes, planes + side, no_tf32,
                               dtype)
    g = torch.Generator(device=no_tf32).manual_seed(side)
    x = _rand(g, (2, planes * 4, side, side), dtype)
    args = block.fused_args()
    before = res2_block.fused_bottle2neck.launches
    with torch.no_grad():   # the kernel is forward only; args hold params
        got = res2_block.fused_bottle2neck(x, *args)
    torch.cuda.synchronize()
    assert res2_block.fused_bottle2neck.launches == before + 1
    want = res2_block.bottle2neck_plain(x, *args)
    assert got.dtype == dtype and got.shape == want.shape
    _assert_held(got, want, RES2_TOL[dtype], x)
    # the module routes to the kernel in eval, and only there
    block.fused = True
    with torch.no_grad():
        torch.testing.assert_close(block(x), got, rtol=0, atol=0)
        block.train()
        block(x)
    assert res2_block.fused_bottle2neck.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("fault", torch_res2_faults.FAULTS)
def test_res2_checks_reject_planted_faults(no_tf32, fault):
    """The block kernel held to a plain version with one fault planted
    fails the check above.  bf16 at layer-2 shapes."""
    block = random_bottle2neck(512, 128, 5, no_tf32, torch.bfloat16)
    g = torch.Generator(device=no_tf32).manual_seed(6)
    x = _rand(g, (2, 512, 44, 44), torch.bfloat16)
    args = block.fused_args()
    with torch.no_grad():   # the kernel is forward only; args hold params
        got = res2_block.fused_bottle2neck(x, *args)
    _assert_held(got, res2_block.bottle2neck_plain(x, *args),
                 RES2_TOL[torch.bfloat16], x)
    if fault == "wrong_eps":
        s1, t1 = _fold(block.bn1, fault)
        sd, td = (torch.stack(v) for v in
                  zip(*(_fold(bn, fault) for bn in block.bns)))
        args = (args[0], s1, t1, args[3], sd, td, args[6],
                *_fold(block.bn3, fault))
    bad = torch_res2_faults.bottle2neck(fault, x, *args)
    assert excess(got, bad, x, RES2_TOL[torch.bfloat16]) > 1


@pytest.mark.cuda
def test_res2_wrappers_refuse_bad_inputs(cuda):
    block = random_bottle2neck(256, 64, 0, cuda, torch.bfloat16)
    x = torch.zeros((1, 256, 8, 8), device=cuda, dtype=torch.bfloat16)
    args = block.fused_args()
    with pytest.raises(TypeError):      # fp16 maps
        res2_block.fused_bottle2neck(x.half(), *args)
    with pytest.raises(TypeError):      # BatchNorm scale not float32
        res2_block.fused_bottle2neck(x, args[0], args[1].bfloat16(),
                                     *args[2:])
    with pytest.raises(ValueError):     # x not contiguous NCHW
        res2_block.fused_bottle2neck(
            x.to(memory_format=torch.channels_last), *args)
    with pytest.raises(ValueError):     # x of another width than w1 takes
        res2_block.fused_bottle2neck(x[:, :128].contiguous(), *args)
    with pytest.raises(ValueError):     # weights on the CPU
        res2_block.fused_bottle2neck(x, args[0].cpu(), *args[1:])
    cc = x[:, :104].contiguous()
    w3, s3, t3 = args[6:]
    with pytest.raises(ValueError):     # shortcut of the wrong width
        res2_tail.fused_tail(cc, x[:, :128].contiguous(), w3, s3, t3)
    with pytest.raises(TypeError):      # w3 in another type than cc
        res2_tail.fused_tail(cc, x, w3.float(), s3, t3)


@pytest.mark.cuda
def test_fused_pranet_v2_launches_both_kernels(no_tf32):
    """Depths (2, 2, 2, 2) at 64x64, bf16: four normal blocks through the
    block kernel, four stage blocks through the tail kernel."""
    kw = dict(layers=(2, 2, 2, 2), device=no_tf32, dtype=torch.bfloat16)
    plain = get_model("pranet_v2", **kw).eval()
    fused = get_model("pranet_v2", fused=True, tailfuse=True, **kw).eval()
    fused.load_state_dict(plain.state_dict())
    x = torch.randn((2, 3, 64, 64), device=no_tf32)
    before = (res2_block.fused_bottle2neck.launches,
              res2_tail.fused_tail.launches)
    with torch.no_grad():
        got, want = fused(x), plain(x)
    assert (res2_block.fused_bottle2neck.launches,
            res2_tail.fused_tail.launches) == (before[0] + 4, before[1] + 4)
    for g, w in zip(got, want):
        assert ((g.float() - w.float()).abs().max()
                / w.float().abs().max()).item() < 0.06


# The whole-half SRA, whole-block and depthwise kernels vs their plain
# versions, with PVT_TOL; the depthwise conv within 1e-5 of max |out| in
# float32 (the same sums in the same order) and one bf16 step (tol 0: the
# output's rounding).
DW_TOL = {torch.float32: 1e-5, torch.bfloat16: 0.0}


def _sra_block_args(g, n, h, w, d, nh, sr, dtype):
    """x and ``sra_block``'s parameters; the K/V path's None at sr = 1."""
    f32 = torch.float32
    kv_path = (None,) * 4
    if sr > 1:
        kv_path = (_rand(g, (d, d, sr, sr), dtype, (sr * sr * d) ** -0.5),
                   _rand(g, (d,), dtype, 0.1), _rand(g, (d,), f32, 0.1, 1.0),
                   _rand(g, (d,), f32, 0.1))
    return (_rand(g, (n, h, w, d), dtype), _rand(g, (d,), f32, 0.1, 1.0),
            _rand(g, (d,), f32, 0.1), _rand(g, (d, d), dtype, d ** -0.5),
            _rand(g, (d,), dtype, 0.1), *kv_path,
            _rand(g, (2 * d, d), dtype, d ** -0.5),
            _rand(g, (2 * d,), dtype, 0.1),
            _rand(g, (d, d), dtype, d ** -0.5), _rand(g, (d,), dtype, 0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,d,nh,sr", [
    (2, 88, 88, 64, 1, 8),     # the four PVTv2-b2 stages at 352x352
    (2, 44, 44, 128, 2, 4),
    (2, 22, 22, 320, 5, 2),
    (2, 11, 11, 512, 8, 1),
    (1, 13, 10, 128, 2, 4),    # H, W not multiples of sr: the floor
    (3, 17, 9, 64, 1, 8),      # two K/V tokens, a ragged query tile
])
def test_sra_block_kernel_matches_plain(cuda, n, h, w, d, nh, sr, dtype):
    g = torch.Generator(device=cuda).manual_seed(h * w + d + sr)
    args = _sra_block_args(g, n, h, w, d, nh, sr, dtype)
    before = (pvt_attn.sra_block.launches, pvt_attn.sra_attention.launches)
    got = ops.sra_block(*args, nh, sr)
    torch.cuda.synchronize()
    assert (pvt_attn.sra_block.launches,
            pvt_attn.sra_attention.launches) == (before[0] + 1, before[1])
    want = pvt_attn.sra_block_plain(*args, nh, sr)
    assert got.dtype == dtype and got.shape == want.shape
    _assert_held(got, want, PVT_TOL[dtype], args[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,d,nh,sr,c", [
    (2, 88, 88, 64, 1, 8, 512),    # the four PVTv2-b2 stages at 352x352,
    (2, 44, 44, 128, 2, 4, 1024),  # each its own MLP tile
    (2, 22, 22, 320, 5, 2, 1280),
    (2, 11, 11, 512, 8, 1, 2048),
    (2, 7, 13, 64, 1, 2, 256),     # W < 16, H not a multiple of the tile
    (1, 13, 10, 128, 2, 4, 256),   # the floor, 130 rows
    (3, 5, 7, 64, 2, 2, 128),      # 35 rows, a ragged last tile everywhere
])
def test_pvt_block_kernel_matches_plain(cuda, n, h, w, d, nh, sr, c, dtype):
    g = torch.Generator(device=cuda).manual_seed(h * w + d + c)
    args = (*_sra_block_args(g, n, h, w, d, nh, sr, dtype),
            *_mlp_args(g, 1, 1, 1, d, c, dtype)[1:9])
    before = pvt_block.launches
    got = ops.pvt_block(*args, nh, sr)
    torch.cuda.synchronize()
    assert pvt_block.launches == before + 1
    want = pvt_block_plain(*args, nh, sr)
    assert got.dtype == dtype and got.shape == want.shape
    _assert_held(got, want, PVT_TOL[dtype], args[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("side,d,ratio", [(88, 64, 8), (44, 128, 8),
                                          (22, 320, 4), (11, 512, 4)])
def test_block_kernel_tiles_fill_the_card(cuda, side, d, ratio, dtype):
    """PVTv2-b2's stages at batch 16: the MLP launch's tile, as its launch
    picks it, gives half the SMs a block and splits the hidden channels
    evenly; a smaller batch splits them further, up to 4 ways."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    c = d * ratio
    rows, chunk, splits = mlp_tile(16, side, side, d, c, dtype)
    assert 2 * 16 * -(-side // rows) * splits >= sms
    assert c % (chunk * splits) == 0
    assert mlp_tile(2, side, side, d, c, dtype)[2] >= splits


@pytest.mark.cuda
@pytest.mark.parametrize("n,side,d,nh,sr,c", [(4, 22, 320, 5, 2, 1280),
                                              (16, 11, 512, 8, 1, 2048)])
def test_pvt_block_split_sum_repeats(cuda, n, side, d, nh, sr, c):
    """Stage 3 at batch 4 and stage 4 at batch 16, bf16, where blocks split
    a row tile's hidden channels and the last to finish adds their partial
    sums: fifty calls give the first call's output bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(side + c)
    args = (*_sra_block_args(g, n, side, side, d, nh, sr, torch.bfloat16),
            *_mlp_args(g, 1, 1, 1, d, c, torch.bfloat16)[1:9])
    assert mlp_tile(n, side, side, d, c, torch.bfloat16)[2] > 1
    first = ops.pvt_block(*args, nh, sr)
    for _ in range(50):
        assert torch.equal(ops.pvt_block(*args, nh, sr), first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 88, 88, 512),    # PVTv2-b2's stage-1 and stage-4 hidden maps
    (2, 11, 11, 2048),
    (2, 45, 23, 512),    # H and W not multiples of the tile
    (2, 6, 9, 20),       # C = 20: 16-byte loads in float32, not in bf16
    (1, 7, 5, 3),        # C = 3: one channel a thread
    (3, 1, 1, 8),        # one pixel: every tap but the centre a border
])
def test_dwconv_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(shape[-1])
    x = _rand(g, shape, dtype)
    w = _rand(g, (3, 3, shape[-1]), dtype, 1 / 3)
    before = dwconv.depthwise_conv3x3.launches
    got = ops.depthwise_conv3x3(x, w)
    torch.cuda.synchronize()
    assert dwconv.depthwise_conv3x3.launches == before + 1
    want = dwconv.depthwise_conv3x3_plain(x, w)
    assert got.dtype == dtype and got.shape == want.shape
    _assert_held(got, want, DW_TOL[dtype])


@pytest.mark.cuda
def test_pvt_opt_wrappers_refuse_bad_inputs(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    args = list(_sra_block_args(g, 1, 8, 8, 64, 2, 4, torch.bfloat16))
    with pytest.raises(ValueError):     # H below sr
        ops.sra_block(args[0][:, :3].contiguous(), *args[1:], 2, 4)
    with pytest.raises(ValueError):     # a conv weight for sr 2
        ops.sra_block(*args[:5], args[5][..., :2, :2].contiguous(),
                      *args[6:], 2, 4)
    with pytest.raises(TypeError):      # kv LayerNorm parameters not float32
        ops.sra_block(*args[:7], args[7].bfloat16(), *args[8:], 2, 4)
    with pytest.raises(ValueError):     # head width 16
        ops.sra_block(*args, 4, 4)
    mlp = _mlp_args(g, 1, 1, 1, 64, 128, torch.bfloat16)[1:9]
    with pytest.raises(ValueError):     # C = 48, not a multiple of 32
        ops.pvt_block(*args, mlp[0], mlp[1], mlp[2][:48], mlp[3][:48],
                      mlp[4][:48], mlp[5][:48], mlp[6][:, :48].contiguous(),
                      mlp[7], 2, 4)
    x = _rand(g, (1, 4, 4, 8), torch.bfloat16)
    w = _rand(g, (3, 3, 8), torch.bfloat16)
    with pytest.raises(ValueError):     # torch's (C, 1, 3, 3) layout
        ops.depthwise_conv3x3(x, w.permute(2, 0, 1)[:, None].contiguous())
    with pytest.raises(TypeError):
        ops.depthwise_conv3x3(x, w.float())
    with pytest.raises(TypeError):
        ops.depthwise_conv3x3(x.half(), w.half())
    with pytest.raises(ValueError):     # NCHW memory
        ops.depthwise_conv3x3(x.transpose(1, 3), w)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", torch_pvt_faults.FAULTS)
def test_pvt_opt_checks_reject_planted_faults(cuda, fault):
    """The kernels held to a plain version with one fault planted fail the
    checks above.  Stage-2 shapes, bf16 (float32 for the depthwise
    conv)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    if fault == "dw_taps_transposed":
        x = _rand(g, (2, 44, 44, 1024), torch.float32)
        w = _rand(g, (3, 3, 1024), torch.float32, 1 / 3)
        got = ops.depthwise_conv3x3(x, w)
        _assert_held(got, dwconv.depthwise_conv3x3_plain(x, w),
                     DW_TOL[torch.float32])
        bad = torch_pvt_faults.depthwise_conv3x3(fault, x, w)
        assert excess(got, bad, None, DW_TOL[torch.float32]) > 1
        return
    args = _sra_block_args(g, 2, 44, 44, 128, 2, 4, torch.bfloat16)
    tol = PVT_TOL[torch.bfloat16]
    if fault in torch_pvt_faults.BLOCK_FAULTS:
        mlp = _mlp_args(g, 1, 1, 1, 128, 1024, torch.bfloat16)[1:9]
        got = ops.pvt_block(*args, *mlp, 2, 4)
        _assert_held(got, pvt_block_plain(*args, *mlp, 2, 4), tol, args[0])
        bad = torch_pvt_faults.pvt_block(fault, *args, *mlp, num_heads=2,
                                         sr=4)
    else:
        got = ops.sra_block(*args, 2, 4)
        _assert_held(got, pvt_attn.sra_block_plain(*args, 2, 4), tol,
                     args[0])
        bad = torch_pvt_faults.sra_block(fault, *args, 2, 4)
    assert excess(got, bad, args[0], tol) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("kw,launches", [
    ({"attn_impl": "v2"}, (16, 0, 16, 0)),
    ({"blockfuse": True}, (0, 0, 0, 16)),
    ({"attn_impl": "auto:2"}, (9, 7, 16, 0)),   # stages 3-4 v2, 1-2 v1
], ids=["attn_impl_v2", "blockfuse", "auto_2"])
def test_pvt_pranet_v2_options_reach_the_kernels(no_tf32, kw, launches):
    """PVTv2-b2 at full depth, 64x64, bf16: the (sra_block, sra_attention,
    mlp_block, pvt_block) launches of one forward, and the maps within 0.1
    of the float32 module chain's."""
    ref = get_model("pvt_pranet_v2", device=no_tf32).eval()
    model = get_model("pvt_pranet_v2", device=no_tf32, dtype=torch.bfloat16,
                      **kw).eval()
    model.load_state_dict(ref.state_dict())
    x = torch.randn((2, 3, 64, 64), device=no_tf32)
    counters = (pvt_attn.sra_block, pvt_attn.sra_attention,
                pvt_mlp.mlp_block, pvt_block)
    before = [f.launches for f in counters]
    with torch.no_grad():
        got, want = model(x), ref(x)
    assert tuple(f.launches - b for f, b in zip(counters, before)) == launches
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert ((g.float() - w).abs().max() / w.abs().max()).item() < 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pranet_v1", "pvt_pranet_v1",
                                  "pranet_v1_resnet"])
def test_v1_forward_on_the_card_matches_cpu(no_tf32, name):
    """PraNet-V1 at full depth, 96x96: float32 on the card (``stem_pool``
    on the Res2Net and ResNet stems, PVT's float32 blocks on the module
    chain) against the CPU's plain versions within 1e-3 of the largest
    |map|; bf16 (PVT's blocks on the attention and MLP kernels) within 0.1
    of float32; no decoder kernel (V1 has no DSRA gate)."""
    cpu = get_model(name, device="cpu").eval()
    gpu = get_model(name, device=no_tf32).eval()
    gpu.load_state_dict(cpu.state_dict())
    low = get_model(name, device=no_tf32, dtype=torch.bfloat16).eval()
    low.load_state_dict(cpu.state_dict())
    x = torch.randn((2, 3, 96, 96), generator=torch.Generator().manual_seed(1))
    counters = (stem.stem_pool, dsra.dsra_level, dsra.dsra_gate,
                pvt_attn.sra_attention, pvt_mlp.mlp_block)
    before = [f.launches for f in counters]
    with torch.inference_mode():
        want, got = cpu(x), gpu(x.to(no_tf32))
        got_bf16 = low(x.to(no_tf32))
    pvt = name == "pvt_pranet_v1"
    assert tuple(f.launches - b for f, b in zip(counters, before)) == (
        (0, 0, 0, 16, 16) if pvt else (2, 0, 0, 0, 0))
    assert len(got) == len(want) == len(got_bf16) == 4
    for g, w, b in zip(got, want, got_bf16):
        assert ((g.cpu() - w).abs().max() / w.abs().max()).item() < 1e-3
        assert ((b.float() - g).abs().max() / g.abs().max()).item() < 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,launches", [
    ("pranet_v1", {"fused": True, "tailfuse": True}, (1, 12, 4, 0, 0, 0)),
    ("pvt_pranet_v1", {"attn_impl": "v2"}, (0, 0, 0, 16, 16, 0)),
    ("pvt_pranet_v1", {"blockfuse": True}, (0, 0, 0, 0, 0, 16)),
], ids=["fused_res2net", "attn_impl_v2", "blockfuse"])
def test_v1_backbone_options_reach_the_kernels(no_tf32, name, kw, launches):
    """The backbone's keyword arguments reach V1's encoder as V2's: bf16,
    64x64, the (stem_pool, fused_bottle2neck, fused_tail, sra_block,
    mlp_block, pvt_block) launches of one forward, and the maps within 0.1
    of the float32 module chain's."""
    ref = get_model(name, device=no_tf32).eval()
    model = get_model(name, device=no_tf32, dtype=torch.bfloat16,
                      **kw).eval()
    model.load_state_dict(ref.state_dict())
    x = torch.randn((2, 3, 64, 64), device=no_tf32)
    counters = (stem.stem_pool, res2_block.fused_bottle2neck,
                res2_tail.fused_tail, pvt_attn.sra_block, pvt_mlp.mlp_block,
                pvt_block)
    before = [f.launches for f in counters]
    with torch.no_grad():
        got = model(x)
        counts = tuple(f.launches - b for f, b in zip(counters, before))
        want = ref(x)
    assert counts == launches
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert ((g.float() - w).abs().max() / w.abs().max()).item() < 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resnet_stem_pool_is_exact_on_the_card(no_tf32, dtype):
    """ResNet-50's stem tail at the serving shape (64 x 176 x 176, batch 2)
    with a random bn1: served (autograd off) it is one ``stem_pool``
    launch, bit-equal to ``F.max_pool2d(relu(bn1(z)))`` with bn1 applied
    as its fold (``fold_bn``: ``z * s + t`` in float32, rounded once);
    against the autograd route's ATen BatchNorm, which rounds its own way,
    within float32 rounding (bf16: one step) of the largest |value|."""
    import torch.nn.functional as F

    from pranet2_tpu_torch.models.backbones.resnet import resnet

    g = torch.Generator(device=no_tf32).manual_seed(4)
    net = resnet("resnet50").to(no_tf32).eval()
    bn = net.bn1
    with torch.no_grad():
        for v, lo in ((bn.weight, 0.5), (bn.running_var, 0.5)):
            v.copy_(torch.rand(v.shape, generator=g, device=no_tf32) + lo)
        for v in (bn.bias, bn.running_mean):
            v.copy_(torch.randn(v.shape, generator=g, device=no_tf32) * 0.1)
    z = torch.randn((2, 64, 176, 176), generator=g, device=no_tf32).to(dtype)
    before = stem.stem_pool.launches
    with torch.no_grad():
        got = net.stem_tail(z)
        assert stem.stem_pool.launches == before + 1
        s, t = res2_tail.fold_bn(bn.weight, bn.bias, bn.running_mean,
                                 bn.running_var, bn.eps)
        folded = torch.relu(z.float() * s[:, None, None]
                            + t[:, None, None]).to(dtype)
        torch.testing.assert_close(got, F.max_pool2d(folded, 3, 2, 1),
                                   rtol=0, atol=0)
    chain = net.stem_tail(z)            # autograd on: the module chain
    assert stem.stem_pool.launches == before + 1
    tol = 1e-6 if dtype == torch.float32 else 2 ** -7
    assert ((got.float() - chain.float()).abs().max()
            / chain.float().abs().max()).item() <= tol


# ------------------------------------------------- EMCAD's shapes (224^2)

# PVTv2-b2 at 224 x 224, EMCAD's Synapse patch: (side, dim, heads, mlp
# ratio, sr) by stage; Tkv is 49 at every stage
EMCAD_STAGES = [(56, 64, 1, 8, 8), (28, 128, 2, 8, 4), (14, 320, 5, 4, 2),
                (7, 512, 8, 4, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("n", [16, 6], ids=["serve_chunk", "train_batch"])
@pytest.mark.parametrize("side", [14, 28, 56])
def test_dsra_gate_at_emcad_shapes(cuda, side, n, dtype):
    """EMCAD's three decoder gates on Synapse (9 classes at 14/28/56 px):
    one launch, within the gate's tolerance of the plain version (float64:
    1e-12 of max |out|)."""
    g = torch.Generator(device=cuda).manual_seed(side + n)
    fg, cf, cb = (torch.randn((n, 9, side, side), generator=g, device=cuda,
                              dtype=torch.float32).to(dtype)
                  for _ in range(3))
    before = dsra.dsra_gate.launches
    got = ops.dsra_gate(fg, cf, cb)
    torch.cuda.synchronize()
    assert dsra.dsra_gate.launches == before + 1 and got.dtype == dtype
    want = dsra.dsra_gate_plain(fg, cf, cb)
    if dtype == torch.float64:
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-12
    else:
        tol = GATE_TOL[dtype]
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["stats", "final_ln"])
@pytest.mark.parametrize("stage", range(4))
def test_mlp_kernel_at_emcad_shapes(cuda, stage, mode):
    """``mlp_block`` at the four 224^2 stage shapes (bf16, batch 16): one
    launch, held to the plain version as at 352^2."""
    side, d, _, ratio, _ = EMCAD_STAGES[stage]
    g = torch.Generator(device=cuda).manual_seed(side)
    args = _mlp_args(g, 16, side, side, d, d * ratio, torch.bfloat16)
    kw = _mlp_mode_kw(g, d, mode)
    before = pvt_mlp.mlp_block.launches
    got = pvt_mlp.mlp_block(*args, **kw)
    torch.cuda.synchronize()
    assert pvt_mlp.mlp_block.launches == before + 1
    want = pvt_mlp.mlp_block_plain(*args, **kw)
    if mode == "stats":
        mu, rstd = pvt_mlp.ln_stats(got[0].float(), 1e-6)
        _assert_held(got[1], mu, 1e-4)
        _assert_held(got[2], rstd, 1e-4)
        got, want = got[0], want[0]
    _assert_held(got, want, PVT_TOL[torch.bfloat16], _mlp_base(args, kw))


@pytest.mark.cuda
@pytest.mark.parametrize("stage", range(4))
def test_sra_kernel_at_emcad_shapes(cuda, stage):
    """``sra_attention`` at the four 224^2 stage shapes (bf16, batch 16,
    Tkv 49: stage 4's 49 queries and 49 keys an image, both under the
    64-row tile)."""
    side, d, nh, _, sr = EMCAD_STAGES[stage]
    tkv = (side // sr) ** 2
    assert tkv == 49
    g = torch.Generator(device=cuda).manual_seed(side + d)
    bf, f32 = torch.bfloat16, torch.float32
    args = (_rand(g, (16, side, side, d), bf), _rand(g, (d,), f32, 0.1, 1.0),
            _rand(g, (d,), f32, 0.1), _rand(g, (d, d), bf, d ** -0.5),
            _rand(g, (d,), bf, 0.1), _rand(g, (16, tkv, 2 * d), bf),
            _rand(g, (d, d), bf, d ** -0.5), _rand(g, (d,), bf, 0.1), nh,
            1e-6)
    before = pvt_attn.sra_attention.launches
    got = pvt_attn.sra_attention(*args)
    torch.cuda.synchronize()
    assert pvt_attn.sra_attention.launches == before + 1
    _assert_held(got, pvt_attn.sra_attention_plain(*args), PVT_TOL[bf],
                 args[0])


@pytest.mark.cuda
@pytest.mark.parametrize("encoder,launches", [
    ("pvt_v2_b2", (16, 16, 3, 0)), ("resnet50", (0, 0, 3, 1))])
def test_emcad_bf16_kernel_forward_matches_module_chain(no_tf32, encoder,
                                                        launches):
    """EMCAD at full depth, 224 x 224, batch 2, 9 classes: the bf16 eval
    forward's (mlp_block, sra_attention, dsra_gate, stem_pool) launches,
    and its 8 maps within 0.1 of the largest |map| of the float32 model
    (the module chain; its gates on the float32 kernel)."""
    ref = get_model("emcad", device=no_tf32, num_classes=9,
                    encoder=encoder).eval()
    model = get_model("emcad", device=no_tf32, dtype=torch.bfloat16,
                      num_classes=9, encoder=encoder).eval()
    model.load_state_dict(ref.state_dict())
    x = torch.randn((2, 1, 224, 224), device=no_tf32,
                    generator=torch.Generator(device=no_tf32).manual_seed(0))
    counters = (pvt_mlp.mlp_block, pvt_attn.sra_attention, dsra.dsra_gate,
                stem.stem_pool)
    before = [f.launches for f in counters]
    with torch.inference_mode():
        got = model(x)
        counts = tuple(f.launches - b for f, b in zip(counters, before))
        want = ref(x)
    assert counts == launches
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
        assert ((g.float() - w).abs().max() / w.abs().max()).item() < 0.1


# -------------------------------------- MERIT's and MIST's shapes (224^2)

# the gates of a CASCADE or CAM decoder pass at 256 (MERIT's first pass,
# MIST's only one); its pass at 224 gates at EMCAD's 14, 28 and 56 px
MAXVIT_GATE_SIDES = (16, 32, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [16, 6], ids=["serve_chunk", "train_batch"])
@pytest.mark.parametrize("side", MAXVIT_GATE_SIDES)
def test_dsra_gate_at_maxvit_shapes(cuda, side, n, dtype):
    """The gates of MERIT and MIST on Synapse (9 classes at 16/32/64 px):
    one launch, within the gate's tolerance of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(side + n)
    fg, cf, cb = (torch.randn((n, 9, side, side), generator=g, device=cuda,
                              dtype=torch.float32).to(dtype)
                  for _ in range(3))
    before = dsra.dsra_gate.launches
    got = ops.dsra_gate(fg, cf, cb)
    torch.cuda.synchronize()
    assert dsra.dsra_gate.launches == before + 1 and got.dtype == dtype
    tol = GATE_TOL[dtype]
    torch.testing.assert_close(got, dsra.dsra_gate_plain(fg, cf, cb),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name,gates", [("merit_cascaded", 6),
                                        ("mist_cam", 3)])
def test_maxvit_bf16_kernel_forward_matches_module_chain(no_tf32, name,
                                                         gates):
    """MERIT-small and MIST at full depth, 224 x 224 (MERIT's backbones at
    256 and 224, MIST's at 256), batch 2, 9 classes, dual: the bf16 eval
    forward launches the gate kernel 6 and 3 times and nothing else, and
    its 8 maps are within 0.1 of the largest |map| of the float32 model
    (its gates on the float32 kernel)."""
    ref = get_model(name, device=no_tf32, num_classes=9).eval()
    model = get_model(name, device=no_tf32, dtype=torch.bfloat16,
                      num_classes=9).eval()
    model.load_state_dict(ref.state_dict())
    x = torch.rand((2, 1, 224, 224), device=no_tf32,
                   generator=torch.Generator(device=no_tf32).manual_seed(0))
    counters = (pvt_mlp.mlp_block, pvt_attn.sra_attention, dsra.dsra_gate,
                dsra.dsra_level, stem.stem_pool)
    before = [f.launches for f in counters]
    with torch.inference_mode():
        got = model(x)
        counts = tuple(f.launches - b for f, b in zip(counters, before))
        want = ref(x)
    assert counts == (0, 0, gates, 0, 0)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
        assert ((g.float() - w).abs().max() / w.abs().max()).item() < 0.1

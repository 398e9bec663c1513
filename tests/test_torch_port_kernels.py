"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

The kernels have no CPU or interpret mode, so every test here is marked
``cuda`` and skips without a GPU.  The file imports neither JAX nor the
JAX package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels.py

(``--noconftest``: tests/conftest.py sets up JAX.)
"""

import pytest
import torch

from pranet2_tpu_torch import ops
from pranet2_tpu_torch.ops import dsra, stem


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

"""The port's CUDA GroupNorm kernels against their plain versions.

Imports neither JAX nor the JAX package, so it also runs on a CUDA
machine without them: ``python -m pytest tests/port/test_torch_kernels.py
-m cuda --noconftest``. The card tests skip where there is no card; the
rest check, on the CPU, what the wrapper decides before a launch.
"""

import pytest
import torch

from mpi_opt_tpu_torch.ops import _build
from mpi_opt_tpu_torch.ops import group_norm as gn

# (C, groups) of every GN call on the main path: ResNet-18's four stage
# widths at 32 groups, folded over 1, 2 and 16 members
MAIN_PATH = [(p * c, p * 32) for p in (1, 2, 16) for c in (64, 128, 256, 512)]


@pytest.mark.parametrize("c,groups", MAIN_PATH + [(8, 4), (48, 3), (96, 32)])
def test_block_shape_holds_whole_groups(c, groups):
    gs = c // groups
    cb, rl = gn._block_shape(c, gs)
    assert c % cb == 0 and cb % gs == 0
    assert 1 <= cb * rl <= 1024
    if (c, groups) in MAIN_PATH:
        assert cb == 64 and rl == 4  # 128-byte bf16 row segments, 256 threads


def test_group_size_over_a_block_is_refused():
    with pytest.raises(ValueError, match="group size"):
        gn._block_shape(4096, 2048)


def test_cpu_path_never_builds(monkeypatch):
    monkeypatch.setattr(_build, "build", lambda name: pytest.fail("built on the CPU path"))
    x = torch.randn(2, 16, 64)
    y = gn.group_norm_relu(x.requires_grad_(), torch.ones(64), torch.zeros(64), 32)
    y.sum().backward()
    assert x.grad.shape == x.shape


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("group_norm")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("c,groups", [(64, 32), (8, 4), (1024, 512)])
def test_kernels_match_plain_on_card(cuda_device, c, groups, relu, dtype):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(c)
    x = torch.randn((3, 64, c), generator=g, device=cuda_device).to(dtype)
    dy = torch.randn((3, 64, c), generator=g, device=cuda_device).to(dtype)
    gamma = 1.0 + 0.5 * torch.randn(c, generator=g, device=cuda_device)
    beta = 0.1 * torch.randn(c, generator=g, device=cuda_device)
    gn.reset_launches()
    y, mean, rstd = gn.gn_fwd(x, gamma, beta, groups, 1e-6, relu)
    dx, dgm, dbt = gn.gn_bwd(x, dy, gamma, beta, mean, rstd, groups, relu)
    assert gn.LAUNCHES == {"gn_fwd": 1, "gn_bwd": 1, "plain": 0}
    yp, meanp, rstdp = gn.group_norm_relu_plain(x, gamma, beta, groups, 1e-6, relu)
    # the backward of both from the kernel's statistics: same ReLU masks
    dxp, dgmp, dbtp = gn.group_norm_relu_bwd_plain(x, dy, gamma, beta, mean, rstd, groups, relu)
    # bf16 outputs may differ by two bf16 steps (2^-6 relative)
    tol = dict(atol=1e-4, rtol=0.0) if dtype == torch.float32 else dict(atol=1e-4, rtol=2**-6)
    torch.testing.assert_close(y.float(), yp.float(), **tol)
    torch.testing.assert_close(dx.float(), dxp.float(), **tol)
    torch.testing.assert_close(mean, meanp, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(rstd, rstdp, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(dgm, dgmp, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(dbt, dbtp, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
def test_autograd_on_card_launches_kernels_only(cuda_device):
    x = torch.randn((2, 4, 4, 128), device=cuda_device, dtype=torch.bfloat16, requires_grad=True)
    gamma = torch.ones(128, device=cuda_device, requires_grad=True)
    beta = torch.zeros(128, device=cuda_device, requires_grad=True)
    gn.reset_launches()
    gn.group_norm_relu(x, gamma, beta, 32).float().sum().backward()
    assert gn.LAUNCHES == {"gn_fwd": 1, "gn_bwd": 1, "plain": 0}
    assert gamma.grad.shape == (128,) and x.grad.dtype == torch.bfloat16

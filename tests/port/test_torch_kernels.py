"""The port's CUDA GroupNorm kernels against their plain versions.

Imports neither JAX nor the JAX package, so it also runs on a CUDA
machine without them: ``python -m pytest tests/port/test_torch_kernels.py
-m cuda --noconftest``. The card tests skip where there is no card; the
rest check, on the CPU, what the wrapper decides before a launch.
"""

import numpy as np
import pytest
import torch

from mpi_opt_tpu_torch.ops import _build
from mpi_opt_tpu_torch.ops import group_norm as gn

# (S, C, groups) of every GN call on the main path: ResNet-18's four
# stages at 32 groups, folded over 1, 2 and 16 members
MAIN_PATH = [(s, p * c, p * 32) for p in (1, 2, 16) for s, c in ((1024, 64), (256, 128), (64, 256), (16, 512))]
# SmallCNN: C = P*32 at 32x32, P*64 at 16x16, 8 groups a member; the
# north-star sweep runs members in chunks of 32
SMALL_CNN = [(s, p * c, p * 8) for p in (1, 2, 16, 32, 256) for s, c in ((1024, 32), (256, 64))]
ODD = [(64, 8, 4), (64, 48, 3), (64, 96, 32)]


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("s,c,groups", MAIN_PATH + SMALL_CNN + ODD)
def test_block_shape_holds_whole_groups(s, c, groups, dtype, backward):
    for n in (128, 1024):  # a training batch and an eval chunk
        p = gn.gn_plan(n, s, c, groups, dtype, backward)
        elt = torch.empty((), dtype=dtype).element_size()
        assert c % p.cb == 0 and p.cb % (c // groups) == 0  # whole groups, C divided exactly
        assert (p.cb * elt) % 16 == 0  # 16-byte slices: every access is 16 bytes
        assert p.smem <= gn.SMEM_MAX and p.smem >= (2 if backward else 1) * p.rb * p.cb * elt
        assert 1 <= p.cluster <= gn.MAX_CLUSTER
        # the grid (cluster, C / cb, N) divides by the cluster dims
        # (cluster, 1, 1), and its blocks cover the rows, none of them empty
        assert p.cluster * p.rb >= s > (p.cluster - 1) * p.rb
        assert p.threads % 32 == 0 and p.threads <= gn.MAX_THREADS
        assert 1 <= p.rl and p.rl * (p.cb * elt // 16) <= p.threads
    if (s, c, groups) in MAIN_PATH and s == 1024:
        assert p.cluster > 1  # stage 0 does not fit one block
    if (s, c, groups) == (16, 16 * 512, 16 * 32) and dtype == torch.bfloat16:
        assert p.cb == 1024  # ~32 KB tiles, not 64 channels


@pytest.mark.parametrize(
    "n,s,c,groups",
    [(128, 16, 4096, 1), (1, 16384, 64, 32), (65536, 16, 64, 32), (2, 16, 64, 0)],
    ids=["group-over-256-columns", "rows-over-8-blocks", "grid-over-65535", "no-groups"],
)
def test_group_size_over_a_block_is_refused(n, s, c, groups):
    with pytest.raises(ValueError, match=rf"no GroupNorm plan holds \[{n}, {s}, {c}\]"):
        gn.gn_plan(n, s, c, groups, torch.bfloat16, True)


def test_launch_check_takes_unaligned_parameter_views():
    # gamma and beta as views of one flat parameter buffer, at 4-byte
    # offsets: the kernels read them one float at a time
    buf = torch.zeros(1 + 2 * 64)
    gamma, beta = buf[1:65], buf[65:]
    assert gamma.data_ptr() % 16 and beta.data_ptr() % 16
    gn._check_launch("gn_fwd", (torch.zeros(2, 16, 64),), (gamma, beta))
    x = torch.zeros(1 + 2 * 16 * 64)[1:].view(2, 16, 64)  # moved 16 bytes at a time
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        gn._check_launch("gn_fwd", (x,), (gamma, beta))


def test_meta_tensors_take_the_plain_path_uncounted():
    # shapes only, as utils/flops.py counts a step: nothing runs, nothing counts
    x = torch.empty(2, 16, 64, device="meta", requires_grad=True)
    gamma = torch.ones(64, device="meta", requires_grad=True)
    gn.reset_launches()
    y = gn.group_norm_relu(x, gamma, torch.zeros(64, device="meta"), 32)
    y.sum().backward()
    assert y.device.type == "meta" and x.grad.shape == x.shape
    assert gn.LAUNCHES == {"gn_fwd": 0, "gn_bwd": 0, "plain": 0}


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


def _card_inputs(device, n, s, c, dtype, seed):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = torch.randn((n, s, c), generator=g, device=device).to(dtype)
    dy = torch.randn((n, s, c), generator=g, device=device).to(dtype)
    gamma = 1.0 + 0.5 * torch.randn(c, generator=g, device=device)
    beta = 0.1 * torch.randn(c, generator=g, device=device)
    return x, dy, gamma, beta


def _assert_kernels_match_plain(x, dy, gamma, beta, groups, relu):
    gn.reset_launches()
    y, mean, rstd = gn.gn_fwd(x, gamma, beta, groups, 1e-6, relu)
    dx, dgm, dbt = gn.gn_bwd(x, dy, gamma, beta, mean, rstd, groups, relu)
    assert gn.LAUNCHES == {"gn_fwd": 1, "gn_bwd": 1, "plain": 0}
    yp, meanp, rstdp = gn.group_norm_relu_plain(x, gamma, beta, groups, 1e-6, relu)
    # the backward of both from the kernel's statistics: same ReLU masks
    dxp, dgmp, dbtp = gn.group_norm_relu_bwd_plain(x, dy, gamma, beta, mean, rstd, groups, relu)
    # bf16 outputs may differ by two bf16 steps (2^-6 relative)
    tol = dict(atol=1e-4, rtol=0.0) if x.dtype == torch.float32 else dict(atol=1e-4, rtol=2**-6)
    torch.testing.assert_close(y.float(), yp.float(), **tol)
    torch.testing.assert_close(dx.float(), dxp.float(), **tol)
    torch.testing.assert_close(mean, meanp, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(rstd, rstdp, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(dgm, dgmp, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(dbt, dbtp, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("c,groups", [(64, 32), (8, 4), (1024, 512)])
def test_kernels_match_plain_on_card(cuda_device, c, groups, relu, dtype):
    x, dy, gamma, beta = _card_inputs(cuda_device, 3, 64, c, dtype, c)
    _assert_kernels_match_plain(x, dy, gamma, beta, groups, relu)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "n,s,c,groups",
    [(2, 1024, 1024, 512), (2, 1023, 64, 32), (2, 64, 64, 64), (1024, 64, 256, 128)],
    ids=["stage0-cluster", "rows-not-a-multiple-of-the-share", "group-size-1", "eval-chunk"],
)
def test_kernels_match_plain_at_edge_shapes(cuda_device, n, s, c, groups, dtype):
    p = gn.gn_plan(n, s, c, groups, dtype, True)
    if s >= 1023:
        assert p.cluster > 1  # the cluster split engages
    if s == 1023:
        assert s % p.rb != 0
    x, dy, gamma, beta = _card_inputs(cuda_device, n, s, c, dtype, s + c)
    _assert_kernels_match_plain(x, dy, gamma, beta, groups, relu=True)


@pytest.mark.cuda
def test_kernels_take_unaligned_parameter_views(cuda_device):
    x, dy, gamma, beta = _card_inputs(cuda_device, 2, 64, 64, torch.bfloat16, 3)
    buf = torch.empty(1 + 2 * 64, device=cuda_device)
    buf[1:65], buf[65:] = gamma, beta
    _assert_kernels_match_plain(x, dy, buf[1:65], buf[65:], 32, relu=True)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [64, 1024])
def test_relu_masks_agree_bit_for_bit_where_z_is_zero(cuda_device, s):
    # every group's rows come in +/- pairs of small integers, so its sum
    # is exactly 0 in any order; with beta = 0, z = 0 exactly wherever
    # x = 0, and the mask there must be off in all three versions
    n, c, groups = 2, 64, 32
    g = torch.Generator(device=cuda_device)
    g.manual_seed(s)
    half = torch.randint(-2, 3, (n, s // 2, c), generator=g, device=cuda_device).float()
    x = torch.cat([half, -half], dim=1)
    gamma = 1.0 + 0.5 * torch.randn(c, generator=g, device=cuda_device)
    beta = torch.zeros(c, device=cuda_device)
    assert int((x == 0).sum()) > 0
    y, mean, rstd = gn.gn_fwd(x, gamma, beta, groups, 1e-6, True)
    yp, _, _ = gn.group_norm_relu_plain(x, gamma, beta, groups, 1e-6, True)
    assert torch.equal(mean, torch.zeros_like(mean))
    assert torch.equal(y > 0, yp > 0)
    assert bool((y[x == 0] == 0).all())
    # dy = 1: dbeta counts the backward's mask, channel by channel
    ones = torch.ones_like(x)
    _, _, dbt = gn.gn_bwd(x, ones, gamma, beta, mean, rstd, groups, True)
    _, _, dbtp = gn.group_norm_relu_bwd_plain(x, ones, gamma, beta, mean, rstd, groups, True)
    assert torch.equal(dbt, (y > 0).float().sum(dim=1))
    assert torch.equal(dbt, dbtp)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [64, 1024])
def test_nan_in_x_reaches_y(cuda_device, s):
    x, _, gamma, beta = _card_inputs(cuda_device, 2, s, 64, torch.float32, 7)
    x[1, s // 2, 5] = float("nan")
    y, mean, _ = gn.gn_fwd(x, gamma, beta, 32, 1e-6, True)
    yp, _, _ = gn.group_norm_relu_plain(x, gamma, beta, 32, 1e-6, True)
    assert torch.equal(torch.isnan(y), torch.isnan(yp))
    assert bool(torch.isnan(y[1, :, 4:6]).all()) and bool(torch.isnan(mean[1, 2]))
    ok = ~torch.isnan(yp)
    torch.testing.assert_close(y[ok], yp[ok], atol=1e-4, rtol=0.0)


@pytest.mark.cuda
def test_autograd_on_card_launches_kernels_only(cuda_device):
    x = torch.randn((2, 4, 4, 128), device=cuda_device, dtype=torch.bfloat16, requires_grad=True)
    gamma = torch.ones(128, device=cuda_device, requires_grad=True)
    beta = torch.zeros(128, device=cuda_device, requires_grad=True)
    gn.reset_launches()
    gn.group_norm_relu(x, gamma, beta, 32).float().sum().backward()
    assert gn.LAUNCHES == {"gn_fwd": 1, "gn_bwd": 1, "plain": 0}
    assert gamma.grad.shape == (128,) and x.grad.dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,c,groups", [(s, p * c, p * 8) for p in (32, 256) for s, c in ((1024, 32), (256, 64))],
                         ids=["p32-32x32", "p32-16x16", "p256-32x32", "p256-16x16"])
def test_kernels_match_plain_at_small_cnn_shapes(cuda_device, s, c, groups, dtype):
    # groups of 4 channels: half of a 16-byte bf16 vector, a quarter of f32 ones
    x, dy, gamma, beta = _card_inputs(cuda_device, 4, s, c, dtype, c + s)
    _assert_kernels_match_plain(x, dy, gamma, beta, groups, relu=True)


def _near_constant_groups(n, s, c, groups, seed):
    """x = base + N(0, 1e-3) with base uniform in [50, 3000] per group, f32:
    there E[x^2] - mean^2 is f32 rounding noise, often below -eps."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(50, 3000, (n, 1, groups, 1))
    x = base + rng.normal(0.0, 1e-3, (n, s, groups, c // groups))
    return torch.from_numpy(x.reshape(n, s, c).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,c,groups", [(50, 64, 4, 1), (6, 64, 32, 8), (4, 1024, 1024, 256)])
def test_variance_is_clamped_on_card(cuda_device, n, s, c, groups):
    """The kernel's variance sums in another order than the plain
    version's, so at these inputs their rstd differ (both rounding
    noise); what must hold is finite output, rstd <= 1/sqrt(eps), the
    means, and with gamma = 0 the output relu(beta) itself."""
    x = _near_constant_groups(n, s, c, groups, seed=c).to(cuda_device)
    gamma = torch.ones(c, device=cuda_device)
    beta = torch.zeros(c, device=cuda_device)
    y, mean, rstd = gn.gn_fwd(x, gamma, beta, groups, 1e-6, True)
    _, meanp, _ = gn.group_norm_relu_plain(x, gamma, beta, groups, 1e-6, True)
    dx, _, _ = gn.gn_bwd(x, torch.ones_like(x), gamma, beta, mean, rstd, groups, True)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(dx).all())
    assert bool((rstd <= 1e3 * (1 + 1e-6)).all())
    torch.testing.assert_close(mean, meanp, atol=0.0, rtol=4e-6)
    beta = torch.randn(c, generator=torch.Generator(device=cuda_device).manual_seed(1), device=cuda_device)
    y0, _, _ = gn.gn_fwd(x, torch.zeros_like(gamma), beta, groups, 1e-6, True)
    torch.testing.assert_close(y0, torch.relu(beta).expand_as(x), atol=1e-6, rtol=0.0)

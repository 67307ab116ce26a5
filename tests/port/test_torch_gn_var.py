"""GroupNorm's variance is clamped at 0, as flax's ``nn.GroupNorm`` clamps it.

Near-constant groups at a large mean: ``x = base + N(0, 1e-3)`` with
``base`` uniform in [50, 3000], f32. There ``E[x^2] - mean^2`` is below
the f32 resolution of ``E[x^2]``, so each implementation's variance is
rounding noise, and unclamped it is often negative by more than eps:
``rsqrt`` of a negative number is NaN, and the whole group's output is
NaN. Clamped, ``rstd <= 1/sqrt(eps)``.

Because the variance is rounding noise, the outputs of the port, flax
and the two-pass ``reference_group_norm_relu`` differ by O(1) at these
inputs (each sums in its own order), so what is held equal is what
does not depend on that noise: every output finite, the means to the
rounding of an f32 sum, every |y| within ``max|x - mean| / sqrt(eps)``,
and, with ``gamma = 0``, y itself (``relu(beta)``, within 1e-6, where
an unclamped NaN rstd still gives NaN).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_opt_tpu.ops.pallas_gn import reference_group_norm_relu
from mpi_opt_tpu_torch.ops import group_norm as gn

EPS = 1e-6
# (N, S, C, groups): the probe's one group of 4 channels, and SmallCNN's
# 4-channel groups, 8 a sample
SHAPES = [(50, 64, 4, 1), (6, 64, 32, 8)]


def _inputs(n, s, c, groups, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(50, 3000, (n, 1, groups, 1))
    x = base + rng.normal(0.0, 1e-3, (n, s, groups, c // groups))
    return x.reshape(n, s, c).astype(np.float32)


def _three(x, gamma, beta, groups):
    """y of the port (through autograd, with its statistics), flax
    (GroupNorm then ReLU) and the reference, as numpy arrays."""
    xt = torch.from_numpy(x).requires_grad_()
    y = gn.group_norm_relu(xt, torch.from_numpy(gamma), torch.from_numpy(beta), groups, EPS)
    y.sum().backward()
    _, mean, rstd = gn.group_norm_relu_plain(torch.from_numpy(x), torch.from_numpy(gamma),
                                              torch.from_numpy(beta), groups, EPS)
    layer = nn.GroupNorm(num_groups=groups, epsilon=EPS)
    params = {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}
    y_flax = jax.nn.relu(layer.apply({"params": params}, jnp.asarray(x)))
    y_ref = reference_group_norm_relu(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups, EPS)
    return (y.detach().numpy(), xt.grad.numpy(), mean.numpy(), rstd.numpy(),
            np.asarray(y_flax), np.asarray(y_ref))


@pytest.mark.parametrize("n,s,c,groups", SHAPES)
def test_near_constant_groups_stay_finite(n, s, c, groups):
    x = _inputs(n, s, c, groups)
    y, dx, mean, rstd, y_flax, y_ref = _three(x, np.ones(c, np.float32), np.zeros(c, np.float32), groups)
    for name, a in (("port y", y), ("port dx", dx), ("port rstd", rstd), ("flax", y_flax), ("reference", y_ref)):
        assert np.isfinite(a).all(), f"{name}: {int((~np.isfinite(a)).sum())} non-finite"
    assert (rstd <= 1.0 / np.sqrt(EPS) * (1 + 1e-6)).all()
    xg = x.astype(np.float64).reshape(n, s, groups, c // groups)
    want_mean = xg.mean(axis=(1, 3))
    # an f32 sum of 256 values: a few units of 2^-24 relative per level
    np.testing.assert_allclose(mean, want_mean, rtol=4e-6, atol=0)
    spread = np.abs(xg - want_mean[:, None, :, None]).max()
    for a in (y, y_flax, y_ref):
        assert np.abs(a).max() <= (spread + 1e-3) / np.sqrt(EPS)


@pytest.mark.parametrize("n,s,c,groups", SHAPES)
def test_near_constant_groups_with_zero_gamma_agree(n, s, c, groups):
    x = _inputs(n, s, c, groups, seed=1)
    beta = np.random.default_rng(2).standard_normal(c).astype(np.float32)
    y, _, _, _, y_flax, y_ref = _three(x, np.zeros(c, np.float32), beta, groups)
    want = np.broadcast_to(np.maximum(beta, 0.0), x.shape)
    for a in (y, y_flax, y_ref):
        np.testing.assert_allclose(a, want, atol=1e-6, rtol=0)


def test_unclamped_variance_goes_negative_at_these_inputs():
    """The inputs do reach the fault: E[x^2] - mean^2 < -eps in f32 for
    some groups, which the clamp then holds at 0."""
    n, s, c, groups = SHAPES[0]
    xg = torch.from_numpy(_inputs(n, s, c, groups)).reshape(n, s, groups, c // groups)
    mean = xg.mean(dim=(1, 3))
    var = (xg * xg).mean(dim=(1, 3)) - mean * mean
    assert int((var < -EPS).sum()) > 0

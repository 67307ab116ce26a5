"""The port's fused GroupNorm(+ReLU) against the JAX package's.

On the CPU the port's wrapper runs its plain version; the JAX side runs
the Pallas kernel in interpret mode (as tests/test_pallas_gn.py does)
and its jnp reference. Tolerances are those of tests/test_pallas_gn.py:
forward atol 1e-4, gradients atol 1e-3 in f32, 3e-2 in bf16. The CUDA
kernels themselves are held against the plain version on the card
(test_torch_kernels.py, and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_opt_tpu.ops.pallas_gn as pg
from mpi_opt_tpu_torch.ops import group_norm as gn


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pg, "_INTERPRET", True)


def _inputs(c, b=2, hw=4, seed=0, lead=()):
    rng = np.random.default_rng([seed, c])
    x = rng.standard_normal(lead + (b, hw, hw, c)).astype(np.float32)
    gamma = (1.0 + 0.5 * rng.standard_normal(lead + (c,))).astype(np.float32)
    beta = (0.1 * rng.standard_normal(lead + (c,))).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    return x, gamma, beta, dy


def _port(x, gamma, beta, dy, groups, relu, dtype=torch.float32):
    """(y, dx, dgamma, dbeta) from the port's autograd Function on the CPU."""
    xt = torch.tensor(x).to(dtype).requires_grad_()
    gt = torch.tensor(gamma, requires_grad=True)
    bt = torch.tensor(beta, requires_grad=True)
    y = gn.group_norm_relu(xt, gt, bt, groups, 1e-6, relu)
    (y.float() * torch.tensor(dy)).sum().backward()
    return [t.detach().float().numpy() for t in (y, xt.grad, gt.grad, bt.grad)]


@pytest.mark.parametrize("c,groups", [(64, 32), (128, 32), (8, 4)])
@pytest.mark.parametrize("relu", [True, False])
def test_plain_matches_jax_kernel_and_reference(c, groups, relu):
    x, gamma, beta, dy = _inputs(c)
    y, dx, dg, db = _port(x, gamma, beta, dy, groups, relu)
    for fn in (pg.group_norm_relu, pg.reference_group_norm_relu):
        want = fn(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups, 1e-6, relu)
        np.testing.assert_allclose(y, np.asarray(want), atol=1e-4)
        loss = lambda x_, g_, b_: jnp.sum(fn(x_, g_, b_, groups, 1e-6, relu) * dy)
        grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
        for got, w in zip((dx, dg, db), grads):
            np.testing.assert_allclose(got, np.asarray(w), atol=1e-3)


@pytest.mark.parametrize("relu", [True, False])
def test_plain_bf16_matches_jax_kernel(relu):
    x, gamma, beta, dy = _inputs(64, seed=1)
    y, dx, dg, db = _port(x, gamma, beta, dy, 32, relu, dtype=torch.bfloat16)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = pg.group_norm_relu(xb, jnp.asarray(gamma), jnp.asarray(beta), 32, 1e-6, relu)
    np.testing.assert_allclose(y, np.asarray(want, np.float32), atol=3e-2)
    loss = lambda x_, g_, b_: jnp.sum(
        pg.group_norm_relu(x_, g_, b_, 32, 1e-6, relu).astype(jnp.float32) * dy
    )
    grads = jax.grad(loss, argnums=(0, 1, 2))(xb, jnp.asarray(gamma), jnp.asarray(beta))
    for got, w in zip((dx, dg, db), grads):
        np.testing.assert_allclose(got, np.asarray(w, np.float32), atol=3e-2 * max(1.0, float(np.abs(w).max())))


def test_folded_population_equals_vmap_over_members():
    """P members folded into channels (P*G groups, gamma flattened) is
    per-member GroupNorm: y, dx and the per-member dgamma/dbeta match
    jax.vmap of the Pallas kernel."""
    p, c, groups = 3, 64, 32
    x, gamma, beta, dy = _inputs(c, seed=2, lead=(p,))  # x [P, B, H, W, C]
    fn = lambda x_, g_, b_: pg.group_norm_relu(x_, g_, b_, groups, 1e-6, True)
    loss = lambda x_, g_, b_: jnp.sum(jax.vmap(fn)(x_, g_, b_) * dy)
    want_y = jax.vmap(fn)(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))

    fold = lambda a: np.ascontiguousarray(np.moveaxis(a, 0, -2)).reshape(a.shape[1:-1] + (p * c,))
    unfold = lambda a: np.moveaxis(a.reshape(a.shape[:-1] + (p, c)), -2, 0)
    y, dx, dg, db = _port(fold(x), gamma.reshape(-1), beta.reshape(-1), fold(dy), p * groups, True)
    np.testing.assert_allclose(unfold(y), np.asarray(want_y), atol=1e-4)
    np.testing.assert_allclose(unfold(dx), np.asarray(want[0]), atol=1e-3)
    np.testing.assert_allclose(dg.reshape(p, c), np.asarray(want[1]), atol=1e-3)
    np.testing.assert_allclose(db.reshape(p, c), np.asarray(want[2]), atol=1e-3)


def test_non_dividing_group_count_raises():
    x, gamma, beta, _ = _inputs(48)
    with pytest.raises(ValueError, match="divisible"):
        gn.group_norm_relu(torch.tensor(x), torch.tensor(gamma), torch.tensor(beta), 32)


@pytest.mark.parametrize(
    "bad",
    [
        dict(x=np.zeros((2, 4, 4, 8), np.float64)),  # dtype
        dict(gamma=np.ones(4, np.float32)),  # shape
        dict(beta=np.zeros(8, np.float16)),  # dtype
    ],
)
def test_wrapper_refuses_what_it_does_not_take(bad):
    args = dict(x=np.zeros((2, 4, 4, 8), np.float32), gamma=np.ones(8, np.float32),
                beta=np.zeros(8, np.float32))
    args.update(bad)
    with pytest.raises((TypeError, ValueError)):
        gn.group_norm_relu(*(torch.tensor(args[k]) for k in ("x", "gamma", "beta")), 4)


def test_cpu_call_counts_only_plain():
    gn.reset_launches()
    x, gamma, beta, dy = _inputs(8)
    _port(x, gamma, beta, dy, 4, True)
    assert gn.LAUNCHES == {"gn_fwd": 0, "gn_bwd": 0, "plain": 2}

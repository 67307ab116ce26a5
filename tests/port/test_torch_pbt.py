"""PBT exploit/explore and ranking of the port against the JAX package.

Given the JAX package's own draws (the four-way key split of
``ops/pbt.py::_exploit_explore``), the port's apply makes the same
decision bit for bit: ``src_idx``, ``bottom`` and ``new_unit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_opt_tpu.ops import PBTConfig as JaxPBTConfig
from mpi_opt_tpu.ops import pbt_exploit_explore as jax_pbt
from mpi_opt_tpu.ops.common import rank_descending as jax_rank
from mpi_opt_tpu_torch.ops.common import rank_descending
from mpi_opt_tpu_torch.ops.pbt import (
    PBTConfig,
    apply_exploit_explore,
    n_cut,
    pbt_exploit_explore,
)


def _tied_scores(n, seed):
    """Accuracies are multiples of 1/n_val: many ties, plus NaN and -inf."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 6, n).astype(np.float32) / 8.0
    s[rng.choice(n, 3, replace=False)] = [np.nan, -np.inf, np.nan]
    return s


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_descending_matches_jax_with_ties_and_nan(seed):
    s = _tied_scores(33, seed)
    rank, order = rank_descending(torch.from_numpy(s))
    jrank, jorder = jax_rank(jnp.asarray(s))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
    assert np.isnan(s[order.numpy()[-2:]]).all()  # NaN ranks last


def _jax_draws(key, n, d, cfg):
    """The draws of ops/pbt.py::_exploit_explore, in its key order."""
    k_src, k_noise, k_res, k_res_val = jax.random.split(key, 4)
    return (
        np.array(jax.random.randint(k_src, (n,), 0, n_cut(n, cfg))),
        np.array(jax.random.normal(k_noise, (n, d))),
        np.array(jax.random.uniform(k_res, (n, d))),
        np.array(jax.random.uniform(k_res_val, (n, d))),
    )


@pytest.mark.parametrize("n,frac,seed", [(16, 0.25, 0), (33, 0.25, 1), (10, 0.25, 2), (8, 0.5, 3)])
def test_exploit_explore_bit_equal_given_jax_draws(n, frac, seed):
    d = 4
    rng = np.random.default_rng(seed)
    unit = rng.random((n, d), dtype=np.float32)
    scores = _tied_scores(n, seed)
    disc = np.array([False, True, False, True])
    key = jax.random.key(seed)
    jcfg = JaxPBTConfig(truncation_frac=frac, perturb_scale=0.3, resample_prob=0.5)
    cfg = PBTConfig(truncation_frac=frac, perturb_scale=0.3, resample_prob=0.5)
    j_unit, j_src, j_bottom = jax_pbt(key, jnp.asarray(unit), jnp.asarray(scores), jnp.asarray(disc), jcfg)
    draws = tuple(torch.from_numpy(a).long() if i == 0 else torch.from_numpy(a)
                  for i, a in enumerate(_jax_draws(key, n, d, cfg)))
    new_unit, src, bottom = apply_exploit_explore(
        torch.from_numpy(unit), torch.from_numpy(scores), disc, cfg, draws
    )
    np.testing.assert_array_equal(src.numpy(), np.asarray(j_src))
    np.testing.assert_array_equal(bottom.numpy(), np.asarray(j_bottom))
    np.testing.assert_array_equal(new_unit.numpy(), np.asarray(j_unit))


def _setup(n=16, d=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    unit = torch.rand((n, d), generator=g)
    scores = torch.rand((n,), generator=g)
    return g, unit, scores, np.array([False, False, True])


def test_survivors_untouched():
    g, unit, scores, disc = _setup()
    new_unit, src_idx, bottom = pbt_exploit_explore(g, unit, scores, disc, PBTConfig(truncation_frac=0.25))
    assert int(bottom.sum()) == 4
    keep = ~bottom
    torch.testing.assert_close(new_unit[keep], unit[keep], rtol=0, atol=0)
    assert torch.equal(src_idx[keep], torch.arange(16)[keep])


def test_losers_copy_from_top():
    g, unit, scores, disc = _setup(n=32)
    _, src_idx, bottom = pbt_exploit_explore(g, unit, scores, disc, PBTConfig(truncation_frac=0.25))
    order = np.argsort(-scores.numpy())
    top, low = set(order[:8].tolist()), set(order[-8:].tolist())
    for i in torch.nonzero(bottom).flatten().tolist():
        assert i in low
        assert int(src_idx[i]) in top


def test_explored_values_near_source():
    g, unit, scores, _ = _setup(n=64, d=2, seed=1)
    cfg = PBTConfig(truncation_frac=0.25, perturb_scale=0.05)
    new_unit, src_idx, bottom = pbt_exploit_explore(g, unit, scores, np.array([False, False]), cfg)
    diff = (new_unit - unit[src_idx]).abs()[bottom]
    assert float(diff.max()) < 0.25  # 5 sigma
    assert float(diff.max()) > 0


def test_bounds_respected():
    g, unit, scores, _ = _setup(n=128, d=4, seed=2)
    disc = np.array([False, True, False, True])
    new_unit, _, _ = pbt_exploit_explore(g, unit, scores, disc, PBTConfig(perturb_scale=0.5))
    assert float(new_unit.min()) >= 0.0 and float(new_unit.max()) <= 1.0


def test_deterministic_given_generator_seed():
    _, unit, scores, disc = _setup()
    a = pbt_exploit_explore(torch.Generator().manual_seed(7), unit, scores, disc)
    b = pbt_exploit_explore(torch.Generator().manual_seed(7), unit, scores, disc)
    for x, y in zip(a, b):
        assert torch.equal(x, y)

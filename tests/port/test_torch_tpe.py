"""The port's TPE acquisition (``mpi_opt_tpu_torch/ops/tpe.py``) against
the JAX package's ``ops/tpe.py``, called live and jitted (few XLA
compiles: every case shares one shape).

- ``_log_mixture``: rtol/atol 1e-5.
- The whole suggestion: JAX's own draws (its key split into the uniform
  candidates, the component picks and the jitter) fed to the port's
  ``tpe_apply``; the suggestions within 1e-5 and ``acq`` at rtol/atol
  1e-5 of JAX's ``tpe_suggest``, on an empty buffer, a partly valid one
  and one with NaN scores.
- ``pick_components`` is ``jax.random.choice``'s inverse CDF on the same
  uniforms; ``_diverse_top_k`` picks what JAX picks, planted ties
  included (the first maximum), and the plain top-k puts the lower
  index first on ties, as ``jax.lax.top_k`` does.
- Quality, port alone: the fused sweep's generational TPE loop on a
  quadratic beats random search at the same number of evaluations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_opt_tpu.ops import tpe as jtpe
from mpi_opt_tpu_torch.ops import tpe

M, D, C = 16, 3, 64
CFG = dict(n_candidates=C)


def _jcfg(**kw):
    return jtpe.TPEConfig(**{**CFG, **kw})


def _tcfg(**kw):
    return tpe.TPEConfig(**{**CFG, **kw})


def _buffer(case: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    unit = rng.uniform(size=(M, D)).astype(np.float32)
    scores = (-((unit - 0.7) ** 2).sum(1)).astype(np.float32)
    valid = np.zeros(M, bool)
    if case == "partial":
        valid[:11] = True
    elif case == "nan":
        valid[:13] = True
        scores[[2, 5]] = np.nan
    elif case != "empty":
        raise ValueError(case)
    if case == "empty":
        unit[:] = 0.0
        scores[:] = 0.0
    return unit, np.where(valid, scores, 0.0).astype(np.float32) if case != "nan" else scores, valid


@jax.jit
def _jax_draws(key, probs):
    """The draws ``jtpe.tpe_suggest`` makes from ``key``: its split into
    (uniform candidates, picks, jitter), the picks from ``probs``."""
    k_uni, k_pick, k_jitter = jax.random.split(key, 3)
    comp = jax.random.choice(k_pick, M + 1, (C,), p=probs)
    jitter = jax.random.normal(k_jitter, (C, D))
    uni = jax.random.uniform(k_uni, (C, D))
    return comp, jitter, uni


_jax_suggest = jax.jit(jtpe.tpe_suggest, static_argnames=("n_suggest", "cfg"))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_log_mixture_equals_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(C, D)).astype(np.float32)
    centers = rng.uniform(size=(M, D)).astype(np.float32)
    w = (rng.uniform(size=M) > 0.4).astype(np.float32)
    bw = rng.uniform(0.15, 1.0, size=D).astype(np.float32)
    want = np.asarray(jax.jit(jtpe._log_mixture, static_argnums=4)(x, centers, w, bw, 1.0))
    got = tpe._log_mixture(_t(x), _t(centers), _t(w), _t(bw), 1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_masked_moments_equal_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(M, D)).astype(np.float32)
    w = (rng.uniform(size=M) > 0.5).astype(np.float32)
    want = jax.jit(jtpe._masked_moments)(x, w)
    got = tpe._masked_moments(_t(x), _t(w))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_suggest,diversify_bw", [(4, 0.1), (1, 0.1), (4, 0.0)])
@pytest.mark.parametrize("case", ["empty", "partial", "nan"])
def test_suggest_with_jax_draws_equals_jax(case, n_suggest, diversify_bw):
    unit, scores, valid = _buffer(case)
    jcfg, tcfg = _jcfg(diversify_bw=diversify_bw), _tcfg(diversify_bw=diversify_bw)
    key = jax.random.key(3)
    want_s, want_a = _jax_suggest(key, unit, scores, valid, n_suggest=n_suggest, cfg=jcfg)
    model = tpe.tpe_fit(_t(unit), _t(scores), _t(valid), tcfg)
    comp, jitter, uni = _jax_draws(key, jnp.asarray(model.probs.numpy()))
    got_s, got_a = tpe.tpe_apply(_t(unit), model, _t(comp), _t(jitter), _t(uni), n_suggest, tcfg)
    assert got_s.shape == (n_suggest, D) and got_a.shape == (n_suggest,)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=1e-5)
    if case == "empty":  # l == g: a flat acquisition through the prior alone
        assert np.all(np.asarray(comp) == M)
        np.testing.assert_allclose(got_a.numpy(), 0.0, atol=1e-6)


def test_fit_equals_jax_internals():
    """The good/bad split and bandwidths, against the lines of JAX's
    ``tpe_suggest`` that compute them (NaN scores rank last)."""
    unit, scores, valid = _buffer("nan")
    cfg = _jcfg()

    @jax.jit
    def jfit(obs_unit, obs_scores, valid):
        from mpi_opt_tpu.ops.common import rank_descending

        n_good = jnp.maximum(1, jnp.ceil(cfg.gamma * valid.sum())).astype(jnp.int32)
        rank, _ = rank_descending(obs_scores, valid)
        good_w = ((rank < n_good) & valid).astype(jnp.float32)
        bad_w = ((rank >= n_good) & valid).astype(jnp.float32)

        def bw_of(w):
            m = jnp.maximum(w.sum(), 1.0)
            _, std = jtpe._masked_moments(obs_unit, w)
            return jnp.clip(cfg.bw_scale * std * m ** (-1.0 / (D + 4)), cfg.bw_floor, 1.0)

        return good_w, bad_w, bw_of(good_w), bw_of(bad_w)

    want = jfit(unit, scores, valid)
    got = tpe.tpe_fit(_t(unit), _t(scores), _t(valid), _tcfg())
    np.testing.assert_array_equal(got.good_w.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got.bad_w.numpy(), np.asarray(want[1]))
    assert got.good_w[[2, 5]].sum() == 0  # NaN scores are never good
    for g, w in zip((got.bw_g, got.bw_b), want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert torch.isclose(got.probs.sum(), torch.tensor(1.0))


def test_pick_components_is_jax_choice():
    probs = np.asarray([0.0, 0.25, 0.0, 0.25, 0.125, 0.375], np.float32)
    key = jax.random.key(5)
    u = jax.random.uniform(key, (C,))
    want = jax.jit(lambda k, p: jax.random.choice(k, 6, (C,), p=p))(key, probs)
    got = tpe.pick_components(_t(u), _t(probs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(got.tolist()) <= {1, 3, 4, 5}  # zero-weight components are never picked


def _grid_cand():
    """Candidates on a 1/8 grid (every distance exact in f32) with
    planted acquisition ties."""
    g = np.stack(np.meshgrid(np.arange(4) / 8, np.arange(4) / 8, indexing="ij"), -1).reshape(-1, 2)
    cand = np.concatenate([g, g[::-1]]).astype(np.float32)  # every point twice
    acq = np.zeros(len(cand), np.float32)
    acq[[3, 7, 19, 28]] = 2.0  # four-way tie at the top
    acq[[5, 21]] = 1.0
    return cand, acq


@pytest.mark.parametrize("k,bw,weight", [(6, 0.1, 5.0), (16, 0.3, 1.0), (12, 0.2, 2.0), (16, 0.05, 5.0)])
def test_diverse_top_k_picks_equal_jax(k, bw, weight):
    """Picks equal while the running acquisition stays separated (past
    ~16 picks on 32 candidates, accumulated penalties leave values one
    ulp apart, where XLA's and torch's ``exp`` may order them
    differently)."""
    cand, acq = _grid_cand()
    want = jax.jit(jtpe._diverse_top_k, static_argnums=(2, 3, 4))(cand, acq, k, bw, weight)
    got = tpe._diverse_top_k(_t(cand), _t(acq), k, bw, weight)
    assert got.tolist() == np.asarray(want).tolist()
    assert got[0] == 3  # the first of the tied maxima


def test_plain_top_k_puts_the_lower_index_first_on_ties():
    """``n_suggest=1`` / ``diversify_bw=0`` take the plain top-k:
    ``jax.lax.top_k`` puts the lower index first on ties."""
    _, acq = _grid_cand()
    _, want = jax.lax.top_k(jnp.asarray(acq), 8)
    order = torch.sort(_t(acq), descending=True, stable=True).indices[:8]
    assert order.tolist() == np.asarray(want).tolist() == [3, 7, 19, 28, 5, 21, 0, 1]


def test_draws_come_from_the_generator():
    cfg = _tcfg()
    a = tpe.draw_tpe(torch.Generator().manual_seed(0), M, D, cfg)
    b = tpe.draw_tpe(torch.Generator().manual_seed(0), M, D, cfg)
    c = tpe.draw_tpe(torch.Generator().manual_seed(1), M, D, cfg)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.jitter, c.jitter)
    assert a.u_pick.shape == (C,) and a.jitter.shape == a.uni.shape == (C, D)


def _quadratic(x):
    return -((x - 0.8) ** 2).sum(-1)


def test_batched_tpe_beats_random_search():
    """The fused sweep's loop on a quadratic in the 4-d cube: 8 uniform
    points, then 7 generations of 8 diversified suggestions (64
    evaluations), against 64 uniform draws, over 8 seeds. TPE's best
    regret is under half of random search's on average and better in
    at least 6 seeds of 8."""
    d, n, batch = 4, 64, 8
    cfg = tpe.TPEConfig(n_candidates=256)
    tpe_regret, rand_regret = [], []
    for seed in range(8):
        gen = torch.Generator().manual_seed(seed)
        unit = torch.zeros(n, d)
        scores = torch.zeros(n)
        valid = torch.zeros(n, dtype=torch.bool)
        for i in range(0, n, batch):
            unit[i:i + batch] = (torch.rand((batch, d), generator=gen) if i == 0 else
                                 tpe.tpe_suggest(gen, unit, scores, valid, batch, cfg)[0])
            scores[i:i + batch] = _quadratic(unit[i:i + batch])
            valid[i:i + batch] = True
        rand = torch.rand((n, d), generator=torch.Generator().manual_seed(100 + seed))
        tpe_regret.append(-float(scores.max()))
        rand_regret.append(-float(_quadratic(rand).max()))
    assert np.mean(tpe_regret) < 0.5 * np.mean(rand_regret)
    assert sum(t < r for t, r in zip(tpe_regret, rand_regret)) >= 6

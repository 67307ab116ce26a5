"""The port's successive halving against the JAX package's: the rung
ladder, the cohort sizes and the rung cut bit-equal to the JAX functions
called live (the cut on planted ties and NaNs), and a whole fused SHA
sweep's rung sizes, budgets and ledger record structure against JAX
``fused_sha`` on the same small workload; the JAX ledger reader takes
the port's SHA ledger. Scores differ between the packages (their random
streams differ), so the sweep comparison is structural."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_opt_tpu.ledger.store as jstore
from mpi_opt_tpu.ops.asha import asha_cut as jax_asha_cut
from mpi_opt_tpu.ops.asha import asha_rungs as jax_asha_rungs
from mpi_opt_tpu.train.fused_asha import fused_sha as jax_fused_sha
from mpi_opt_tpu.train.fused_asha import sha_cohort_sizes as jax_sha_cohort_sizes
from mpi_opt_tpu.workloads import get_workload as jax_get_workload
from mpi_opt_tpu_torch import get_workload
from mpi_opt_tpu_torch.ledger import SweepLedger
from mpi_opt_tpu_torch.ops.asha import asha_cut, asha_rungs
from mpi_opt_tpu_torch.train.fused_asha import fused_sha, sha_cohort_sizes

LADDERS = [(10, 270, 3), (1, 81, 3), (2, 8, 2), (5, 5, 3), (3, 100, 4), (1, 2, 2), (7, 50, 2)]


@pytest.mark.parametrize("lo,hi,eta", LADDERS)
def test_asha_rungs_equal_jax(lo, hi, eta):
    assert asha_rungs(lo, hi, eta) == jax_asha_rungs(lo, hi, eta)


@pytest.mark.parametrize("lo,hi,eta", [(0, 10, 3), (10, 5, 3), (1, 10, 1)])
def test_asha_rungs_refuse_what_jax_refuses(lo, hi, eta):
    with pytest.raises(ValueError):
        jax_asha_rungs(lo, hi, eta)
    with pytest.raises(ValueError, match="eta>=2"):
        asha_rungs(lo, hi, eta)


@pytest.mark.parametrize("n,rungs,eta,round_to", [
    (64, 4, 3, 1), (81, 5, 3, 1), (8, 3, 2, 1), (10, 4, 3, 4), (1, 3, 3, 1), (100, 3, 4, 8),
])
def test_sha_cohort_sizes_equal_jax(n, rungs, eta, round_to):
    assert sha_cohort_sizes(n, rungs, eta, round_to) == jax_sha_cohort_sizes(n, rungs, eta, round_to)


def test_the_bench_config_2_ladder():
    """BENCH_ALL.json config 2: 64 trials, budgets 10 -> 270, eta 3."""
    assert asha_rungs(10, 270, 3) == [10, 30, 90, 270]
    assert sha_cohort_sizes(64, 4, 3) == [64, 22, 8, 3]


def _planted(n, seed):
    """Scores on a 1/16 grid (ties everywhere), with NaNs planted."""
    rng = np.random.default_rng(seed)
    s = (rng.integers(0, 8, n) / 16).astype(np.float32)
    s[rng.choice(n, size=max(1, n // 5), replace=False)] = np.nan
    return s


@pytest.mark.parametrize("n", [1, 2, 7, 16, 33])
@pytest.mark.parametrize("eta", [2, 3, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_asha_cut_equals_jax_on_ties_and_nans(n, eta, masked):
    scores = _planted(n, n * 10 + eta)
    valid = None
    if masked:
        valid = np.random.default_rng(n + eta).random(n) < 0.7
    j_promote, j_order = jax_asha_cut(jnp.asarray(scores), eta,
                                      None if valid is None else jnp.asarray(valid))
    t_promote, t_order = asha_cut(torch.from_numpy(scores), eta,
                                  None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(t_promote.numpy(), np.asarray(j_promote))
    np.testing.assert_array_equal(t_order.numpy(), np.asarray(j_order))


def test_asha_cut_all_nan_and_all_tied():
    for scores in (np.full(6, np.nan, np.float32), np.full(6, 0.5, np.float32)):
        j = jax_asha_cut(jnp.asarray(scores), 3)
        t = asha_cut(torch.from_numpy(scores), 3)
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
        assert int(t[0].sum()) == 2


def _header(space, seed):
    return {"mode": "fused", "granularity": "rung", "algorithm": "asha", "seed": seed,
            "space_hash": space.space_hash()}


def test_fused_sha_structure_matches_jax(tmp_path):
    """Same workload and arguments through both packages: rung sizes and
    budgets equal; every ledger record has the JAX record's keys, and the
    boundary, boundary size, trial id and step sequences are equal; the
    JAX ledger reader validates the port's ledger."""
    kw = dict(n_trials=8, min_budget=2, max_budget=8, eta=2, seed=3)
    jwl = jax_get_workload("fashion_mlp", n_train=256, n_val=128)
    jled = jstore.SweepLedger(str(tmp_path / "jax.jsonl"))
    jled.ensure_header(_header(jwl.default_space(), kw["seed"]))
    try:
        want = jax_fused_sha(jwl, ledger=jled, **kw)
    finally:
        jled.close()
    twl = get_workload("fashion_mlp", n_train=256, n_val=128)
    tled = SweepLedger(str(tmp_path / "port.jsonl"))
    tled.ensure_header(_header(twl.default_space(), kw["seed"]))
    try:
        got = fused_sha(twl, ledger=tled, device="cpu", wave_size=3, **kw)
    finally:
        tled.close()
    assert got["rung_sizes"] == want["rung_sizes"] == [8, 4, 2]
    assert got["rung_budgets"] == want["rung_budgets"] == [2, 4, 8]
    assert set(got) - {"wave_size", "wave_lens", "n_waves", "waves_run", "oom_backoffs",
                       "staged_bytes", "stage_transfer_s", "stage_wait_s",
                       "stage_overlap_s", "launch_width", "launch_width_before", "launch_width_after",
                       "launch_shape_changed"} == set(want)
    assert [len(h["trials"]) for h in got["rung_history"]] == [8, 4, 2]
    assert [h["budget"] for h in got["rung_history"]] == [h["budget"] for h in want["rung_history"]]
    assert got["journal"] == want["journal"] == {"written": 14, "verified": 0}

    def recs(path):
        with open(path) as f:
            return [json.loads(x) for x in f.read().splitlines()[1:]]

    j_recs, t_recs = recs(tmp_path / "jax.jsonl"), recs(tmp_path / "port.jsonl")
    assert [set(r) for r in t_recs] == [set(r) for r in j_recs]
    shape = lambda rs: [(r["boundary"], r["boundary_size"], r["trial_id"], r["step"]) for r in rs]
    assert shape(t_recs) == shape(j_recs)
    assert jstore.validate_ledger(str(tmp_path / "port.jsonl")) == []
    back = jstore.SweepLedger(str(tmp_path / "port.jsonl"), read_only=True)
    try:
        assert len(back.records) == 14
    finally:
        back.close()

"""Warm start in the port against the JAX package's, and the fused SHA
snapshot's boundary count.

The same ledger files go through both packages:

- ``observations_from_records``, ``load_observations`` and
  ``best_observation`` give equal observations and equal skips, planted
  exotic-Choice, failed, NaN-score and NaN-vector records included (a
  LogUniform coordinate may sit one float32 ulp from JAX's: the two
  packages compute its log in different libraries; every other
  coordinate is bit-equal). Both refuse a ledger of another space.
- Row 0 of the initial unit matrix of fused PBT (resident and waves),
  fused SHA and every bracket of fused Hyperband is the prior best, and
  the other rows are the draws, when the port is handed JAX's draws.
- Fused TPE's warm ring (``obs_unit``, ``obs_scores``, ``valid`` as the
  first generation sees them) equals the one the JAX ``fused_tpe``
  builds; both sweeps are stopped there, so the JAX side compiles
  nothing. The port's returned history holds only its own trials, a
  prior the sweep cannot reach is barred from the best pick and the
  curve, and a resume under another prior set refuses.
- Fused BOHB's ``ObsStore`` after the warm ingest equals JAX's through
  its JSON state, and neither passes the priors on to its brackets.
- A fused Hyperband's snapshots record the GLOBAL boundary count the
  JAX package records (bracket 1 included), so the fused replay
  cross-check flags a journal cut back to bracket 0's boundaries.
"""

import json
import math
import os

import jax  # noqa: F401  (pinned to the CPU by tests/conftest.py)
import numpy as np
import pytest
import torch

import mpi_opt_tpu.ledger.report as jreport
import mpi_opt_tpu.ledger.warmstart as jws
import mpi_opt_tpu.space as jspace
import mpi_opt_tpu.train.fused_bohb as jfb
import mpi_opt_tpu.train.fused_tpe as jft
from mpi_opt_tpu.ledger.store import LedgerError as JaxLedgerError
from mpi_opt_tpu.train.fused_asha import fused_hyperband as jax_fused_hyperband
from mpi_opt_tpu.utils import checkpoint as jck
from mpi_opt_tpu.workloads import get_workload as jax_get_workload
import mpi_opt_tpu_torch.ledger.report as treport
import mpi_opt_tpu_torch.ledger.warmstart as tws
import mpi_opt_tpu_torch.space as tspace
import mpi_opt_tpu_torch.train.fused_asha as tfa
import mpi_opt_tpu_torch.train.fused_bohb as tfb
import mpi_opt_tpu_torch.train.fused_pbt as tfp
import mpi_opt_tpu_torch.train.fused_tpe as tft
from mpi_opt_tpu_torch import get_workload
from mpi_opt_tpu_torch.ledger import LedgerError, SweepLedger
from mpi_opt_tpu_torch.utils import integrity


def _exotic_space(mod):
    return mod.SearchSpace({
        "lr": mod.LogUniform(1e-4, 1.0),
        "m": mod.Uniform(0.0, 0.99),
        "k": mod.IntUniform(1, 8),
        "act": mod.Choice([None, "relu", 3, 2.5, True, (1, 2)]),
    })


def _record(i, params, status="ok", score=0.5, step=1, **extra):
    return {"kind": "trial", "trial_id": i, "params": params, "status": status, "score": score,
            "step": step, "error": None, "attempts": 1, "wall_s": 0.0, "cached": False,
            "ts": 1000.0 + i, **extra}


def _write_ledger(path, space, records):
    """A ledger file of ``records`` (NaN written as JSON's NaN literal,
    which both packages' readers parse) under a header for ``space``."""
    header = {"kind": "header", "version": 1, "sweep_id": "prior",
              "config": {"space_hash": space.space_hash()}, "created_ts": 999.0}
    with open(path, "w") as f:
        for rec in [header, *records]:
            f.write(json.dumps(rec) + "\n")
    return str(path)


def _planted_records(space, n_ok, seed, budgets=(1, 2, 3), top=None):
    """``n_ok`` ok records at uniform points of ``space`` with scores in
    [0.1, 0.6], then a failed record, a NaN-score record and a record
    whose objective vector holds a NaN (its scalar score 0.95, the
    highest: a prior best that must never seed). ``top`` adds one more
    ok record at that score."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n_ok):
        u = rng.uniform(size=space.dim).astype(np.float32)
        params = space.canonical_params(space.materialize_row(u))
        recs.append(_record(i, params, score=float(rng.uniform(0.1, 0.6)),
                            step=budgets[i % len(budgets)]))
    u = rng.uniform(size=(4, space.dim)).astype(np.float32)
    p = [space.canonical_params(space.materialize_row(r)) for r in u]
    recs.append(_record(n_ok, p[0], status="failed", score=None))
    recs.append(_record(n_ok + 1, p[1], score=math.nan))
    recs.append(_record(n_ok + 2, p[2], score=0.95, scores=[0.95, math.nan]))
    if top is not None:
        recs.append(_record(n_ok + 3, p[3], score=top, step=budgets[0]))
    return recs


def _log_dims(space):
    return np.array([type(d).__name__ == "LogUniform" for d in space.domains.values()])


def _assert_unit_rows(port, ref, space):
    """Bit-equal, except one float32 ulp on a LogUniform coordinate."""
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    ulps = np.abs(port.view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64))
    log = np.broadcast_to(_log_dims(space), port.shape)
    assert (ulps[~log] == 0).all(), (port, ref)
    assert (ulps[log] <= 1).all(), (port, ref)


def _assert_observations(port_obs, jax_obs, space):
    assert len(port_obs) == len(jax_obs)
    for p, j in zip(port_obs, jax_obs):
        _assert_unit_rows(p.unit, j.unit, space)
        assert (p.budget, math.isnan(p.score)) == (j.budget, math.isnan(j.score))
        assert math.isnan(p.score) or p.score == j.score
        assert (p.scores is None) == (j.scores is None)
        if p.scores is not None:
            np.testing.assert_array_equal(np.asarray(p.scores, float), np.asarray(j.scores, float))


@pytest.fixture(scope="module")
def exotic_prior(tmp_path_factory):
    space = _exotic_space(tspace)
    recs = _planted_records(space, 9, seed=1)
    bad = dict(recs[0]["params"], act="(3, 4)")  # no live option canonicalises to it
    recs.append(_record(20, bad, score=0.4))
    return _write_ledger(tmp_path_factory.mktemp("exotic") / "prior.jsonl", space, recs)


def _fashion():
    return get_workload("fashion_mlp", n_train=256, n_val=128)


@pytest.fixture(scope="module")
def fashion_prior(tmp_path_factory):
    space = _fashion().default_space()
    recs = _planted_records(space, 7, seed=2, budgets=(1, 2, 4))
    return _write_ledger(tmp_path_factory.mktemp("fashion") / "prior.jsonl", space, recs)


@pytest.fixture(scope="module")
def tabular_prior(tmp_path_factory):
    space = get_workload("tabular_mlp").default_space()
    # a prior at score 10: above any accuracy, so a sweep that let its
    # warm rows win would show it
    recs = _planted_records(space, 5, seed=3, top=10.0)
    return _write_ledger(tmp_path_factory.mktemp("tabular") / "prior.jsonl", space, recs)


def _both_observations(path, t_space, j_space):
    return tws.load_observations(path, t_space), jws.load_observations(path, j_space)


@pytest.mark.parametrize("reader", ["records", "path"])
def test_observations_and_skips_equal_jax(exotic_prior, reader):
    t_space, j_space = _exotic_space(tspace), _exotic_space(jspace)
    if reader == "records":
        with open(exotic_prior) as f:
            recs = [json.loads(x) for x in f.read().splitlines()[1:]]
        (t_obs, t_skips), (j_obs, j_skips) = (tws.observations_from_records(recs, t_space),
                                              jws.observations_from_records(recs, j_space))
    else:
        (t_obs, t_skips), (j_obs, j_skips) = _both_observations(exotic_prior, t_space, j_space)
    assert t_skips == j_skips == {"not_ok": 1, "bad_choice": 1}
    _assert_observations(t_obs, j_obs, t_space)
    # the exotic option (a tuple, journaled as its repr) decodes to itself
    assert {tuple(o.unit.shape) for o in t_obs} == {(4,)}
    t_best, j_best = tws.best_observation(t_obs), jws.best_observation(j_obs)
    assert t_best.score == j_best.score < 0.95  # the NaN-vector record never seeds
    _assert_unit_rows(t_best.unit, j_best.unit, t_space)
    assert [tws.observation_fully_finite(o) for o in t_obs] == [
        jws.observation_fully_finite(o) for o in j_obs]


def test_both_refuse_a_ledger_of_another_space(exotic_prior):
    with pytest.raises(LedgerError, match="space hash"):
        tws.load_observations(exotic_prior, _fashion().default_space())
    with pytest.raises(JaxLedgerError, match="space hash"):
        jws.load_observations(exotic_prior, jax_get_workload("fashion_mlp").default_space())


def _jax_draws(n, d):
    return np.array(jax.random.uniform(jax.random.key(n), (n, d), dtype=jax.numpy.float32))


_ROW0_SWEEPS = {
    "pbt": lambda wl, obs: tfp.fused_pbt(wl, population=4, generations=1, steps_per_gen=1,
                                         warm_obs=obs, device="cpu"),
    "pbt_waves": lambda wl, obs: tfp.fused_pbt(wl, population=4, generations=1, steps_per_gen=1,
                                               wave_size=2, warm_obs=obs, device="cpu"),
    "sha": lambda wl, obs: tfa.fused_sha(wl, n_trials=4, min_budget=1, max_budget=3, eta=3,
                                         warm_obs=obs, device="cpu"),
    "hyperband": lambda wl, obs: tfa.fused_hyperband(wl, max_budget=2, eta=2, warm_obs=obs,
                                                     device="cpu"),
}


@pytest.mark.parametrize("sweep", list(_ROW0_SWEEPS))
def test_row0_is_the_prior_best_given_jax_draws(fashion_prior, sweep, monkeypatch):
    wl = _fashion()
    t_space, j_space = wl.default_space(), jax_get_workload("fashion_mlp").default_space()
    (t_obs, _), (j_obs, _) = _both_observations(fashion_prior, t_space, j_space)
    j_best = jws.best_observation(j_obs)
    monkeypatch.setattr(tspace.SearchSpace, "sample_unit",
                        lambda self, gen, n: torch.from_numpy(_jax_draws(n, self.dim)).to(gen.device))
    seeded = []
    real = tfp.seed_warm_row

    def spy(unit, warm_obs):
        out = real(unit, warm_obs)
        seeded.append(out.cpu().numpy().copy())
        return out

    monkeypatch.setattr(tfp, "seed_warm_row", spy)
    monkeypatch.setattr(tfa, "seed_warm_row", spy)
    _ROW0_SWEEPS[sweep](wl, t_obs)
    assert len(seeded) == (2 if sweep == "hyperband" else 1)  # one cohort a bracket
    for unit in seeded:
        want = _jax_draws(len(unit), t_space.dim)
        want[0] = j_best.unit  # what the JAX sweeps do to their draws
        np.testing.assert_array_equal(unit[1:], want[1:])
        _assert_unit_rows(unit[:1], want[:1], t_space)


class _Stop(Exception):
    """Raised by a spy to end a sweep once it has what the test reads."""


def _tpe_ring(side, wl, obs, monkeypatch):
    """The ring as the first generation's acquisition reads it."""
    mod = tft if side == "port" else jft
    seen = {}

    def spy(trainer, obs_unit, obs_scores, valid, *args, **kwargs):
        seen["ring"] = [np.array(x.cpu() if isinstance(x, torch.Tensor) else x)
                        for x in (obs_unit, obs_scores, valid)]
        raise _Stop

    monkeypatch.setattr(mod, "tpe_generation", spy)
    kw = dict(n_trials=8, batch=4, budget=2, seed=0, warm_obs=obs)
    with pytest.raises(_Stop):
        mod.fused_tpe(wl, **kw, **({"device": "cpu"} if side == "port" else {}))
    return seen["ring"]


def test_tpe_warm_ring_equals_jax(tabular_prior, monkeypatch):
    wl, jwl = get_workload("tabular_mlp"), jax_get_workload("tabular_mlp")
    (t_obs, _), (j_obs, _) = _both_observations(tabular_prior, wl.default_space(),
                                                jwl.default_space())
    t_unit, t_scores, t_valid = _tpe_ring("port", wl, t_obs, monkeypatch)
    j_unit, j_scores, j_valid = _tpe_ring("jax", jwl, j_obs, monkeypatch)
    n_warm = sum(np.isfinite(o.score) for o in j_obs)
    assert n_warm == 7 and t_unit.shape == j_unit.shape == (8 + n_warm, 3)
    _assert_unit_rows(t_unit, j_unit, wl.default_space())
    np.testing.assert_array_equal(t_scores, j_scores)
    np.testing.assert_array_equal(t_valid, j_valid)
    assert t_valid[:n_warm].all() and not t_valid[n_warm:].any()


def _fused_ledger(path, space, algorithm, granularity):
    led = SweepLedger(str(path), read_only=False)
    led.ensure_header({"mode": "fused", "granularity": granularity, "algorithm": algorithm,
                       "seed": 0, "space_hash": space.space_hash()})
    return led


def test_tpe_warm_rows_are_facts_not_trials(tabular_prior, tmp_path):
    wl = get_workload("tabular_mlp")
    obs, _ = tws.load_observations(tabular_prior, wl.default_space())
    led = _fused_ledger(tmp_path / "l.jsonl", wl.default_space(), "tpe", "batch")
    kw = dict(n_trials=8, batch=4, budget=2, seed=0, device="cpu")
    res = tft.fused_tpe(wl, warm_obs=obs, ledger=led, checkpoint_dir=str(tmp_path / "ck"), **kw)
    led.close()
    assert res["n_warm"] == 7 and res["n_trials"] == 8
    assert res["obs_unit"].shape == (8, 3) and res["obs_scores"].shape == (8,)
    # the prior at 10 is in the ring but never the winner or on the curve
    assert res["best_score"] < 10 and (res["best_curve"] < 10).all()
    with open(tmp_path / "l.jsonl") as f:
        recs = [json.loads(x) for x in f.read().splitlines()[1:]]
    assert [r["member"] for r in recs] == list(range(8))
    np.testing.assert_array_equal(np.asarray([r["score"] for r in recs], np.float32),
                                  res["obs_scores"])
    # the warm prefix is the snapshot's identity: another prior set refuses
    with pytest.raises(ValueError, match="n_warm"):
        tft.fused_tpe(wl, warm_obs=obs[:3], checkpoint_dir=str(tmp_path / "ck"), **kw)


def test_bohb_obs_store_after_warm_ingest_equals_jax(fashion_prior, monkeypatch):
    wl, jwl = _fashion(), jax_get_workload("fashion_mlp", n_train=256, n_val=128)
    (t_obs, _), (j_obs, _) = _both_observations(fashion_prior, wl.default_space(),
                                                jwl.default_space())
    got = {}
    for side, mod in (("port", tfb), ("jax", jfb)):

        class Recording(mod.ObsStore):
            def __init__(self, *args, _side=side, **kwargs):
                super().__init__(*args, **kwargs)
                got[_side] = self

        def brackets(*args, _side=side, **kwargs):
            got[f"{_side} passes on"] = kwargs["warm_obs"]
            return {}

        monkeypatch.setattr(mod, "ObsStore", Recording)
        monkeypatch.setattr(mod, "fused_hyperband", brackets)
    tfb.fused_bohb(wl, max_budget=4, eta=2, warm_obs=t_obs, device="cpu")
    jfb.fused_bohb(jwl, max_budget=4, eta=2, warm_obs=j_obs)
    assert got["port passes on"] is None and got["jax passes on"] is None
    t_state, j_state = got["port"].to_jsonable(), got["jax"].to_jsonable()
    assert sorted(t_state) == sorted(j_state) == ["1", "2", "4"]
    for b in j_state:
        t, j = t_state[b], j_state[b]
        assert (t["score"], t["valid"], t["n"]) == (j["score"], j["valid"], j["n"])
        _assert_unit_rows(t["unit"], j["unit"], wl.default_space())
    assert got["port"].model_budget() == got["jax"].model_budget()


def test_hyperband_snapshots_count_global_boundaries_as_jax(tmp_path, monkeypatch):
    jax_saved = []

    def record(self, step, state, unit, key, scores, meta_extra):
        jax_saved.append((os.path.basename(self.directory), step, meta_extra["boundaries_done"]))

    monkeypatch.setattr(jck.SweepCheckpointer, "save_population_sweep", record)
    jax_fused_hyperband(jax_get_workload("fashion_mlp", n_train=256, n_val=128), max_budget=2,
                        eta=2, seed=0, checkpoint_dir=str(tmp_path / "jax"))
    wl = _fashion()
    led = _fused_ledger(tmp_path / "l.jsonl", wl.default_space(), "hyperband", "rung")
    tfa.fused_hyperband(wl, max_budget=2, eta=2, seed=0, checkpoint_dir=str(tmp_path / "ck"),
                        ledger=led, device="cpu")
    led.close()
    port_saved = []
    for root in integrity.find_checkpoint_roots(str(tmp_path / "ck")):
        for step in integrity._committed_steps(root):
            meta = integrity.load_sweep_meta(root, step)
            port_saved.append((os.path.basename(root), step, meta["boundaries_done"]))
    # bracket 0 journals boundaries 0 and 1, bracket 1 boundary 2
    assert port_saved == jax_saved == [("bracket_0", 1, 1), ("bracket_0", 2, 2),
                                       ("bracket_1", 1, 3)]
    newest = max(done for _, _, done in port_saved)
    with open(tmp_path / "l.jsonl") as f:
        lines = f.read().splitlines()
    cut = tmp_path / "cut.jsonl"
    cut.write_text("\n".join([lines[0]] + [x for x in lines[1:]
                                           if json.loads(x)["boundary"] < 2]) + "\n")
    for path, lags in ((tmp_path / "l.jsonl", False), (cut, True)):
        got = treport.fused_replay_consistency(str(path), newest)
        assert got == jreport.fused_replay_consistency(str(path), newest)
        assert bool(got) == lags
    # the count bracket 1 recorded before (its local rung count, 1) let
    # the cut journal pass
    assert treport.fused_replay_consistency(str(cut), 1) == []

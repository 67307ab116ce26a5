"""The port's search driver (``mpi_opt_tpu_torch/driver.py``), its cache
and snapshots, and the CLI's driver path, on the CPU.

- ``run_search`` against the JAX package's ``run_search`` on one
  scripted backend, each over its own package's algorithms (the port's
  fed JAX's draws): the same evaluations, retry rounds, backoff sleeps,
  counters, breaker trip, journal and resume, for every algorithm; and
  the resumed ASHA on which the two differ on purpose (the JAX driver
  keys its replay by trial id alone).
- ``run_search`` on a scripted backend, as ``tests/test_failure_policy.py``
  and ``tests/test_ledger.py`` run the JAX driver: retries with their
  counts, exhausted retries, timeouts counted apart, the breaker (and
  its minimum), each algorithm's handling of failed reports; a killed
  run's ledger replays to the unkilled run's trials without
  re-evaluating them; replay divergence refused; the cache serves only
  ok results, at their budget, and journals its hits.
- ``SearchCheckpointer``: algorithm, backend map and pool round trip.
- The CLI without ``--fused`` (``python -m mpi_opt_tpu_torch --device
  cpu``): every algorithm runs; the ledger it writes is read by the JAX
  package's ``SweepLedger`` with the same identity (space hash,
  capacity, seed); SIGTERM mid-sweep exits 75 and ``--resume`` exits 0
  with the unkilled run's records; the breaker exits 1; the refusals
  exit 2.
Exact equality throughout: every comparison is of decisions or of bits,
except the parity section's scores (rel 1e-4, as stated there).
"""

import json
import math
import os
import signal
import time

import numpy as np
import pytest
import torch

import mpi_opt_tpu.driver as jdriver
import mpi_opt_tpu.ledger as jledger
import mpi_opt_tpu.trial as jtrial
import mpi_opt_tpu_torch.cli as cli
import mpi_opt_tpu_torch.driver as tdriver
import mpi_opt_tpu_torch.trial as ttrial
import torch_port_jax_draws as jd
from mpi_opt_tpu.utils.metrics import MetricsLogger as JMetrics
from mpi_opt_tpu_torch.algorithms import ALGORITHMS, ASHA, BOHB, PBT, TPE, Hyperband, RandomSearch
from mpi_opt_tpu_torch.backends.base import Backend
from mpi_opt_tpu_torch.driver import FailurePolicy, SweepAborted, run_search
from mpi_opt_tpu_torch.ledger import EvalCache, LedgerError, SweepLedger, read_ledger
from mpi_opt_tpu_torch.space import SearchSpace, Uniform
from mpi_opt_tpu_torch.trial import TrialResult, TrialStatus, failed_result
from mpi_opt_tpu_torch.utils.metrics import MetricsLogger, null_logger

SPACE = SearchSpace({"lr": Uniform(0.0, 1.0), "reg": Uniform(0.0, 1.0)})


class ScriptedBackend(Backend):
    """Scores are a pure function of the unit row and the budget;
    ``fail[trial_id] = n`` fails the first n attempts ('always': every
    attempt)."""

    name = "scripted"

    def __init__(self, capacity=4, fail=None, status="failed"):
        super().__init__(None)
        self._capacity = capacity
        self.fail = fail or {}
        self.status = status
        self.attempts = {}
        self.evaluated = []
        self.evaluated_at = []

    @property
    def capacity(self):
        return self._capacity

    def evaluate(self, trials):
        out = []
        for t in trials:
            n = self.attempts[t.trial_id] = self.attempts.get(t.trial_id, 0) + 1
            self.evaluated.append(t.trial_id)
            budget = self.fail.get(t.trial_id, 0)
            if budget == "always" or n <= budget:
                out.append(failed_result(t.trial_id, t.budget, "scripted", status=self.status))
            else:
                score = -float(np.sum((t.unit - 0.6) ** 2)) + 0.01 * t.budget
                out.append(TrialResult(t.trial_id, score, t.budget))
                self.evaluated_at.append((t.trial_id, t.budget))
        return out


def _random(n=8, seed=0):
    return RandomSearch(SPACE, seed=seed, max_trials=n, budget=5)


# -- failure policy (tests/test_failure_policy.py) ------------------------


def test_retry_recovers_transient_failure():
    algo, b, m = _random(), ScriptedBackend(fail={2: 2, 5: 1}), null_logger()
    res = run_search(algo, b, metrics=m, policy=FailurePolicy(max_retries=2, backoff_s=0.0))
    assert all(t.status == TrialStatus.DONE for t in algo.trials.values())
    assert res.n_failed == 0 and res.n_retried == 3 and m.trials_retried == 3
    assert b.attempts[2] == 3 and b.attempts[5] == 2


def test_retries_exhausted_reports_failed():
    algo, b, m = _random(6), ScriptedBackend(3, fail={1: "always"}), null_logger()
    res = run_search(algo, b, metrics=m, policy=FailurePolicy(max_retries=2, backoff_s=0.0))
    assert algo.trials[1].status == TrialStatus.FAILED and algo.trials[1].error == "scripted"
    assert b.attempts[1] == 3 and res.n_failed == 1 and res.n_retried == 2
    assert m.trials_failed == 1 and algo.best().trial_id != 1


def test_timeout_status_counted_separately():
    m = null_logger()
    res = run_search(_random(4), ScriptedBackend(fail={0: "always"}, status="timeout"), metrics=m)
    assert res.n_timeout == 1 and res.n_failed == 0
    assert m.trials_timeout == 1 and m.trials_failed == 0 and m.stalls_detected == 1


def test_backoff_is_jittered_exponential(monkeypatch):
    import random

    pol = FailurePolicy(backoff_s=0.5, backoff_jitter=0.5)
    rng = random.Random(0)
    for attempt in (1, 2, 3):
        d = pol.backoff(attempt, rng)
        assert 0.5 * 2 ** (attempt - 1) <= d <= 0.75 * 2 ** (attempt - 1)
    slept = []
    monkeypatch.setattr(tdriver.time, "sleep", slept.append)
    run_search(_random(4), ScriptedBackend(fail={0: 2}), policy=FailurePolicy(max_retries=2))
    assert len(slept) == 2 and slept[1] > slept[0] > 0


def test_policy_validation():
    with pytest.raises(ValueError, match="max_retries"):
        FailurePolicy(max_retries=-1)
    with pytest.raises(ValueError, match="max_failure_rate"):
        FailurePolicy(max_failure_rate=0.0)


def test_abort_on_systemic_failure_counts_the_batch():
    b, m = ScriptedBackend(8, fail={i: "always" for i in range(64)}), MetricsLogger()
    with pytest.raises(SweepAborted, match="max_failure_rate"):
        run_search(_random(64), b, metrics=m,
                   policy=FailurePolicy(max_failure_rate=0.5, min_evals_for_abort=16))
    assert len(b.attempts) < 64
    assert m.trials_done == 16 and m.trials_failed == 16


def test_abort_waits_for_min_evals_and_default_never_aborts():
    res = run_search(_random(4), ScriptedBackend(2, fail={0: "always", 1: "always"}),
                     policy=FailurePolicy(max_failure_rate=0.5, min_evals_for_abort=20))
    assert res.n_failed == 2
    algo = _random(24)
    res = run_search(algo, ScriptedBackend(8, fail={i: "always" for i in range(24)}))
    assert res.n_failed == 24 and algo.best() is None


def test_algorithms_survive_failed_reports():
    asha = ASHA(SPACE, seed=1, max_trials=9, min_budget=3, max_budget=27, eta=3)
    run_search(asha, ScriptedBackend(3, fail={0: "always", 4: "always"}))
    for tid in (0, 4):
        assert asha.trials[tid].status == TrialStatus.FAILED and tid not in asha.rung_scores[0]
    pbt = PBT(SPACE, seed=2, population=8, generations=3, steps_per_generation=5)
    run_search(pbt, ScriptedBackend(8, fail={0: "always", 3: "always"}))
    by_slot = {t.params["__slot__"]: t for t in pbt.trials.values() if 8 <= t.trial_id < 16}
    for slot in (0, 3):
        assert by_slot[slot].params["__inherit_from__"] not in (None, 0, 3)
    tpe = TPE(SPACE, seed=3, max_trials=8, budget=5, n_startup=2, device="cpu")
    run_search(tpe, ScriptedBackend(4, fail={0: "always", 2: "always"}))
    assert tpe._n_obs == 6 and tpe.best().trial_id not in (0, 2)
    for cls, kw in ((Hyperband, {}), (BOHB, {"device": "cpu"})):
        algo = cls(SPACE, seed=4, max_budget=9, eta=3, **kw)
        run_search(algo, ScriptedBackend(4, fail={0: "always", 1_000_000: "always"}))
        assert algo.finished() and algo.best().status != TrialStatus.FAILED
        if cls is BOHB:
            for store in algo.obs.budgets.values():
                assert np.isfinite(store["score"][store["valid"]]).all()


# -- ledger replay and the cache (tests/test_ledger.py) -------------------


class DieAfter(ScriptedBackend):
    def __init__(self, n, **kw):
        super().__init__(**kw)
        self.n = n

    def evaluate(self, trials):
        if len(self.evaluated) >= self.n:
            raise KeyboardInterrupt("killed")
        return super().evaluate(trials)


def _ledger(path, seed=0):
    led = SweepLedger(str(path), read_only=False)
    led.ensure_header({"algorithm": "random", "seed": seed})
    return led


def test_killed_sweep_replays_to_the_unkilled_trials(tmp_path):
    fail = {3: "always", 9: "always"}
    whole = _random(20)
    run_search(whole, ScriptedBackend(fail=fail))
    led = _ledger(tmp_path / "l.jsonl")
    with pytest.raises(KeyboardInterrupt):
        run_search(_random(20), DieAfter(8, fail=fail), ledger=led)
    led.close()
    n_before = len(SweepLedger(str(tmp_path / "l.jsonl"), read_only=True).records)
    assert n_before == 8
    led = _ledger(tmp_path / "l.jsonl")
    algo, b, m = _random(20), ScriptedBackend(fail=fail), MetricsLogger()
    res = run_search(algo, b, metrics=m, ledger=led)
    led.close()
    assert res.n_replayed == m.replayed == 8 and res.n_evals == 12
    assert set(b.evaluated) == set(range(8, 20))  # journaled trials never re-run
    for tid, t in whole.trials.items():
        assert (algo.trials[tid].status, algo.trials[tid].score) == (t.status, t.score)
    assert res.best.trial_id == whole.best().trial_id


def test_killed_asha_replays_each_rung_its_own_record(tmp_path):
    """An ASHA trial journals a record a rung under one id: the resume
    serves each (trial, budget) its own record (the JAX package keys the
    replay by id alone and serves a promoted trial its last journaled
    rung's record at rung 0) and re-evaluates exactly the evaluations
    never journaled."""
    mk = lambda: ASHA(SPACE, seed=5, max_trials=12, min_budget=1, max_budget=9, eta=3)
    whole, wb = mk(), ScriptedBackend(fail={4: "always"})
    run_search(whole, wb)
    led = _ledger(tmp_path / "l.jsonl")
    with pytest.raises(KeyboardInterrupt):
        run_search(mk(), DieAfter(14, fail={4: "always"}), ledger=led)
    led.close()
    done = [(r["trial_id"], r["step"]) for r in read_ledger(str(tmp_path / "l.jsonl"))[1]]
    assert len({t for t, _ in done}) < len(done)  # a trial journaled twice
    led = _ledger(tmp_path / "l.jsonl")
    algo, b = mk(), ScriptedBackend(fail={4: "always"})
    res = run_search(algo, b, ledger=led)
    led.close()
    assert res.n_replayed == len(done)
    assert sorted(b.evaluated_at + [d for d in done if d[0] != 4]) == sorted(wb.evaluated_at)
    for tid, t in whole.trials.items():
        got = algo.trials[tid]
        assert (got.status, got.score, got.rung, got.history) == (t.status, t.score, t.rung, t.history)


def test_replay_divergence_is_refused(tmp_path):
    led = _ledger(tmp_path / "l.jsonl")
    run_search(_random(20), ScriptedBackend(), ledger=led)
    led.close()
    led = _ledger(tmp_path / "l.jsonl")
    with pytest.raises(LedgerError, match="diverged at trial 0"):
        run_search(_random(20, seed=1), ScriptedBackend(), ledger=led)
    led.close()


def test_cache_serves_only_ok_results_at_their_budget():
    cache = EvalCache(SPACE)
    params = {"lr": 0.1, "reg": 0.3}
    cache.put(params, TrialResult(0, 1.25, 20))
    hit = cache.get({"lr": 0.1, "reg": 0.3, "__inherit_from__": 3}, 20, 7)
    assert hit.trial_id == 7 and hit.score == 1.25 and hit.extra["cache_hit"]
    assert cache.get(params, 40, 9) is None and cache.get({"lr": 0.1, "reg": 0.31}, 20, 8) is None
    cache.put({"lr": 0.5, "reg": 0.5}, failed_result(1, 20, "x"))
    assert len(cache) == 1
    assert cache.seed_from([
        {"status": "failed", "score": None, "step": 20, "params": params},
        {"status": "ok", "score": 0.4, "step": 10, "params": params},
        {"status": "ok", "score": 0.9, "step": 270, "params": params},
    ]) == 2
    assert cache.get(params, 10, 1).score == 0.4 and cache.get(params, 270, 2).score == 0.9


def test_cache_hit_skips_evaluate_and_is_journaled(tmp_path):
    led = _ledger(tmp_path / "l.jsonl")
    first = _random(20)
    run_search(first, ScriptedBackend(fail={4: "always"}), ledger=led)
    led.close()
    # the same stream under other trial ids: replay misses, the cache serves
    led = _ledger(tmp_path / "l.jsonl")
    algo = _random(20)
    algo._next_id = 1000
    b, m = ScriptedBackend(fail={1004: "always"}), MetricsLogger()
    res = run_search(algo, b, metrics=m, ledger=led)
    led.close()
    assert b.evaluated == [1004]  # the failure was not cached: it re-ran
    assert res.n_cache_hits == m.cache_hits == 19
    _, records, _ = read_ledger(str(tmp_path / "l.jsonl"))
    cached = [r for r in records if r.get("cached")]
    assert len(cached) == 19 and all(r["attempts"] == 0 for r in cached)


# -- against the JAX driver on the same scripted backend ------------------
#
# The JAX package's run_search over JAX's algorithms and the port's over
# its own, fed JAX's draws (``torch_port_jax_draws.py``), each on a Twin
# of the same script. Held equal: every evaluate call's (id, budget)
# pairs in order (retry rounds included), the backoff sleeps, the
# counters of SearchResult and of the metrics logger, where the breaker
# aborts and its message, the journal's records (id, step, status,
# attempts, cached) and, after a kill, what the resume replays, serves
# from the cache and re-evaluates. Scores within rel 1e-4 (params within
# 1 f32 ulp, TPE's and BOHB's model-drawn rows within atol 1e-5, as
# ``test_torch_algorithms.py`` holds them).

SIDES = {
    "jax": (jdriver, jtrial, JMetrics, jledger.SweepLedger),
    "port": (tdriver, ttrial, MetricsLogger, SweepLedger),
}
RESULT_FIELDS = ("n_trials", "n_evals", "n_failed", "n_timeout", "n_retried", "n_replayed",
                 "n_cache_hits")
COUNTERS = ("trials_done", "trials_failed", "trials_timeout", "trials_retried", "cache_hits",
            "replayed", "stalls_detected")


class Twin:
    """One script for either package's driver: a score is ``jd.score`` of
    the params and budget; ``fail[trial_id] = n`` fails the first n
    attempts ('always': every attempt) with ``status``; past ``die_after``
    evaluations the next call raises KeyboardInterrupt (a killed run)."""

    name = "twin"

    def __init__(self, trial_mod, capacity, fail=None, status="failed", die_after=None):
        self.trial, self.capacity = trial_mod, capacity
        self.fail, self.status, self.die_after = fail or {}, status, die_after
        self.calls = []
        self.attempts = {}

    def evaluate(self, trials):
        if self.die_after is not None and sum(map(len, self.calls)) >= self.die_after:
            raise KeyboardInterrupt("killed")
        self.calls.append([(t.trial_id, t.budget) for t in trials])
        out = []
        for t in trials:
            n = self.attempts[t.trial_id] = self.attempts.get(t.trial_id, 0) + 1
            budget = self.fail.get(t.trial_id, 0)
            if budget == "always" or n <= budget:
                out.append(self.trial.failed_result(t.trial_id, t.budget, "scripted",
                                                    status=self.status))
            else:
                out.append(self.trial.TrialResult(t.trial_id, jd.score(t.params, t.budget),
                                                  t.budget))
        return out


def _drive(side, algo, twin, policy=None, ledger=None):
    """One run_search of ``side``: its numbers, or the breaker's message."""
    drv, _, metrics_cls, _ = SIDES[side]
    m, slept = metrics_cls(), []
    real_sleep, time.sleep = time.sleep, slept.append
    try:
        res = drv.run_search(algo, twin, metrics=m, ledger=ledger,
                             policy=None if policy is None else drv.FailurePolicy(**policy))
        out = {k: getattr(res, k) for k in RESULT_FIELDS}
        out["best"] = None if res.best is None else (res.best.trial_id, res.best.score)
    except drv.SweepAborted as e:  # its counts and rate (the prose differs)
        out = {"aborted": str(e).split(")")[0]}
    finally:
        time.sleep = real_sleep
    out.update(calls=twin.calls, slept=slept, counters={k: getattr(m, k) for k in COUNTERS})
    return out


def _assert_same(got, want):
    gb, wb = got.pop("best", None), want.pop("best", None)
    assert got == want
    assert (gb is None) == (wb is None)
    if gb is not None:
        assert gb[0] == wb[0] and gb[1] == pytest.approx(wb[1], rel=1e-4)


POLICY_CASES = {
    "random-retries": ("random", {}, {2: 2, 5: 1}, "failed", dict(max_retries=2, backoff_s=0.5)),
    "asha-retries": ("asha", {}, {0: "always", 4: 1, 9: 2}, "failed",
                     dict(max_retries=1, backoff_s=0.5)),
    "pbt-retries": ("pbt", {}, {0: "always", 8: 1}, "failed", dict(max_retries=2, backoff_s=0.5)),
    "tpe-retries": ("tpe", {}, {1: "always", 7: 1}, "failed", dict(max_retries=1, backoff_s=0.5)),
    "hyperband-retries": ("hyperband", {}, {0: "always", 3: 1}, "failed",
                          dict(max_retries=1, backoff_s=0.5)),
    "bohb-retries": ("bohb", {}, {0: "always", 5: 1}, "failed", dict(max_retries=1, backoff_s=0.5)),
    "random-timeouts": ("random", {}, {0: "always", 3: "always"}, "timeout", None),
    # 6 of the first 8 evaluations fail after their retry: the breaker
    # trips at the end of the second batch
    "random-breaker": ("random", dict(max_trials=24), {i: "always" for i in range(2, 24)}, "failed",
                       dict(max_retries=1, backoff_s=0.5, max_failure_rate=0.5,
                            min_evals_for_abort=8)),
    # below its minimum the breaker never trips, however many fail
    "asha-breaker-minimum": ("asha", {}, {i: "always" for i in range(0, 20, 2)}, "failed",
                             dict(max_failure_rate=0.2, min_evals_for_abort=100)),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_failure_policy_equals_the_jax_driver(case, monkeypatch):
    jd.install(monkeypatch)
    name, kw, fail, status, policy = POLICY_CASES[case]
    capacity = jd.CASES[name][1]
    jalgo, talgo = jd.pair(name, **kw)
    want = _drive("jax", jalgo, Twin(jtrial, capacity, fail, status), policy)
    got = _drive("port", talgo, Twin(ttrial, capacity, fail, status), policy)
    assert ("aborted" in got) == case.endswith("-breaker")
    if policy and policy.get("max_retries"):
        assert got["slept"] and got["counters"]["trials_retried"] > 0
    _assert_same(got, want)


def _journal(path):
    _, records, _ = read_ledger(path)
    return [(r["trial_id"], r["step"], r["status"], r["attempts"], bool(r.get("cached")), r["score"])
            for r in records]


def _assert_same_journal(got, want):
    assert [g[:5] for g in got] == [w[:5] for w in want]
    for g, w in zip(got, want):
        assert (g[5] is None) == (w[5] is None) and (g[5] is None or g[5] == pytest.approx(w[5], rel=1e-4))


def _killed_then_resumed(side, tmp_path, mk, fail, die_after, first_id=None):
    """A run killed after ``die_after`` evaluations, then resumed from its
    ledger by a new algorithm (its ids from ``first_id``, when given)."""
    _, trial_mod, _, ledger_cls = SIDES[side]
    path = str(tmp_path / f"{side}.jsonl")
    capacity = 4
    led = ledger_cls(path, read_only=False)
    led.ensure_header({"algorithm": "parity", "seed": 11})
    with pytest.raises(KeyboardInterrupt):
        SIDES[side][0].run_search(mk(), Twin(trial_mod, capacity, fail, die_after=die_after),
                                  ledger=led)
    led.close()
    algo = mk()
    if first_id is not None:
        algo._next_id = first_id
    led = ledger_cls(path, read_only=False)
    led.ensure_header({"algorithm": "parity", "seed": 11})
    out = _drive(side, algo, Twin(trial_mod, capacity, fail), ledger=led)
    led.close()
    return algo, out, _journal(path)


@pytest.mark.parametrize("first_id", [None, 1000], ids=["replay", "cache"])
def test_killed_random_resumes_as_the_jax_driver_does(first_id, tmp_path, monkeypatch):
    """The resume replays the journal (the same ids) or, under other ids,
    is served the killed run's ok results by the cache; failed records
    never serve a new id."""
    jd.install(monkeypatch)
    fail = {3: "always", 9: "always", 1003: "always"}
    runs = {}
    for i, side in enumerate(("jax", "port")):
        runs[side] = _killed_then_resumed(side, tmp_path, lambda: jd.pair("random", max_trials=20)[i],
                                          fail, 8, first_id)
    (_, want, wj), (_, got, gj) = runs["jax"], runs["port"]
    if first_id is None:
        assert got["n_replayed"] == 8 and got["n_evals"] == 12
    else:
        assert got["n_cache_hits"] == 7 and got["n_evals"] == 13
    _assert_same(got, want)
    _assert_same_journal(gj, wj)


def test_killed_asha_resume_against_the_jax_driver(tmp_path, monkeypatch):
    """Unkilled, the two drivers agree. Killed and resumed, the JAX
    driver's replay keyed by trial id serves a promoted trial its last
    journaled rung's record at rung 0, so its rung-0 history differs from
    the unkilled run's; the port's, keyed by (trial id, budget), gives
    the unkilled run's trials back."""
    jd.install(monkeypatch)
    fail = {4: "always"}
    whole = {}
    for i, side in enumerate(("jax", "port")):
        algo = jd.pair("asha")[i]
        whole[side] = (algo, _drive(side, algo, Twin(SIDES[side][1], 4, fail)))
    _assert_same(dict(whole["port"][1]), dict(whole["jax"][1]))
    # (status, budgets, scores) of each trial's history
    hist = lambda algo: {t: (x.status.value, [b for b, _ in x.history], [s for _, s in x.history])
                         for t, x in algo.trials.items()}
    jalgo, jout, jj = _killed_then_resumed("jax", tmp_path, lambda: jd.pair("asha")[0], fail, 14)
    talgo, tout, tj = _killed_then_resumed("port", tmp_path, lambda: jd.pair("asha")[1], fail, 14)
    promoted = [tid for tid, _, _, _, _, _ in tj if sum(r[0] == tid for r in tj[:14]) > 1]
    assert promoted  # a trial journaled two rungs before the kill
    want = hist(whole["port"][0])
    assert hist(talgo) == want
    jax_hist = hist(jalgo)
    for tid in promoted:  # JAX: rung 0 holds a later rung's record
        assert jax_hist[tid][1][0] > want[tid][1][0] == 1
    assert jax_hist != hist(whole["jax"][0])


# -- SearchCheckpointer ---------------------------------------------------


def test_search_checkpointer_round_trips_algorithm_backend_and_pool(tmp_path):
    from mpi_opt_tpu_torch.backends import get_backend
    from mpi_opt_tpu_torch.utils.checkpoint import SearchCheckpointer
    from mpi_opt_tpu_torch.workloads import get_workload

    wl = get_workload("fashion_mlp", n_train=256, n_val=64)
    mk = lambda: (ASHA(wl.default_space(), seed=2, max_trials=8, min_budget=1, max_budget=9),
                  get_backend("gpu", wl, population=4, seed=2, device="cpu"))
    whole, wb = mk()
    run_search(whole, wb)
    algo, be = mk()
    ck = SearchCheckpointer(str(tmp_path / "ck"), every=2, keep=2)
    run_search(algo, be, checkpointer=ck, max_batches=4)
    assert ck.latest_step() == 4
    algo2, be2 = mk()
    assert ck.restore_into(algo2, be2) == 4
    assert be2._slot_of == be._slot_of and be2._step_counter == be._step_counter
    for k, v in be._pool.params.items():
        assert torch.equal(be2._pool.params[k], v)
    run_search(algo2, be2)
    assert {t: (x.status, x.score) for t, x in algo2.trials.items()} == {
        t: (x.status, x.score) for t, x in whole.trials.items()}
    ck.close()
    with pytest.raises(ValueError, match="slot count"):
        get_backend("gpu", wl, population=2, device="cpu").load_device_state(
            {"params": be._pool.params, "momentum": be._pool.momentum, "step": be._pool.step})


# -- the CLI's driver path --------------------------------------------------


@pytest.fixture(autouse=True)
def _small_data(monkeypatch):
    real = cli.get_workload
    monkeypatch.setattr(cli, "get_workload", lambda name: real(name, n_train=256, n_val=128))


def _run(argv, capsys):
    rc = cli.main(argv)
    out = capsys.readouterr()
    return rc, [json.loads(x) for x in out.out.splitlines() if x.startswith("{")], out.err


ASHA_ARGV = ["--workload", "fashion_mlp", "--algorithm", "asha", "--trials", "12", "--min-budget",
             "1", "--max-budget", "9", "--eta", "3", "--population", "4", "--seed", "3",
             "--device", "cpu"]
FIELDS = ("trial_id", "params", "status", "score", "step")


def _records(path):
    return [{k: r[k] for k in FIELDS} for r in (json.loads(x) for x in open(path).read().splitlines()[1:])]


@pytest.mark.parametrize("algorithm", sorted(ALGORITHMS))
def test_cli_driver_path_runs_every_algorithm(algorithm, capsys):
    rc, lines, _ = _run(["--workload", "fashion_mlp", "--algorithm", algorithm, "--trials", "6",
                         "--budget", "2", "--max-budget", "3", "--min-budget", "1", "--population",
                         "4", "--generations", "2", "--steps-per-generation", "2", "--device",
                         "cpu"], capsys)
    assert rc == 0
    s = lines[-1]
    assert (s["algorithm"], s["backend"]) == (algorithm, "gpu")
    assert s["n_trials"] > 0 and 0.0 <= s["best_score"] <= 1.0
    assert lines[-2]["event"] == "summary" and lines[-2]["final"]


def test_cli_driver_ledger_is_read_by_the_jax_package(tmp_path, capsys):
    from mpi_opt_tpu.ledger import SweepLedger as JaxLedger
    from mpi_opt_tpu.ledger import read_ledger as jax_read
    from mpi_opt_tpu.workloads import get_workload as jax_get_workload

    path = str(tmp_path / "l.jsonl")
    rc, lines, _ = _run(ASHA_ARGV + ["--ledger", path], capsys)
    assert rc == 0
    jl = JaxLedger(path, read_only=True)
    cfg = jl.header["config"]
    assert cfg["space_hash"] == jax_get_workload("fashion_mlp").default_space().space_hash()
    assert (cfg["capacity"], cfg["seed"], cfg["algorithm"]) == (4, 3, "asha")
    assert len(jl.completed()) == lines[-1]["n_trials"]
    # one record an evaluation (an ASHA trial journals each rung)
    _, records, n_torn = jax_read(path, strict=True)
    assert n_torn == 0 and len(records) == lines[-2]["trials"] > lines[-1]["n_trials"]


def test_cli_driver_sigterm_drains_and_resume_matches_unkilled(tmp_path, capsys, monkeypatch):
    d0, d1 = tmp_path / "a", tmp_path / "b"
    argv = lambda d: ASHA_ARGV + ["--ledger", str(d / "l.jsonl"), "--checkpoint-dir", str(d / "ck")]
    rc, want, _ = _run(argv(d0), capsys)
    assert rc == 0
    real_beat, beats = tdriver.heartbeat.beat, {"n": 0}

    def beat(**kw):
        beats["n"] += 1
        if beats["n"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        real_beat(**kw)

    monkeypatch.setattr(tdriver.heartbeat, "beat", beat)
    rc, lines, err = _run(argv(d1), capsys)
    monkeypatch.setattr(tdriver.heartbeat, "beat", real_beat)
    assert rc == 75 and lines[-1]["preempted"] and lines[-1]["at"] == "batch 2"
    assert "relaunch with --resume" in err
    with pytest.raises(SystemExit) as exc:  # a stale directory needs --resume
        cli.main(argv(d1))
    assert exc.value.code == 2
    rc, got, _ = _run(argv(d1) + ["--resume"], capsys)
    assert rc == 0
    assert _records(d1 / "l.jsonl") == _records(d0 / "l.jsonl")
    assert (got[-1]["best_score"], got[-1]["best_params"]) == (want[-1]["best_score"],
                                                                want[-1]["best_params"])


def test_cli_driver_breaker_exits_1_and_retries_count(tmp_path, capsys, monkeypatch):
    from mpi_opt_tpu_torch.train import population

    real = population.PopulationTrainer.eval_population
    monkeypatch.setattr(population.PopulationTrainer, "eval_population",
                        lambda self, *a, **k: real(self, *a, **k) * math.nan)
    rc, lines, err = _run(["--workload", "fashion_mlp", "--algorithm", "random", "--trials", "24",
                           "--budget", "1", "--population", "8", "--max-failure-rate", "0.5",
                           "--trial-retries", "1", "--device", "cpu"], capsys)
    assert rc == 1 and "aborted" in lines[-1] and "max_failure_rate" in err
    summary = [x for x in lines if x.get("event") == "summary"][-1]
    assert summary["aborted"] and summary["trials"] == 24 and summary["trials_failed"] == 24
    assert summary["trials_retried"] == 24


@pytest.mark.parametrize("extra,message", [
    # --backend cpu and --workers run now (test_torch_backend_cpu.py); the
    # cases keep their ids and check the refusals those flags still have
    pytest.param(["--backend", "cpu", "--trial-timeout", "0"], "--trial-timeout must be > 0",
                 id="extra0---backend cpu is not ported yet"),
    (["--backend", "tpu"], "--backend gpu"),
    (["--wave-size", "2"], "requires --fused"),
    (["--objectives", "accuracy:max,params:min", "--algorithm", "pbt"], "requires --fused"),
    (["--trial-retries", "-1"], "--trial-retries must be >= 0"),
    (["--max-failure-rate", "0"], "--max-failure-rate must be in (0, 1]"),
    pytest.param(["--workers", "-1"], "--workers must be >= 0",
                 id="extra6---workers is not ported yet"),
])
def test_cli_driver_refusals_are_usage_errors(extra, message, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--workload", "fashion_mlp", "--device", "cpu", *extra])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err

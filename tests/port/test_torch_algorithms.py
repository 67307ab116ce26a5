"""The port's host algorithms (``mpi_opt_tpu_torch/algorithms/``) against
the JAX package's, decision for decision.

Each JAX algorithm and its port run against one deterministic stub
backend defined here: a trial's score is a fixed function of its
materialized params and budget, and a trial with momentum above 0.93
fails. The port's ``_draw_*`` methods are replaced by ones that make
JAX's own draws for the same path (``torch_port_jax_draws.py``), so both
sides decide from the same numbers.

Held: the evaluated sequence (trial ids, budgets, ``__inherit_from__``,
statuses) and the best trial's id equal; unit rows bit-equal, except
TPE's and BOHB's model-drawn rows (the acquisition's floats, atol 1e-5,
``test_torch_tpe.py``'s tolerance); materialized params within 1 f32
ulp (LogUniform's ``exp``, ROADMAP Queue 3), the model-drawn rows'
within rtol 1e-4. Then the checkpoint round trips of
``tests/test_algorithms.py``, on the stub backend.
"""

import numpy as np
import pytest
import torch

import mpi_opt_tpu_torch.algorithms as talg
import mpi_opt_tpu_torch.ops.tpe as ttpe
import mpi_opt_tpu_torch.space as tspace
import torch_port_jax_draws as jd
from mpi_opt_tpu.trial import TrialResult as JResult
from mpi_opt_tpu.trial import failed_result as jfailed
from mpi_opt_tpu_torch.algorithms.base import Observation
from mpi_opt_tpu_torch.driver import run_search
from mpi_opt_tpu_torch.ops.pbt import PBTConfig
from mpi_opt_tpu_torch.trial import TrialResult, TrialStatus, failed_result

_space, CASES = jd.space, jd.CASES


class Stub:
    """The deterministic backend both packages run against."""

    name = "stub"

    def __init__(self, capacity, ok_cls, fail_fn):
        self.capacity = capacity
        self.ok_cls, self.fail_fn = ok_cls, fail_fn
        self.log = []

    def evaluate(self, trials):
        out = []
        for t in trials:
            self.log.append((t.trial_id, t.budget, t.params.get("__inherit_from__"),
                             np.array(t.unit), dict(t.params)))
            if t.params["momentum"] > 0.93:
                out.append(self.fail_fn(t.trial_id, t.budget, "stub failure"))
            else:
                out.append(self.ok_cls(trial_id=t.trial_id, score=jd.score(t.params, t.budget),
                                       step=t.budget))
        return out

    def reset(self):
        pass


@pytest.fixture
def jax_draws(monkeypatch):
    jd.install(monkeypatch)


def _jax_run(algo, capacity):
    stub = Stub(capacity, JResult, jfailed)
    while not algo.finished():
        batch = algo.next_batch(capacity)
        if not batch:  # PBT's last exploit closes the search
            assert algo.finished()
            break
        algo.report_batch(stub.evaluate(batch))
    return stub.log, algo.best()


def _ulps(a, b):
    a, b = np.float32(a), np.float32(b)
    return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_decisions_equal_jax_given_its_draws(name, jax_draws):
    capacity = CASES[name][1]
    jalgo, talgo = jd.pair(name)
    want, jbest = _jax_run(jalgo, capacity)
    stub = Stub(capacity, TrialResult, failed_result)
    res = run_search(talgo, stub)
    got = stub.log
    assert [g[:3] for g in got] == [w[:3] for w in want]
    assert res.best.trial_id == jbest.trial_id
    assert {t.trial_id: t.status.value for t in _all_trials(talgo)} == {
        t.trial_id: t.status.value for t in _all_trials(jalgo)}
    modelled = name in ("tpe", "bohb")
    for (tid, _, _, tu, tp), (_, _, _, ju, jp) in zip(got, want):
        if modelled:
            np.testing.assert_allclose(tu, ju, atol=1e-5, err_msg=f"trial {tid}")
        else:
            np.testing.assert_array_equal(tu, ju, err_msg=f"trial {tid}")
        assert tp.keys() == jp.keys()
        for k in tp:
            if isinstance(tp[k], float):
                if modelled:
                    assert tp[k] == pytest.approx(jp[k], rel=1e-4), (tid, k)
                else:
                    assert _ulps(tp[k], jp[k]) <= 1, (tid, k, tp[k], jp[k])
            else:
                assert tp[k] == jp[k], (tid, k)
    if name == "bohb":  # the model drew in a later bracket
        assert talgo.obs.model_budget() is not None


def _all_trials(algo):
    if hasattr(algo, "brackets"):
        return [t for b in algo.brackets for t in b.trials.values()]
    return list(algo.trials.values())


def test_pbt_decisions_exercise_inheritance_and_failures(jax_draws):
    """The PBT case above inherits weights and fails members, so its
    bit-equal sequence covers the -inf rank of a failed member."""
    kw, capacity = CASES["pbt"]
    algo = talg.PBT(_space(tspace), seed=11, config=PBTConfig(truncation_frac=0.34), **kw)
    stub = Stub(capacity, TrialResult, failed_result)
    run_search(algo, stub)
    assert len(stub.log) == 18
    assert sum(g[2] is not None for g in stub.log) == 12
    assert any(t.status == TrialStatus.FAILED for t in algo.trials.values())


# -- the port alone: checkpoint round trips (tests/test_algorithms.py) ------


def _stub(capacity=4):
    return Stub(capacity, TrialResult, failed_result)


def test_checkpoint_roundtrip_random():
    """A resume finishes the remaining trials, not a new budget."""
    space = _space(tspace)
    algo = talg.RandomSearch(space, seed=5, max_trials=8, budget=10)
    run_search(algo, _stub(), max_batches=1)
    done_before = sum(t.score is not None for t in algo.trials.values())
    assert 0 < done_before < 8
    algo2 = talg.RandomSearch(space, seed=0, max_trials=8, budget=10)
    algo2.load_state_dict(algo.state_dict())
    assert algo2.seed == 5
    run_search(algo2, _stub())
    assert algo2.finished() and len(algo2.trials) == 8
    units = np.stack([t.unit for t in algo2.trials.values()])
    assert len(np.unique(units.round(6), axis=0)) == 8


def test_checkpoint_midflight_asha():
    """In-flight trials at checkpoint time are re-dispatched on resume."""
    space = _space(tspace)
    algo = talg.ASHA(space, seed=6, max_trials=9, min_budget=3, max_budget=27, eta=3)
    batch = algo.next_batch(4)
    assert len(batch) == 4
    algo2 = talg.ASHA(space, seed=0, max_trials=9, min_budget=3, max_budget=27, eta=3)
    algo2.load_state_dict(algo.state_dict())
    run_search(algo2, _stub())
    assert algo2.finished()
    for t in batch:
        assert algo2.trials[t.trial_id].score is not None or \
            algo2.trials[t.trial_id].status == TrialStatus.FAILED


def test_checkpoint_midgeneration_pbt():
    """A PBT checkpoint mid-generation resumes that generation's members."""
    space = _space(tspace)
    algo = talg.PBT(space, seed=7, population=8, generations=3, steps_per_generation=5)
    assert len(algo.next_batch(3)) == 3
    algo2 = talg.PBT(space, seed=0, population=8, generations=3, steps_per_generation=5)
    algo2.load_state_dict(algo.state_dict())
    stub = _stub()
    run_search(algo2, stub)
    assert algo2.finished()
    assert len(stub.log) == 8 * 3  # every member of every generation once
    # the inheritance metadata survives the round trip
    assert any(t.params.get("__inherit_from__") is not None for t in algo2.trials.values())


def test_pbt_respects_batch_capacity():
    algo = talg.PBT(_space(tspace), seed=8, population=8, generations=2, steps_per_generation=5)
    stub, sizes = _stub(), []
    while not algo.finished():
        batch = algo.next_batch(3)
        if not batch:
            break
        sizes.append(len(batch))
        algo.report_batch(stub.evaluate(batch))
    assert algo.finished() and max(sizes) <= 3 and sum(sizes) == 16


@pytest.mark.parametrize("name", ["random", "tpe"])
def test_checkpoint_midflight_random_tpe(name):
    """A state captured between next_batch and report_batch resumes:
    in-flight trials are re-dispatched, not left RUNNING."""
    space = _space(tspace)
    kw = {"device": "cpu"} if name == "tpe" else {}
    algo = talg.get_algorithm(name)(space, seed=9, max_trials=6, budget=5, **kw)
    batch = algo.next_batch(4)
    algo2 = talg.get_algorithm(name)(space, seed=0, max_trials=6, budget=5, **kw)
    algo2.load_state_dict(algo.state_dict())
    stub = _stub()
    run_search(algo2, stub)
    assert algo2.finished()
    assert {g[0] for g in stub.log} >= {t.trial_id for t in batch}
    assert len(stub.log) == 6


def test_checkpoint_roundtrip_hyperband_and_bohb():
    """Hyperband/BOHB state survives a JSON round trip mid-bracket, and a
    mismatched checkpoint is refused before anything is loaded."""
    import json

    space = _space(tspace)
    for cls, kw in ((talg.Hyperband, {}), (talg.BOHB, {"device": "cpu", "n_min": 5})):
        algo = cls(space, seed=3, max_budget=9, eta=3, **kw)
        run_search(algo, _stub(), max_batches=4)
        state = json.loads(json.dumps(algo.state_dict()))
        algo2 = cls(space, seed=3, max_budget=9, eta=3, **kw)
        algo2.load_state_dict(state)
        rest_a, rest_b = _stub(), _stub()
        run_search(algo, rest_a)
        run_search(algo2, rest_b)
        assert [g[:3] for g in rest_a.log] == [g[:3] for g in rest_b.log]
        with pytest.raises(ValueError, match="checkpoint is for"):
            cls(space, seed=3, max_budget=27, eta=3, **kw).load_state_dict(state)


def test_tpe_clamps_oversized_batch():
    """A capacity above n_candidates clamps, not IndexError."""
    algo = talg.TPE(_space(tspace), seed=0, max_trials=40, budget=1, n_startup=2,
                    config=ttpe.TPEConfig(n_candidates=16), device="cpu")
    stub = _stub(64)
    res = run_search(algo, stub)
    assert res.n_trials == 40 and len(stub.log) == 40


def test_best_skips_non_finite_and_failed():
    space = _space(tspace)
    algo = talg.RandomSearch(space, seed=1, max_trials=4, budget=1)
    batch = algo.next_batch(4)
    algo.report_batch([
        TrialResult(batch[0].trial_id, float("nan"), 1),
        TrialResult(batch[1].trial_id, 0.3, 1),
        TrialResult(batch[2].trial_id, float("inf"), 1),
        failed_result(batch[3].trial_id, 1, "boom"),
    ])
    assert algo.best().trial_id == batch[1].trial_id
    assert algo.trials[batch[3].trial_id].status == TrialStatus.FAILED


def test_ingest_seed_points_replace_first_draws():
    space = _space(tspace)
    algo = talg.ASHA(space, seed=2, max_trials=4, min_budget=1, max_budget=3, eta=3)
    u = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    assert algo.ingest_observations([Observation(u, 1.0), Observation(u * 2, float("nan"))]) == 1
    first = algo.next_batch(2)
    np.testing.assert_array_equal(first[0].unit, u)
    assert not np.array_equal(first[1].unit, u)


def test_sample_is_from_unit_of_sample_unit():
    space = _space(tspace)
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    vals = space.sample(g1, 5)
    ref = space.from_unit(space.sample_unit(g2, 5))
    for k in vals:
        assert torch.equal(vals[k], ref[k])

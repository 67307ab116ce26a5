"""The slot-pool backend (``mpi_opt_tpu_torch/backends/gpu.py``) and the
masked trainer under it, on the CPU.

- ``train_segment_masked`` against the JAX package's
  ``_train_segment_masked`` on a narrow MLP and a narrow SmallCNN, given
  JAX's batch and augmentation draws, with ``rem`` mixed and including
  0. Tolerances of ``test_torch_population.py``: params atol 1e-5,
  momentum atol 1e-3, losses atol 1e-5; step counts equal, and a
  rem-0 member's state bit-untouched.
- The backend against the JAX package's ``tpu`` backend: both pools
  start from the same member weights (``models/convert.py``), one mixed
  batch runs with JAX's draws; every score within one validation sample.
- The invariants of ``tests/test_backend_tpu.py`` (all but the mesh):
  ordered results, mixed budgets, warm resume, PBT inheritance,
  eviction, in-batch sources never evicted, full PBT and ASHA searches,
  ``reset()`` bit-identical to a fresh backend, a non-finite score
  failed and evicted; and one launch width: a batch gives the same
  scores whatever its padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_opt_tpu_torch.train.population as tpop
from mpi_opt_tpu.backends import get_backend as jax_get_backend
from mpi_opt_tpu.models.cnn import SmallCNN as FlaxSmallCNN
from mpi_opt_tpu.models.mlp import MLP as FlaxMLP
from mpi_opt_tpu.train.population import OptHParams as JaxOptHParams
from mpi_opt_tpu.train.population import PopState as JaxPopState
from mpi_opt_tpu.train.population import PopulationTrainer as JaxTrainer
from mpi_opt_tpu.workloads import get_workload as jax_get_workload
from mpi_opt_tpu_torch.algorithms import ASHA, PBT
from mpi_opt_tpu_torch.backends import get_backend
from mpi_opt_tpu_torch.driver import run_search
from mpi_opt_tpu_torch.models import MLP, SmallCNN
from mpi_opt_tpu_torch.models.convert import flax_to_torch
from mpi_opt_tpu_torch.trial import Trial
from mpi_opt_tpu_torch.workloads import get_workload

HP = dict(lr=[0.1, 0.05, 0.2], momentum=[0.9, 0.5, 0.8], weight_decay=[1e-4, 1e-3, 0.0],
          flip_prob=[0.5, 0.3, 0.1], shift=[2.0, 3.0, 1.0])


def _jax_aug_draws(key, flip_prob, shift, b):
    """The draws of mpi_opt_tpu/train/population.py::_augment, one member."""
    k_flip, k_dy, k_dx = jax.random.split(key, 3)
    do_flip = jax.random.bernoulli(k_flip, flip_prob, (b, 1, 1, 1)).reshape(b)
    max_s = jnp.maximum(shift, 0.0)
    dy = jnp.round(jax.random.uniform(k_dy, (), minval=-max_s, maxval=max_s)).astype(jnp.int32)
    dx = jnp.round(jax.random.uniform(k_dx, (), minval=-max_s, maxval=max_s)).astype(jnp.int32)
    return np.asarray(do_flip), int(dy), int(dx)


def _segment_draws(key, steps, n_data, b, flip, shift, n_keys, n_real):
    """JAX's draws of ``_train_segment_masked`` from ``key``: per step the
    batch indices and the first ``n_real`` members' augmentation (of
    ``n_keys`` member keys, the padded width)."""
    batches, augs = [], []
    for _ in range(steps):
        key, k_batch, k_aug = jax.random.split(key, 3)
        batches.append(torch.from_numpy(np.array(jax.random.randint(k_batch, (b,), 0, n_data))).long())
        keys = jax.random.split(k_aug, n_keys)
        d = [_jax_aug_draws(keys[m], flip[m], shift[m], b) for m in range(n_real)]
        augs.append((torch.tensor(np.stack([x[0] for x in d])), torch.tensor([x[1] for x in d]),
                     torch.tensor([x[2] for x in d])))
    return batches, augs


@pytest.fixture
def inject(monkeypatch):
    """Feed given draws to the port's trainer in order."""
    def install(batches, augs):
        batches, augs = list(batches), list(augs)
        monkeypatch.setattr(tpop, "draw_batch", lambda g, n, b: batches.pop(0))
        monkeypatch.setattr(tpop, "draw_augment", lambda g, f, s, b: augs.pop(0))
        return batches, augs

    return install


def _case(kind):
    """(flax model, port model_fn, image size, channels), both in f32."""
    if kind == "mlp":
        flax_model, hw, c = FlaxMLP(hidden=16, n_classes=10, dtype=jnp.float32), 8, 1
        port = lambda p, dev: MLP(hw * hw * c, hidden=16, n_classes=10, dtype=torch.float32,
                                  population=p, device=dev)
    else:
        flax_model, hw, c = FlaxSmallCNN(n_classes=10, width=8, dtype=jnp.float32), 8, 3
        port = lambda p, dev: SmallCNN(n_classes=10, width=8, dtype=torch.float32, population=p,
                                       image_size=hw, device=dev)
    return flax_model, port, hw, c


@pytest.mark.parametrize("kind", ["mlp", "smallcnn"])
def test_masked_segment_matches_jax_given_its_draws(kind, inject):
    flax_model, port_model, hw, c = _case(kind)
    p, b, n_data, steps = 3, 4, 32, 3
    rem = np.array([0, 2, 3], np.int32)
    rng = np.random.default_rng(0)
    tx = rng.standard_normal((n_data, hw, hw, c)).astype(np.float32)
    ty = rng.integers(0, 10, n_data).astype(np.int32)
    jt = JaxTrainer(apply_fn=lambda pr, x: flax_model.apply({"params": pr}, x),
                    init_fn=lambda r, x: flax_model.init(r, x)["params"], batch_size=b)
    st = jt.init_population(jax.random.key(0), jnp.zeros((1, hw, hw, c)), p)
    mom = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.01).astype(np.float32), st.params)
    st = JaxPopState(params=st.params, momentum=jax.tree.map(jnp.asarray, mom), step=st.step)
    hp = {k: np.asarray(v, np.float32) for k, v in HP.items()}
    key = jax.random.key(7)
    want, want_loss = jt.train_segment_masked(
        st, JaxOptHParams(**{k: jnp.asarray(v) for k, v in hp.items()}), jnp.asarray(tx),
        jnp.asarray(ty), key, steps, jnp.asarray(rem))

    batches, augs = inject(*_segment_draws(key, steps, n_data, b, hp["flip_prob"], hp["shift"], p, p))
    to_port = lambda tree: flax_to_torch(jax.tree.map(np.asarray, tree), stacked=True)
    state = tpop.PopState(to_port(st.params), to_port(mom), torch.zeros(p, dtype=torch.int32))
    before = {k: v.clone() for k, v in state.params.items()}
    trainer = tpop.PopulationTrainer(port_model, batch_size=b, device="cpu")
    _, loss = trainer.train_segment_masked(
        state, tpop.OptHParams(**{k: torch.from_numpy(v) for k, v in hp.items()}),
        torch.from_numpy(tx), torch.from_numpy(ty).long(), torch.Generator(), steps,
        torch.from_numpy(rem))
    assert not batches and not augs  # every draw consumed
    assert state.step.tolist() == rem.tolist() == np.asarray(want.step).tolist()
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), atol=1e-5)
    for name, tree, atol in (("params", want.params, 1e-5), ("momentum", want.momentum, 1e-3)):
        ref = to_port(tree)
        for k in ref:
            np.testing.assert_allclose(getattr(state, name)[k].numpy(), ref[k].numpy(), atol=atol,
                                       err_msg=f"{name} {k}")
    for k, v in state.params.items():  # rem 0: bit-untouched
        assert torch.equal(v[0], before[k][0]), k


def test_masked_equals_unmasked_when_uniform():
    """rem equal to the segment length everywhere: bit-identical to
    ``train_segment`` (the same draws, every update applied)."""
    _, port_model, hw, c = _case("mlp")
    rng = np.random.default_rng(1)
    tx = torch.from_numpy(rng.standard_normal((32, hw, hw, c)).astype(np.float32))
    ty = torch.from_numpy(rng.integers(0, 10, 32)).long()
    trainer = tpop.PopulationTrainer(port_model, batch_size=4, device="cpu")
    hp = tpop.OptHParams.defaults(3, lr=0.05)
    a = trainer.init_population(torch.Generator().manual_seed(0), 3)
    b = tpop.PopState({k: v.clone() for k, v in a.params.items()},
                      {k: v.clone() for k, v in a.momentum.items()}, a.step.clone())
    trainer.train_segment(a, hp, tx, ty, torch.Generator().manual_seed(2), 5)
    trainer.train_segment_masked(b, hp, tx, ty, torch.Generator().manual_seed(2), 5,
                                 torch.full((3,), 5, dtype=torch.int32))
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]) and torch.equal(a.momentum[k], b.momentum[k])
    assert b.step.tolist() == [5, 5, 5]


def test_select_members_picks_per_member():
    _, port_model, _, _ = _case("mlp")
    trainer = tpop.PopulationTrainer(port_model, batch_size=4, device="cpu")
    a = trainer.init_population(torch.Generator().manual_seed(0), 3)
    b = trainer.init_population(torch.Generator().manual_seed(1), 3)
    b.step += 4
    s = trainer.select_members(torch.tensor([True, False, True]), a, b)
    k = "fc1.weight"
    assert torch.equal(s.params[k][0], a.params[k][0]) and torch.equal(s.params[k][1], b.params[k][1])
    assert s.step.tolist() == [0, 4, 0]


# -- the backend ------------------------------------------------------------


@pytest.fixture(scope="module")
def workload():
    return get_workload("fashion_mlp", n_train=1024, n_val=256)


def _trial(space, tid, budget, seed=0, **extra):
    unit = space.sample_unit(torch.Generator().manual_seed(1000 * seed + tid), 1).numpy()[0]
    params = space.materialize_row(unit)
    params.update(extra)
    return Trial(trial_id=tid, params=params, unit=unit, budget=budget)


def _be(workload, **kw):
    return get_backend("gpu", workload, device="cpu", **kw)


def test_backend_matches_jax_backend_from_the_same_weights(inject):
    """One mixed batch (warm resumes of 0, 2 and 3 steps) through both
    backends from the same pool weights, with JAX's draws: each score
    within one validation sample (a near-tie argmax may flip)."""
    n_train, n_val = 256, 128
    jwl = jax_get_workload("fashion_mlp", n_train=n_train, n_val=n_val)
    twl = get_workload("fashion_mlp", n_train=n_train, n_val=n_val)
    jbe = jax_get_backend("tpu", jwl, population=4, seed=3)
    tbe = _be(twl, population=4, seed=3)
    jbe._setup()
    tbe._setup()
    to_port = lambda tree: flax_to_torch(jax.tree.map(np.asarray, tree), stacked=True)
    tbe._pool = tpop.PopState(to_port(jbe._pool.params), to_port(jbe._pool.momentum),
                              torch.from_numpy(np.asarray(jbe._pool.step)).int())
    space = twl.default_space()
    budgets = [0, 2, 3]
    trials = [_trial(space, i, b, seed=4) for i, b in enumerate(budgets)]
    from mpi_opt_tpu.trial import Trial as JTrial

    jtrials = [JTrial(trial_id=t.trial_id, params=dict(t.params), unit=t.unit, budget=t.budget)
               for t in trials]
    for be in (jbe, tbe):  # warm resumes of slots 0..2 at 0 steps done
        for i in range(3):
            be._slot_of[i] = i
            be._trained[i] = 0
            be._free.remove(i)
    unit = np.stack([t.unit for t in trials])
    jhp = jwl.make_hparams(jbe._space.from_unit(jnp.asarray(np.pad(unit, ((0, 1), (0, 0))))))
    key = jax.random.fold_in(jax.random.key(3), 9000)
    _, k_train = jax.random.split(key)
    inject(*_segment_draws(k_train, 3, n_train, twl.batch_size, np.asarray(jhp.flip_prob),
                           np.asarray(jhp.shift), 4, 3))
    want = jbe.evaluate(jtrials)
    got = tbe.evaluate(trials)
    assert [r.trial_id for r in got] == [0, 1, 2]
    for g, w in zip(got, want):
        assert g.ok and w.ok and g.step == w.step
        assert abs(g.score - w.score) <= 1 / n_val + 1e-9, (g.score, w.score)
    assert tbe._trained == jbe._trained


def test_batch_evaluation_returns_ordered_results(workload):
    be = _be(workload, population=4, seed=0)
    trials = [_trial(workload.default_space(), i, budget=20) for i in range(4)]
    results = be.evaluate(trials)
    assert [r.trial_id for r in results] == [0, 1, 2, 3]
    assert all(r.ok and 0.0 <= r.score <= 1.0 for r in results)


def test_mixed_budget_batch(workload):
    """A promoted trial (20 remaining) and a fresh one (10) in one batch."""
    be = _be(workload, population=4, seed=1)
    space = workload.default_space()
    a = _trial(space, 10, budget=10)
    be.evaluate([a])
    assert be._trained[10] == 10
    a.budget = 30
    b = _trial(space, 11, budget=10)
    results = be.evaluate([a, b])
    assert be._trained[10] == 30 and be._trained[11] == 10
    assert {r.trial_id for r in results} == {10, 11}
    assert be._pool.step[be._slot_of[10]].item() == 30  # frozen steps never counted
    assert be._pool.step[be._slot_of[11]].item() == 10


def test_warm_resume_equals_continuous_training(workload, monkeypatch):
    """40 + 40 steps in two batches end in the member one batch of 80
    steps gives, bit for bit, when both runs read one stream of batch and
    augmentation draws (the backend seeds each batch's generator afresh,
    so the stream is shared here by replacing the draw functions)."""
    real_batch, real_aug = tpop.draw_batch, tpop.draw_augment
    space = workload.default_space()
    states = []
    for budgets in ((40, 80), (80,)):
        shared = torch.Generator().manual_seed(123)
        monkeypatch.setattr(tpop, "draw_batch", lambda g, n, b: real_batch(shared, n, b))
        monkeypatch.setattr(tpop, "draw_augment", lambda g, f, s_, b: real_aug(shared, f, s_, b))
        be = _be(workload, population=2, seed=2)
        t = _trial(space, 20, budget=0, seed=5)
        for b in budgets:
            t.budget = b
            (r,) = be.evaluate([t])
        assert be._trained[20] == 80 and be._pool.step[be._slot_of[20]].item() == 80
        states.append((r.score, {k: v[be._slot_of[20]] for k, v in be._pool.params.items()}))
    assert states[0][0] == states[1][0]
    for k in states[0][1]:
        assert torch.equal(states[0][1][k], states[1][1][k]), k


def test_pbt_inheritance_gathers_weights(workload):
    be = _be(workload, population=2, seed=3)
    space = workload.default_space()
    parent = _trial(space, 30, budget=60, seed=7, __inherit_from__=None, __slot__=0)
    rp = be.evaluate([parent])[0]
    # the child inherits the trained weights and trains 0 more steps
    child = _trial(space, 31, budget=60, seed=8, __inherit_from__=30, __slot__=0)
    rc = be.evaluate([child])[0]
    assert rc.score == rp.score
    for k, v in be._pool.params.items():
        assert torch.equal(v[be._slot_of[31]], v[be._slot_of[30]]), k


def test_eviction_falls_back_to_retrain(workload):
    be = _be(workload, population=2, seed=4)
    space = workload.default_space()
    trials = [_trial(space, 40 + i, budget=15, seed=i) for i in range(6)]
    for t in trials:
        be.evaluate([t])
    assert len(be._slot_of) <= 4
    assert 40 not in be._slot_of  # the least recently used went first
    t0 = trials[0]
    t0.budget = 30
    r = be.evaluate([t0])[0]
    assert be._trained[40] == 30 and be._pool.step[be._slot_of[40]].item() == 30
    assert 0.0 <= r.score <= 1.0


def test_batch_pressure_cannot_evict_in_batch_sources(workload):
    """Fresh trials filling the pool in the same batch as a warm resume
    must not evict the resume's source slot mid-plan."""
    be = _be(workload, population=4, seed=11)
    space = workload.default_space()
    warm = _trial(space, 60, budget=20, seed=1)
    be.evaluate([warm])
    for f in [_trial(space, 70 + i, budget=10, seed=i) for i in range(7)]:
        be.evaluate([f])
    slot = be._slot_of[60]
    warm.budget = 40
    batch = [warm] + [_trial(space, 80 + i, budget=10, seed=i) for i in range(3)]
    results = be.evaluate(batch)
    assert be._trained[60] == 40 and results[0].trial_id == 60
    assert be._slot_of[60] == slot and be._pool.step[slot].item() == 40  # stayed warm


def test_full_search_pbt_on_gpu_backend(workload):
    algo = PBT(workload.default_space(), seed=9, population=8, generations=3, steps_per_generation=25)
    res = run_search(algo, _be(workload, population=8, seed=9))
    assert res.n_trials == 24 and res.best.score > 0.3


def test_full_search_asha_on_gpu_backend(workload):
    algo = ASHA(workload.default_space(), seed=10, max_trials=12, min_budget=10, max_budget=90, eta=3)
    res = run_search(algo, _be(workload, population=8, seed=10))
    assert res.n_trials == 12 and res.best.score > 0.3


def test_reset_is_bit_identical_to_fresh_backend(workload):
    space = workload.default_space()
    first = [_trial(space, i, budget=15, seed=100 + i) for i in range(3)]
    second = [_trial(space, i, budget=15, seed=200 + i) for i in range(3)]
    be = _be(workload, population=4, seed=6)
    be.evaluate(first)
    be.reset()
    assert not be._slot_of and not be._trained and be._step_counter == 0
    r_reused = be.evaluate(second)
    assert all(be._trained[t.trial_id] == 15 for t in second)
    r_fresh = _be(workload, population=4, seed=6).evaluate(second)
    assert [r.score for r in r_reused] == [r.score for r in r_fresh]
    # the hazard reset() exists for: a repeated id warm-resumes at rem 0
    r_a = be.evaluate([_trial(space, 0, budget=15, seed=300)])[0]
    r_b = be.evaluate([_trial(space, 0, budget=15, seed=301)])[0]
    assert r_a.score == r_b.score


def test_one_launch_width_whatever_the_padding(workload):
    """The same batch on a pool of 4 and of 8 (launches of 4 and 8
    members, the batch of 3 padded differently) gives the same scores."""
    space = workload.default_space()
    trials = [_trial(space, i, budget=12, seed=50 + i) for i in range(3)]
    a = _be(workload, population=4, seed=8).evaluate(trials)
    b = _be(workload, population=8, seed=8).evaluate(trials)
    assert [r.score for r in a] == [r.score for r in b]
    assert _be(workload, population=8, member_chunk=2).launch_width == 2


def _poison_first(be, monkeypatch, every=False):
    be._setup()
    real = be._trainer.eval_population
    calls = {"n": 0}

    def poisoned(*a, **k):
        calls["n"] += 1
        scores = real(*a, **k).clone()
        if every or calls["n"] == 1:
            scores[0] = float("nan")
        return scores

    monkeypatch.setattr(be._trainer, "eval_population", poisoned)


def test_nonfinite_score_reports_failed_result(workload, monkeypatch):
    be = _be(workload, population=4, seed=5)
    trials = [_trial(workload.default_space(), 50 + i, budget=5, seed=5) for i in range(3)]
    _poison_first(be, monkeypatch, every=True)
    results = be.evaluate(trials)
    assert results[0].status == "failed" and np.isnan(results[0].score)
    assert "diverged" in results[0].error
    assert all(r.ok and 0.0 <= r.score <= 1.0 for r in results[1:])


def test_failed_trial_evicted_so_retry_retrains(workload, monkeypatch):
    be = _be(workload, population=4, seed=6)
    t = _trial(workload.default_space(), 60, budget=5, seed=6)
    _poison_first(be, monkeypatch)
    (r1,) = be.evaluate([t])
    assert r1.status == "failed"
    assert 60 not in be._trained and 60 not in be._slot_of
    (r2,) = be.evaluate([t])
    assert r2.ok and be._trained[60] == 5


def test_no_cuda_no_fallback(workload):
    if torch.cuda.is_available():
        pytest.skip("the refusal is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_backend("gpu", workload)
    # mesh= is ported: the slot pool rounds up to the 'pop' axis (a pool
    # it does not divide would be replicated on every rank)
    from mpi_opt_tpu_torch.parallel.mesh import Mesh

    assert get_backend("gpu", workload, mesh=Mesh(2, rank=0, world=2), device="cpu").pool_size == 66
    assert get_backend("gpu", workload, mesh=Mesh(1), device="cpu").pool_size == 65
    with pytest.raises(ValueError, match="population protocol"):
        get_backend("gpu", object(), device="cpu")

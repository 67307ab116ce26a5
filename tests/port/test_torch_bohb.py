"""Fused BOHB in the port against the JAX package's, and its own
invariants on the CPU.

- ``ObsStore`` and ``default_n_min`` equal the JAX package's, record
  for record on one fed sequence (ring wrap, NaN and +/-inf dropped,
  the qualified budget after every add).
- A whole ``fused_bohb`` on fashion_mlp at R=3, eta 3, n_min 3 and no
  random fraction against the JAX sweep (four XLA compiles): the
  bracket plan, rung sizes and budgets, ``n_model_sampled`` (0, then
  the whole bracket), ledger records with the JAX keys and the same (boundary, size, trial
  id, step) sequence across the brackets, accepted by the JAX ledger
  reader.
- The port alone, at R=9: waves of 3 equal resident; a crash between
  brackets resumes to the unkilled records through the persisted
  cohorts; a persisted cohort is reused, and one of another sweep is
  refused; ``fused_sha``'s snapshot refuses another ``init_unit``.
"""

import json
import math
import os

import numpy as np
import pytest

import mpi_opt_tpu.ledger.store as jstore
from mpi_opt_tpu.algorithms.bohb import ObsStore as JaxObsStore
from mpi_opt_tpu.algorithms.bohb import default_n_min as jax_default_n_min
from mpi_opt_tpu.train.fused_bohb import fused_bohb as jax_fused_bohb
from mpi_opt_tpu.workloads import get_workload as jax_get_workload
from mpi_opt_tpu_torch import cli, get_workload
from mpi_opt_tpu_torch.algorithms.bohb import ObsStore, default_n_min
from mpi_opt_tpu_torch.ledger import SweepLedger, validate_ledger
from mpi_opt_tpu_torch.train import fused_asha
from mpi_opt_tpu_torch.train.fused_bohb import fused_bohb
from mpi_opt_tpu_torch.utils import resources

HB = dict(max_budget=9, eta=3, seed=0)
# the sweep held against the JAX package's: two brackets, (3 at 1) and
# (2 at 3); budget 1's three observations qualify a model at n_min 3,
# and with no random fraction it draws the whole of bracket 1
HB_JAX = dict(max_budget=3, eta=3, seed=0, n_min=3, random_fraction=0.0)
FIELDS = ("trial_id", "member", "boundary", "boundary_size", "params", "status", "score", "step")
SHAPE = ("boundary", "boundary_size", "trial_id", "step")


@pytest.mark.parametrize("dim", [1, 3, 5])
def test_default_n_min_equals_jax(dim):
    assert default_n_min(dim) == jax_default_n_min(dim) == dim + 3


def _rings(store):
    """A store's rings in the JAX ``ObsStore.to_jsonable`` form."""
    return {str(b): {"unit": r["unit"].tolist(), "score": r["score"].tolist(),
                     "valid": r["valid"].tolist(), "n": r["n"]} for b, r in store.budgets.items()}


def test_obs_store_equals_jax_record_for_record():
    rng = np.random.default_rng(0)
    dim, size, n_min = 2, 4, 3
    ours, theirs = ObsStore(dim, size, n_min), JaxObsStore(dim, size, n_min)
    scores = list(rng.uniform(size=14)) + [math.nan, math.inf, -math.inf]
    budgets = [1, 3, 1, 9, 1, 3, 1, 1, 3, 9, 3, 1, 9, 3, 1, 3, 9]
    for budget, score in zip(budgets, scores):
        unit = rng.uniform(size=dim).astype(np.float32)
        ours.add(budget, unit, score)
        theirs.add(budget, unit, score)
        assert ours.model_budget() == theirs.model_budget()
        assert _rings(ours) == theirs.to_jsonable()
    # 7 observations at budget 1 (the NaN dropped) wrapped the ring of 4
    assert ours.budgets[1]["n"] == 6 and ours.budgets[1]["valid"].all()
    assert ours.budgets[9]["n"] == 3  # -inf dropped: n_min reached, the highest budget wins
    assert ours.model_budget() == 9


def _header(space, seed=0):
    return {"mode": "fused", "granularity": "rung", "algorithm": "bohb", "seed": seed,
            "space_hash": space.space_hash()}


def _recs(path):
    with open(path) as f:
        return [json.loads(x) for x in f.read().splitlines()[1:]]


def _pick(path):
    return [{k: r[k] for k in FIELDS} for r in _recs(path)]


def _workload():
    return get_workload("fashion_mlp", n_train=256, n_val=128)


def _run(path=None, **kw):
    wl = _workload()
    led = None
    if path is not None:
        led = SweepLedger(str(path))
        led.ensure_header(_header(wl.default_space()))
    try:
        return fused_bohb(wl, ledger=led, device="cpu", **{**HB, **kw})
    finally:
        if led is not None:
            led.close()


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_bohb")
    wl = jax_get_workload("fashion_mlp", n_train=256, n_val=128)
    led = jstore.SweepLedger(str(d / "jax.jsonl"))
    led.ensure_header(_header(wl.default_space()))
    try:
        res = jax_fused_bohb(wl, ledger=led, **HB_JAX)
    finally:
        led.close()
    return res, d / "jax.jsonl"


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_bohb")
    return _run(d / "port.jsonl", **HB_JAX), d / "port.jsonl"


def test_brackets_equal_jax_in_structure(jax_run, port_run):
    want, got = jax_run[0], port_run[0]
    assert set(got) == set(want)
    strip = lambda s: {k: v for k, v in s.items() if k not in ("best_score", "member_failures")}
    assert [strip(s) for s in got["brackets"]] == [strip(s) for s in want["brackets"]]
    assert [(s["n_trials"], s["rung_sizes"], s["rung_budgets"]) for s in got["brackets"]] == [
        (3, [3, 1], [1, 3]), (2, [2], [3])]
    # bracket 0 is uniform (no budget qualifies yet); then the model draws
    assert [s["n_model_sampled"] for s in got["brackets"]] == [0, 2]
    assert got["journal"] == want["journal"] == {"written": 6, "verified": 0}
    assert got["n_trials"] == want["n_trials"] == 5


def test_one_ledger_spans_the_brackets_as_jax(jax_run, port_run):
    j_recs, t_recs = _recs(jax_run[1]), _recs(port_run[1])
    assert [set(r) for r in t_recs] == [set(r) for r in j_recs]
    shape = lambda rs: [tuple(r[k] for k in SHAPE) for r in rs]
    assert shape(t_recs) == shape(j_recs)
    assert sorted({r["boundary"] for r in t_recs}) == list(range(3))
    assert jstore.validate_ledger(str(port_run[1])) == []
    assert validate_ledger(str(port_run[1])) == []


def test_waves_of_3_equal_resident(tmp_path):
    res = _run(tmp_path / "resident.jsonl", n_min=4)
    wav = _run(tmp_path / "waves.jsonl", n_min=4, wave_size=3)
    assert [s["n_model_sampled"] > 0 for s in res["brackets"]] == [False, True, True]
    assert [s["n_model_sampled"] for s in wav["brackets"]] == [
        s["n_model_sampled"] for s in res["brackets"]]
    assert (wav["best_score"], wav["best_params"]) == (res["best_score"], res["best_params"])
    assert _pick(tmp_path / "waves.jsonl") == _pick(tmp_path / "resident.jsonl")
    assert wav["wave_size"] == 3 and wav["waves_run"] > 0


def test_cli_crash_between_brackets_resumes_to_the_unkilled_records(tmp_path, capsys, monkeypatch):
    """A crash at bracket 1's end: the persisted cohorts and snapshots
    bring ``--resume`` to the unkilled run's records and summary."""
    real = cli.get_workload
    monkeypatch.setattr(cli, "get_workload", lambda name: real(name, n_train=256, n_val=128))

    def argv(name, *extra):
        return ["--workload", "fashion_mlp", "--algorithm", "bohb", "--fused", "--max-budget", "9",
                "--eta", "3", "--seed", "0", "--device", "cpu",
                "--ledger", str(tmp_path / f"{name}.jsonl"), *extra]

    def run(args):
        rc = cli.main(args)
        return rc, [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]

    rc, lines = run(argv("whole"))
    assert rc == 0
    want = lines[-1]
    with open(tmp_path / "whole.jsonl") as f:
        config = json.loads(f.readline())["config"]
    config = json.loads(config) if isinstance(config, str) else config
    assert (config["algorithm"], config["granularity"], config["max_budget"], config["eta"]) == (
        "bohb", "rung", 9, 3)

    def crash(stage):
        if stage == "hyperband bracket 1/3":
            raise RuntimeError("simulated crash")

    cut = argv("cut", "--checkpoint-dir", str(tmp_path / "ck"))
    resources.set_boundary_fault_injector(crash)
    try:
        with pytest.raises(RuntimeError, match="simulated"):
            cli.main(cut)
    finally:
        resources.set_boundary_fault_injector(None)
    capsys.readouterr()
    assert sorted(os.listdir(tmp_path / "ck")) == ["bracket_0", "cohort_0.npz"]
    rc, lines = run(cut + ["--resume"])
    assert rc == 0
    got = lines[-1]
    for k in ("best_score", "best_params", "brackets", "member_failures", "n_trials"):
        assert got[k] == want[k], k
    assert _pick(tmp_path / "cut.jsonl") == _pick(tmp_path / "whole.jsonl")


def test_a_persisted_cohort_of_another_sweep_is_refused(tmp_path):
    ck = tmp_path / "ck"
    ck.mkdir()
    np.savez(ck / "cohort_0.npz", cohort=np.zeros((9, 5), np.float32), n_model=0,
             tag=np.asarray("fashion_mlp|R=9|eta=3|seed=1"))
    with pytest.raises(ValueError, match="persisted cohort for bracket 0 is from a different sweep"):
        _run(checkpoint_dir=str(ck))


def test_a_persisted_cohort_is_reused(tmp_path):
    calls = []

    def cohort_fn(b, n):
        calls.append(b)
        return np.full((n, 2), 0.5, np.float32), 1

    ck = str(tmp_path / "ck")
    tag = "wl|R=9|eta=3|seed=0"
    a = fused_asha._bracket_cohort(ck, 0, 4, tag, cohort_fn)
    b = fused_asha._bracket_cohort(ck, 0, 4, tag, cohort_fn)
    assert calls == [0] and b[1] == 1 and np.array_equal(a[0], b[0])
    with pytest.raises(ValueError, match="different sweep"):
        fused_asha._bracket_cohort(ck, 0, 5, tag, cohort_fn)


def test_sha_snapshot_refuses_another_init_unit(tmp_path):
    wl = _workload()
    kw = dict(n_trials=4, min_budget=1, max_budget=3, eta=3, seed=0, device="cpu",
              checkpoint_dir=str(tmp_path / "ck"))
    unit = np.random.default_rng(0).uniform(size=(4, 5)).astype(np.float32)
    res = fused_asha.fused_sha(wl, init_unit=unit, **kw)
    np.testing.assert_array_equal(np.asarray([res["rung_history"][0]["trials"]]), [[0, 1, 2, 3]])
    with pytest.raises(ValueError, match="init_unit_digest"):
        fused_asha.fused_sha(wl, init_unit=unit[::-1].copy(), **kw)
    with pytest.raises(ValueError, match="init_unit shape"):
        fused_asha.fused_sha(wl, init_unit=unit[:3], **{**kw, "checkpoint_dir": None})


def _world_of_one():
    from mpi_opt_tpu_torch.parallel.mesh import Mesh

    return Mesh(1)


@pytest.mark.parametrize("arg,value", [("mesh", _world_of_one()), ("round_to", 2)])
def test_not_ported_arguments_raise(arg, value):
    # mesh= and round_to= are ported: a 1 x 1 mesh runs the one-process
    # sweep, and round_to rounds every rung after the first up to a
    # multiple, as the JAX package's sha_cohort_sizes does
    got = fused_bohb(_workload(), device="cpu", **{**HB, arg: value})
    want = fused_bohb(_workload(), device="cpu", **HB)
    if arg == "mesh":
        assert got["brackets"] == want["brackets"]
        assert got["best_score"] == want["best_score"]
    else:
        from mpi_opt_tpu.train.fused_asha import sha_cohort_sizes as jax_sizes

        for b in got["brackets"]:
            sizes = b["rung_sizes"]
            assert sizes == jax_sizes(sizes[0], len(sizes), HB["eta"], value)
            assert all(s % value == 0 for s in sizes[1:] if s > 1) or sizes[1:] == []

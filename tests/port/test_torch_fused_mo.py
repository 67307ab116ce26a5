"""Multi-objective fused sweeps of the port, against the JAX package's and
against the reference's own invariants (mirrors ``tests/test_fused_mo.py``).

- The journal: ``FusedJournal`` records with objective vectors are
  record-identical to the JAX journal's on the same inputs (a vector
  with a non-finite objective journals ``failed`` with null score and
  vector); a re-computed boundary whose vector diverges is refused, and
  a scalar sweep's ledger holds no multi-objective key.
- Whole sweeps: ``fused_pbt``/``fused_sha`` with objectives on
  ``digits_mlp`` at the JAX tests' shape (6 members, 3 x 4; SHA budgets
  2 -> 8 at eta 2) against the JAX sweeps in structure: result and
  ``pareto`` keys, record fields and sequences, rung sizes, fronts whose
  size, members and vectors agree with each other and with the final
  records. The random streams differ, so scores are not compared.
- The invariants: a gen-chunk split is bit-identical; a crashed sweep
  resumes to the unkilled run's records, vectors included; a snapshot
  of a multi-objective sweep refuses a scalar resume; a resume under
  other objectives catches the diverged vector in the journal.
- The refusals the JAX package keeps (waves, ``step_chunk``, metrics the
  workload lacks), and the CLI's ``--objectives``: its usage errors, the
  header, the summary fields and the ``pareto_front`` and
  ``objective_degraded`` events.
"""

import json

import numpy as np
import pytest
import torch

import mpi_opt_tpu.ledger.fused as jfused
import mpi_opt_tpu.ledger.store as jstore
import mpi_opt_tpu.train.fused_asha as jfa
import mpi_opt_tpu.train.fused_pbt as jfp
import mpi_opt_tpu_torch.cli as cli
import mpi_opt_tpu_torch.ledger.fused as tfused
import mpi_opt_tpu_torch.ledger.store as tstore
import mpi_opt_tpu_torch.train.fused_pbt as fp
from mpi_opt_tpu.ledger.report import summarize_ledger
from mpi_opt_tpu.objectives import ObjectiveSpec as JaxSpec
from mpi_opt_tpu.workloads import get_workload as jax_get_workload
from mpi_opt_tpu_torch import get_workload
from mpi_opt_tpu_torch.objectives import ObjectiveSpec
from mpi_opt_tpu_torch.train.fused_asha import fused_sha

TEXT = "accuracy:max,params:min"
SPEC = ObjectiveSpec.parse(TEXT)
KW = dict(population=6, generations=3, steps_per_gen=4, seed=3, gen_chunk=1, device="cpu")
SHA_KW = dict(n_trials=6, min_budget=2, max_budget=8, eta=2, seed=3)
FIELDS = ("trial_id", "member", "boundary", "boundary_size", "params", "status", "score", "scores",
          "step")
VOLATILE = {"ts", "sweep_id", "created_ts"}
PARETO_KEYS = {"front_size", "front_members", "front_scores", "hypervolume", "selection", "violation"}


@pytest.fixture(scope="module")
def wl():
    return get_workload("digits_mlp")


def _header(space, algorithm="pbt", objectives=TEXT):
    cfg = {"mode": "fused", "granularity": "generation" if algorithm == "pbt" else "rung",
           "algorithm": algorithm, "workload": "digits_mlp", "seed": 3,
           "space_hash": space.space_hash()}
    if objectives:
        cfg["objectives"] = objectives
    return cfg


def _ledger(store, path, space, algorithm="pbt", spec=SPEC):
    led = store.SweepLedger(str(path))
    led.ensure_header(_header(space, algorithm, None if spec is None else TEXT),
                      space_spec=space.spec(), objective_spec=None if spec is None else spec.spec())
    return led


def _lines(path):
    return [json.loads(x) for x in open(path).read().splitlines()]


def _records(path):
    return [{k: r.get(k) for k in FIELDS} for r in _lines(path)[1:]]


# -- the journal ---------------------------------------------------------------


class _RowsView:
    """A package's search space, with rows materialised by the port's map
    (the two maps agree within one f32 ulp; the journal is under test)."""

    def __init__(self, space, rows_from):
        self.canonical_params = space.canonical_params
        self.materialize_row = rows_from.materialize_row
        self.space_hash = space.space_hash
        self.spec = space.spec


def _write_mo_boundaries(journal, units):
    mo0 = np.array([[0.5, 2300.0], [0.75, np.nan], [0.625, 2351.0]])
    mo1 = np.array([[0.8125, 2290.0], [0.25, np.inf], [0.875, 2402.0]])
    journal.record_boundary(0, [0, 1, 2], units[0], mo0[:, 0], step=4, scores_mo=mo0)
    journal.record_boundary(1, [0, 1, 2], units[1], mo1[:, 0], step=8, scores_mo=mo1)


def test_mo_journal_records_equal_jax(tmp_path, wl):
    t_space = wl.default_space()
    j_space = jax_get_workload("digits_mlp").default_space()
    units = np.random.default_rng(3).random((2, 3, t_space.dim), dtype=np.float32)
    jl = _ledger(jstore, tmp_path / "jax.jsonl", _RowsView(j_space, t_space), spec=JaxSpec.parse(TEXT))
    tl = _ledger(tstore, tmp_path / "port.jsonl", _RowsView(t_space, t_space))
    jj = jfused.FusedJournal(jl, _RowsView(j_space, t_space))
    tj = tfused.FusedJournal(tl, _RowsView(t_space, t_space))
    _write_mo_boundaries(jj, units)
    _write_mo_boundaries(tj, units)
    jl.close()
    tl.close()
    j_recs, t_recs = _lines(tmp_path / "jax.jsonl"), _lines(tmp_path / "port.jsonl")
    assert len(t_recs) == len(j_recs) == 7
    for a, b in zip(t_recs, j_recs):
        assert list(a) == list(b)  # same keys, same order: the header too
        assert {k: v for k, v in a.items() if k not in VOLATILE} == {
            k: v for k, v in b.items() if k not in VOLATILE}
    assert t_recs[0]["objective_spec"] == SPEC.spec()
    assert t_recs[1]["scores"] == [0.5, 2300.0] and t_recs[1]["score"] == 0.5
    assert t_recs[2]["status"] == "failed" and t_recs[2]["scores"] is None and t_recs[2]["score"] is None
    assert t_recs[5]["status"] == "failed"  # an inf objective fails the record too
    assert jstore.validate_ledger(str(tmp_path / "port.jsonl")) == []


def test_resume_verify_catches_a_diverged_vector(tmp_path, wl):
    space = wl.default_space()
    led = _ledger(tstore, tmp_path / "v.jsonl", space)
    units = np.random.default_rng(0).random((2, 3, space.dim), dtype=np.float32)
    _write_mo_boundaries(tfused.FusedJournal(led, space), units)
    led.close()
    led = tstore.SweepLedger(str(tmp_path / "v.jsonl"))
    j2 = tfused.FusedJournal(led, space)
    _write_mo_boundaries(j2, units)  # the same re-computation verifies
    assert (j2.written, j2.verified) == (0, 6)
    bad = np.array([[0.5, 2300.0], [0.75, np.nan], [0.625, 2999.0]])  # the scalars agree
    with pytest.raises(tstore.LedgerError, match="objective vector"):
        j2.record_boundary(0, [0, 1, 2], units[0], bad[:, 0], step=4, scores_mo=bad)
    led.close()


def test_scalar_sweep_ledger_carries_no_mo_keys(tmp_path, wl):
    led = _ledger(tstore, tmp_path / "scalar.jsonl", wl.default_space(), spec=None)
    res = fp.fused_pbt(wl, ledger=led, **KW)
    led.close()
    lines = _lines(tmp_path / "scalar.jsonl")
    assert "objective_spec" not in lines[0] and "objectives" not in lines[0]["config"]
    assert all("scores" not in r for r in lines[1:])
    assert res["objectives"] is None and res["pareto"] is None


# -- whole sweeps against the JAX package's -----------------------------------


def _front_consistent(res, spec_m=2):
    p = res["pareto"]
    assert set(p) == PARETO_KEYS
    assert p["front_size"] == len(p["front_members"]) == len(p["front_scores"]) >= 1
    assert all(len(v) == spec_m for v in p["front_scores"])
    assert p["selection"] == "feasible" and p["violation"] == 0.0 and p["hypervolume"] >= 0.0
    return p


@pytest.fixture(scope="module")
def jax_pbt(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_pbt")
    jwl = jax_get_workload("digits_mlp")
    led = _ledger(jstore, d / "jax.jsonl", jwl.default_space(), spec=JaxSpec.parse(TEXT))
    kw = {k: v for k, v in KW.items() if k != "device"}
    try:
        res = jfp.fused_pbt(jwl, ledger=led, objectives=JaxSpec.parse(TEXT), **kw)
    finally:
        led.close()
    return res, _lines(d / "jax.jsonl")


def test_mo_pbt_structure_matches_jax(tmp_path, wl, jax_pbt):
    want, j_lines = jax_pbt
    led = _ledger(tstore, tmp_path / "port.jsonl", wl.default_space())
    got = fp.fused_pbt(wl, ledger=led, objectives=SPEC, **KW)
    led.close()
    t_lines = _lines(tmp_path / "port.jsonl")
    assert set(got) == set(want)
    assert got["objectives"] == want["objectives"] == ["accuracy", "params"]
    p, jp_ = _front_consistent(got), _front_consistent(want)
    assert set(p) == set(jp_)
    assert got["journal"] == want["journal"] == {"written": 18, "verified": 0}
    assert {k: v for k, v in t_lines[0].items() if k not in VOLATILE} == {
        k: v for k, v in j_lines[0].items() if k not in VOLATILE}
    shape = lambda rs: [(r["boundary"], r["boundary_size"], r["trial_id"], r["member"], r["step"])
                        for r in rs]
    assert shape(t_lines[1:]) == shape(j_lines[1:])
    assert [set(r) for r in t_lines[1:]] == [set(r) for r in j_lines[1:]]
    for r in t_lines[1:]:
        assert r["status"] == "ok" and len(r["scores"]) == 2 and r["score"] == r["scores"][0]
    # the JAX package's report reads the port's vectors into a front
    rep = summarize_ledger(str(tmp_path / "port.jsonl"))["multi_objective"]
    assert [o["name"] for o in rep["objectives"]] == ["accuracy", "params"]
    assert rep["evaluated"] == KW["population"] and rep["front_size"] >= 1
    # the front is the final population's: its vectors are members' vectors
    assert max(v[0] for v in p["front_scores"]) == got["best_score"]  # unconstrained: the best primary
    assert jstore.validate_ledger(str(tmp_path / "port.jsonl")) == []


def test_mo_sha_structure_matches_jax(tmp_path, wl):
    jwl = jax_get_workload("digits_mlp")
    jled = _ledger(jstore, tmp_path / "jax.jsonl", jwl.default_space(), "asha", JaxSpec.parse(TEXT))
    try:
        want = jfa.fused_sha(jwl, ledger=jled, objectives=JaxSpec.parse(TEXT), **SHA_KW)
    finally:
        jled.close()
    tled = _ledger(tstore, tmp_path / "port.jsonl", wl.default_space(), "asha")
    got = fused_sha(wl, ledger=tled, objectives=SPEC, device="cpu", **SHA_KW)
    tled.close()
    assert set(got) == set(want)
    assert got["rung_sizes"] == want["rung_sizes"] == [6, 3, 2]
    assert got["objectives"] == want["objectives"]
    p = _front_consistent(got)
    _front_consistent(want)
    assert set(p["front_members"]) <= set(got["rung_history"][-1]["trials"])
    j_recs, t_recs = _lines(tmp_path / "jax.jsonl")[1:], _lines(tmp_path / "port.jsonl")[1:]
    assert [set(r) for r in t_recs] == [set(r) for r in j_recs]
    shape = lambda rs: [(r["boundary"], r["boundary_size"], r["trial_id"], r["step"]) for r in rs]
    assert shape(t_recs) == shape(j_recs) and len(t_recs) == 6 + 3 + 2
    last = {r["member"]: r["scores"] for r in t_recs if r["boundary"] == 2}
    assert [last[m] for m in p["front_members"]] == p["front_scores"]
    assert got["best_trial"] in p["front_members"]
    # the deferred sweep (no ledger, no snapshot) reads the same front
    again = fused_sha(wl, objectives=SPEC, device="cpu", **SHA_KW)
    assert again["pareto"] == got["pareto"] and again["best_trial"] == got["best_trial"]


# -- the reference's invariants -------------------------------------------------


def _same(a, b):
    np.testing.assert_array_equal(a["unit"], b["unit"])
    np.testing.assert_array_equal(a["best_curve"], b["best_curve"])
    assert a["pareto"] == b["pareto"] and a["best_score"] == b["best_score"]
    for k, v in a["state"].params.items():
        assert torch.equal(b["state"].params[k], v), k


def test_gen_chunk_split_is_bit_identical(wl):
    whole = fp.fused_pbt(wl, objectives=SPEC, **dict(KW, gen_chunk=0))
    for chunk in (1, 2):
        _same(fp.fused_pbt(wl, objectives=SPEC, **dict(KW, gen_chunk=chunk)), whole)


def test_crash_resume_is_record_identical(tmp_path, wl, monkeypatch):
    space = wl.default_space()
    clean = _ledger(tstore, tmp_path / "clean.jsonl", space)
    whole = fp.fused_pbt(wl, ledger=clean, objectives=SPEC, **KW)
    clean.close()
    real, calls = fp._run_stepped_generation, {"n": 0}

    def crashing(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:  # after two journaled, snapshotted launches
            raise RuntimeError("simulated crash")
        return real(*a, **k)

    ckpt = str(tmp_path / "ck")
    led = _ledger(tstore, tmp_path / "killed.jsonl", space)
    monkeypatch.setattr(fp, "_run_stepped_generation", crashing)
    with pytest.raises(RuntimeError, match="simulated"):
        fp.fused_pbt(wl, checkpoint_dir=ckpt, ledger=led, objectives=SPEC, **KW)
    led.close()
    monkeypatch.setattr(fp, "_run_stepped_generation", real)
    led = tstore.SweepLedger(str(tmp_path / "killed.jsonl"))
    resumed = fp.fused_pbt(wl, checkpoint_dir=ckpt, ledger=led, objectives=SPEC, **KW)
    led.close()
    assert _records(tmp_path / "killed.jsonl") == _records(tmp_path / "clean.jsonl")
    assert resumed["journal"] == {"written": 6, "verified": 0}
    _same(resumed, whole)


def test_mo_snapshot_refuses_a_scalar_resume(tmp_path, wl):
    ckpt = str(tmp_path / "ck")
    fp.fused_pbt(wl, checkpoint_dir=ckpt, objectives=SPEC, **KW)
    with pytest.raises(ValueError, match="objectives"):
        fp.fused_pbt(wl, checkpoint_dir=ckpt, **KW)
    ckpt = str(tmp_path / "sha")
    fused_sha(wl, checkpoint_dir=ckpt, objectives=SPEC, device="cpu", **SHA_KW)
    with pytest.raises(ValueError, match="objectives"):
        fused_sha(wl, checkpoint_dir=ckpt, device="cpu", **SHA_KW)


def test_a_resume_under_other_objectives_catches_the_vector(tmp_path, wl):
    """The journal of an accuracy/params sweep, re-computed under
    accuracy/latency: the scalar scores agree, the vectors do not."""
    space = wl.default_space()
    led = _ledger(tstore, tmp_path / "l.jsonl", space)
    fp.fused_pbt(wl, ledger=led, objectives=SPEC, **KW)
    led.close()
    led = tstore.SweepLedger(str(tmp_path / "l.jsonl"))
    try:
        with pytest.raises(tstore.LedgerError, match="objective vector"):
            fp.fused_pbt(wl, ledger=led, objectives=ObjectiveSpec.parse("accuracy:max,latency:min"),
                         **KW)
    finally:
        led.close()


@pytest.mark.parametrize("kw,match", [
    ({"step_chunk": 2}, "step_chunk is not supported"),
    ({"wave_size": 3, "gen_chunk": 0}, "wave scheduling is not supported"),
    ({"objectives": ObjectiveSpec.parse("accuracy,flops:min")}, r"cannot evaluate objectives \['flops'\]"),
])
def test_fused_pbt_refusals(wl, kw, match):
    with pytest.raises(ValueError, match=match):
        fp.fused_pbt(wl, **{"objectives": SPEC, **KW, **kw})


def test_fused_sha_refuses_waves(wl):
    with pytest.raises(ValueError, match="wave scheduling is not supported"):
        fused_sha(wl, objectives=SPEC, device="cpu", wave_size=3, **SHA_KW)


def test_constrained_sweep_degrades_to_least_violation(wl):
    spec = ObjectiveSpec.parse("accuracy:max,params:min<=1")
    res = fp.fused_pbt(wl, objectives=spec, **KW)
    p = res["pareto"]
    assert p["selection"] == "least_violation" and p["violation"] > 0
    assert not res["diverged"] and res["best_params"] is not None


# -- the CLI --------------------------------------------------------------------


def _argv(tmp_path, *extra, algorithm="pbt"):
    return ["--workload", "digits_mlp", "--algorithm", algorithm, "--fused", "--population", "6",
            "--generations", "3", "--steps-per-generation", "4", "--gen-chunk", "1",
            "--trials", "6", "--min-budget", "2", "--max-budget", "8", "--eta", "2",
            "--seed", "3", "--device", "cpu", "--metrics-file", str(tmp_path / "m.jsonl"),
            "--checkpoint-dir", str(tmp_path / "ck"), "--ledger", str(tmp_path / "l.jsonl"), *extra]


def _run(argv, capsys):
    rc = cli.main(argv)
    out = capsys.readouterr()
    return rc, [json.loads(x) for x in out.out.splitlines() if x.startswith("{")], out.err


@pytest.mark.parametrize("extra,message", [
    (["--wave-size", "3"], "--objectives is not supported with --wave-size"),
    (["--step-chunk", "2"], "--objectives is not supported with --step-chunk"),
    (["--objectives", "accuracy,flops:min"], "cannot evaluate objectives ['flops']"),
    (["--objectives", "accuracy:max<=0.5"], "contradicts direction"),
    (["--algorithm", "tpe"], "requires --fused --algorithm pbt|asha"),
    (["--algorithm", "hyperband"], "requires --fused --algorithm pbt|asha"),
])
def test_cli_objectives_usage_errors(tmp_path, extra, message, capsys):
    argv = _argv(tmp_path, "--objectives", TEXT, *extra)
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("algorithm", ["pbt", "asha"])
def test_cli_summary_header_and_events(tmp_path, algorithm, capsys):
    rc, lines, _ = _run(_argv(tmp_path, "--objectives", TEXT, "--trace", algorithm=algorithm), capsys)
    assert rc == 0
    summary = lines[-1]
    assert summary["objectives"] == ["accuracy", "params"]
    assert set(summary["pareto"]) == PARETO_KEYS and summary["pareto"]["selection"] == "feasible"
    header = _lines(tmp_path / "l.jsonl")[0]
    assert header["config"]["objectives"] == TEXT and header["objective_spec"] == SPEC.spec()
    events = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
    front = [e for e in events if e.get("event") == "pareto_front"]
    assert len(front) == 1 and front[0]["front_size"] == summary["pareto"]["front_size"]
    assert not [e for e in events if e.get("event") == "objective_degraded"]
    train = [e for e in events if e.get("event") == "span" and e["span"] == "train"]
    assert train and all(e["objectives"] == "accuracy,params" for e in train)
    # a resume under other objectives is refused by the ledger's config gate
    with pytest.raises(SystemExit) as exc:
        cli.main(_argv(tmp_path, "--objectives", "accuracy:max,latency:min", "--resume",
                       algorithm=algorithm))
    assert exc.value.code == 2 and "--ledger" in capsys.readouterr().err


def test_cli_degraded_selection_event(tmp_path, capsys):
    rc, lines, _ = _run(_argv(tmp_path, "--objectives", "accuracy:max,params:min<=1"), capsys)
    assert rc == 0 and lines[-1]["pareto"]["selection"] == "least_violation"
    events = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
    degraded = [e for e in events if e.get("event") == "objective_degraded"]
    assert len(degraded) == 1 and degraded[0]["selection"] == "least_violation"
    assert degraded[0]["objectives"] == "accuracy,params"


def test_cli_crash_resume_ends_in_the_unkilled_records(tmp_path, monkeypatch, capsys):
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    whole.mkdir()
    cut.mkdir()
    assert _run(_argv(whole, "--objectives", TEXT), capsys)[0] == 0
    real, calls = fp._run_stepped_generation, {"n": 0}

    def crashing(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated crash")
        return real(*a, **k)

    monkeypatch.setattr(fp, "_run_stepped_generation", crashing)
    with pytest.raises(RuntimeError, match="simulated"):
        cli.main(_argv(cut, "--objectives", TEXT))
    monkeypatch.setattr(fp, "_run_stepped_generation", real)
    rc, lines, _ = _run(_argv(cut, "--objectives", TEXT, "--resume"), capsys)
    assert rc == 0 and lines[-1]["journal"] == {"written": 12, "verified": 0}
    assert _records(cut / "l.jsonl") == _records(whole / "l.jsonl")

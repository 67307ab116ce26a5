"""Fused Hyperband in the port against the JAX package's: the bracket
plan and the best-pick rule bit-equal to the JAX functions called live;
a whole traced ``fused_hyperband`` on fashion_mlp (R=9, eta 3) against
the JAX sweep: the same bracket summaries, rung sizes and budgets, ledger
records with the JAX keys and the same (boundary, boundary size, trial
id, step) sequence, members in each bracket's range (one ledger spans the
brackets), accepted by the JAX ledger reader, and the same spans as a multiset of (span, op,
parent), less ``compile`` and the port's own step-phase spans. Scores differ between the packages (their
random streams differ), so the sweep comparison is structural: which
trials survive a cut differs. Both sides' FLOP hints are filled in
beforehand (the JAX probe compiles a program a rung shape;
``test_torch_trace.py`` holds the probe's span to the JAX one). Then the
port alone: waves of 3 equal resident, and a drain between brackets
exits 75 and resumes to the unkilled records."""

import collections
import json
import math
import os
import signal

import jax  # noqa: F401  (pinned to the CPU by tests/conftest.py)
import numpy as np
import pytest

import mpi_opt_tpu.ledger.store as jstore
from mpi_opt_tpu.algorithms.base import best_finite as jax_best_finite
from mpi_opt_tpu.algorithms.hyperband import bracket_plan as jax_bracket_plan
from mpi_opt_tpu.obs import trace as jtrace
from mpi_opt_tpu.train.fused_asha import fused_hyperband as jax_fused_hyperband
from mpi_opt_tpu.workloads import get_workload as jax_get_workload
from mpi_opt_tpu_torch import cli, get_workload
from mpi_opt_tpu_torch.algorithms.base import best_finite
from mpi_opt_tpu_torch.algorithms.hyperband import bracket_plan
from mpi_opt_tpu_torch.ledger import SweepLedger, validate_ledger
from mpi_opt_tpu_torch.obs import events, trace
from mpi_opt_tpu_torch.train.fused_asha import fused_hyperband
from mpi_opt_tpu_torch.utils import resources

HB = dict(max_budget=9, eta=3, seed=0)
FIELDS = ("trial_id", "member", "boundary", "boundary_size", "params", "status", "score", "step")
SHAPE = ("boundary", "boundary_size", "trial_id", "step")


@pytest.mark.parametrize("eta", [2, 3, 4])
@pytest.mark.parametrize("r", [9, 27, 81, 243, 270])
def test_bracket_plan_equals_jax(r, eta):
    assert bracket_plan(r, eta) == jax_bracket_plan(r, eta)


def test_the_cli_default_plan():
    assert bracket_plan(270, 3) == [(243, 1), (98, 3), (41, 10), (18, 30), (9, 90), (6, 270)]
    assert sum(n for n, _ in bracket_plan(270, 3)) == 415
    assert bracket_plan(27, 3) == [(27, 1), (12, 3), (6, 9), (4, 27)]


@pytest.mark.parametrize("scores", [
    [0.1, 0.5, 0.3],
    [math.nan, 0.2, 0.4],
    [math.inf, 0.2, -math.inf],
    [0.3, math.nan, 0.3],  # a tie: the first maximum
    [math.nan, math.nan],
    [-math.inf, math.inf, math.nan],
    [],
])
def test_best_finite_equals_jax(scores):
    items = [{"i": i, "s": s} for i, s in enumerate(scores)]
    key = lambda it: it["s"]
    assert best_finite(items, key) == jax_best_finite(items, key)


class Sink:
    def __init__(self, module):
        self.module, self.recs = module, []

    def log(self, event, **fields):
        st = getattr(self.module._LOCAL, "stack", None) or []
        self.recs.append(dict(event=event, _parent=st[-1][0] if st else None, **fields))

    def multiset(self):
        """(span, op, parent) counts, less ``compile`` and the port's own
        step-phase spans (``obs/events.py::PORT_SPANS``)."""
        return collections.Counter((r["span"], r.get("op"), r["_parent"]) for r in self.recs
                                   if r["span"] != "compile" and r["span"] not in events.PORT_SPANS)


def _header(space, seed=0):
    return {"mode": "fused", "granularity": "rung", "algorithm": "hyperband", "seed": seed,
            "space_hash": space.space_hash()}


def _hinted(wl):
    """``wl`` with a FLOP hint for every rung shape of the sweep."""
    from mpi_opt_tpu_torch.ops.asha import asha_rungs
    from mpi_opt_tpu_torch.train.fused_asha import sha_cohort_sizes

    wl._flops_hint_cache = {}
    for n, r in bracket_plan(HB["max_budget"], HB["eta"]):
        rungs = asha_rungs(r, HB["max_budget"], HB["eta"])
        sizes = sha_cohort_sizes(n, len(rungs), HB["eta"])
        for i, (size, budget) in enumerate(zip(sizes, rungs)):
            wl._flops_hint_cache[(size, budget - (rungs[i - 1] if i else 0))] = 1.0e9
    return wl


def _recs(path):
    with open(path) as f:
        return [json.loads(x) for x in f.read().splitlines()[1:]]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_hb")
    wl = _hinted(jax_get_workload("fashion_mlp", n_train=256, n_val=128))
    led = jstore.SweepLedger(str(d / "jax.jsonl"))
    led.ensure_header(_header(wl.default_space()))
    sink = Sink(jtrace)
    prior = jtrace.configure(sink)
    try:
        res = jax_fused_hyperband(wl, ledger=led, **HB)
    finally:
        jtrace.deconfigure(prior)
        led.close()
    return res, str(d / "jax.jsonl"), sink


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_hb")
    wl = _hinted(get_workload("fashion_mlp", n_train=256, n_val=128))
    led = SweepLedger(str(d / "port.jsonl"))
    led.ensure_header(_header(wl.default_space()))
    sink = Sink(trace)
    prior = trace.configure(sink)
    try:
        res = fused_hyperband(wl, ledger=led, device="cpu", **HB)
    finally:
        trace.deconfigure(prior)
        led.close()
    return res, str(d / "port.jsonl"), sink


def test_bracket_summaries_equal_jax(jax_run, port_run):
    want, got = jax_run[0], port_run[0]
    assert set(got) == set(want)
    strip = lambda s: {k: v for k, v in s.items() if k != "best_score"}
    assert [strip(s) for s in got["brackets"]] == [strip(s) for s in want["brackets"]]
    assert [(s["n_trials"], s["start_budget"], s["rung_sizes"], s["rung_budgets"])
            for s in got["brackets"]] == [(9, 1, [9, 3, 1], [1, 3, 9]), (5, 3, [5, 2], [3, 9]),
                                          (3, 9, [3], [9])]
    assert got["n_trials"] == want["n_trials"] == 17
    assert got["journal"] == want["journal"] == {"written": 23, "verified": 0}
    assert got["member_failures"] == want["member_failures"]
    # the winner is the best finite bracket's
    best = max(s["best_score"] for s in got["brackets"])
    assert got["best_score"] == best and got["best_params"] is not None


def test_one_ledger_spans_the_brackets_as_jax(jax_run, port_run):
    j_recs, t_recs = _recs(jax_run[1]), _recs(port_run[1])
    assert [set(r) for r in t_recs] == [set(r) for r in j_recs]
    shape = lambda rs: [tuple(r[k] for k in SHAPE) for r in rs]
    assert shape(t_recs) == shape(j_recs)
    assert sorted({r["boundary"] for r in t_recs}) == list(range(6))  # contiguous across brackets
    # members are global trial identities: a bracket's first rung holds
    # all of its trials, in order; later rungs its survivors
    first = {0: (0, 9), 3: (9, 14), 5: (14, 17)}  # first boundary -> the bracket's members
    for recs in (t_recs, j_recs):
        for b, (lo, hi) in first.items():
            assert [r["member"] for r in recs if r["boundary"] == b] == list(range(lo, hi))
        for r in recs:
            lo, hi = next(v for k, v in sorted(first.items(), reverse=True) if k <= r["boundary"])
            assert lo <= r["member"] < hi
    assert jstore.validate_ledger(port_run[1]) == []
    assert validate_ledger(port_run[1]) == []


def test_span_multiset_equals_jax(jax_run, port_run):
    """Each bracket a fused SHA: setup once (the data cached on the
    workload), a train and a journal span a rung, a boundary span a
    cut."""
    got = port_run[2].multiset()
    assert got == jax_run[2].multiset()
    assert got[("train", None, None)] == 6 and got[("boundary", "rung_cut", None)] == 3
    trains = [r for r in port_run[2].recs if r["span"] == "train"]
    assert [r["launch"] for r in trains] == [1, 2, 3, 4, 5, 6]  # boundary_offset + rung
    assert [r["members"] for r in trains] == [9, 3, 1, 5, 2, 3]
    assert all(r["flops"] == 1.0e9 for r in trains)


@pytest.fixture(scope="module")
def port_ledgers(tmp_path_factory):
    """The port's Hyperband resident and in waves of 3, each journaled."""
    d = tmp_path_factory.mktemp("hb_waves")
    wl = get_workload("fashion_mlp", n_train=256, n_val=128)
    out = {}
    for tag, ws in (("resident", 0), ("waves", 3)):
        led = SweepLedger(str(d / f"{tag}.jsonl"))
        led.ensure_header(_header(wl.default_space()))
        try:
            out[tag] = fused_hyperband(wl, ledger=led, device="cpu", wave_size=ws, **HB)
        finally:
            led.close()
    return d, out


def test_waves_of_3_equal_resident(port_ledgers):
    d, out = port_ledgers
    res, wav = out["resident"], out["waves"]
    strip = lambda s: {k: s[k] for k in ("bracket", "n_trials", "rung_sizes", "rung_budgets",
                                           "member_failures", "best_score")}
    assert [strip(s) for s in wav["brackets"]] == [strip(s) for s in res["brackets"]]
    assert (wav["best_score"], wav["best_params"]) == (res["best_score"], res["best_params"])
    pick = lambda rs: [{k: r[k] for k in FIELDS} for r in rs]
    assert pick(_recs(d / "waves.jsonl")) == pick(_recs(d / "resident.jsonl"))
    # brackets whose cohort fits run resident: only the first two stage
    assert [s.get("wave_size") for s in wav["brackets"]] == [3, 3, None]
    assert wav["wave_size"] == 3 and wav["waves_run"] > 0 and wav["staged_bytes"] > 0
    assert "wave_size" not in res


def test_cli_drain_between_brackets_resumes_to_the_unkilled_records(tmp_path, capsys, monkeypatch):
    """SIGTERM at bracket 1's end: exit 75 at the bracket boundary;
    ``--resume`` replays bracket 1 from its final snapshot, runs brackets
    2 and 3, and ends with the unkilled run's records and summary."""
    real = cli.get_workload
    monkeypatch.setattr(cli, "get_workload", lambda name: real(name, n_train=256, n_val=128))

    def argv(name, *extra):
        return ["--workload", "fashion_mlp", "--algorithm", "hyperband", "--fused",
                "--max-budget", "9", "--eta", "3", "--seed", "0", "--device", "cpu",
                "--ledger", str(tmp_path / f"{name}.jsonl"), *extra]

    def run(args):
        rc = cli.main(args)
        return rc, [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]

    rc, lines = run(argv("whole"))
    assert rc == 0
    want = lines[-1]
    assert [b["n_trials"] for b in want["brackets"]] == [9, 5, 3] and want["n_trials"] == 17

    def sigterm(stage):
        if stage == "hyperband bracket 1/3":
            os.kill(os.getpid(), signal.SIGTERM)

    cut = argv("cut", "--checkpoint-dir", str(tmp_path / "ck"))
    resources.set_boundary_fault_injector(sigterm)
    try:
        rc, lines = run(cut)
    finally:
        resources.set_boundary_fault_injector(None)
    assert rc == 75 and lines[-1]["at"] == "hyperband bracket 1/3"
    assert sorted(os.listdir(tmp_path / "ck")) == ["bracket_0"]
    rc, lines = run(cut + ["--resume"])
    assert rc == 0
    got = lines[-1]
    assert got["journal"] == {"written": 7 + 3, "verified": 0}
    for k in ("best_score", "best_params", "brackets", "member_failures", "n_trials"):
        assert got[k] == want[k], k
    pick = lambda rs: [{k: r[k] for k in FIELDS} for r in rs]
    assert pick(_recs(tmp_path / "cut.jsonl")) == pick(_recs(tmp_path / "whole.jsonl"))
    with open(tmp_path / "cut.jsonl") as f:
        config = json.loads(f.readline())["config"]
    assert (config["algorithm"], config["max_budget"], config["eta"]) == ("hyperband", 9, 3)
    assert np.isfinite(got["best_score"])

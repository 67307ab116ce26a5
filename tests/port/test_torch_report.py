"""The port's ``report`` subcommand and ``--warm-start`` against the JAX
package's, on ledgers the port's CLI writes on the CPU.

- ``report`` (text and ``--json``) of a driver ledger, a fused ledger, a
  multi-objective ledger with ``--best-under``, a ledger with a torn
  tail and a directory of them prints what the JAX ``report_main``
  prints for the same files, with the same exit code; so does
  ``--validate``.
- ``replay_consistency`` and ``fused_replay_consistency`` of both
  packages agree on the same ledger and snapshot state, consistent or
  lagging.
- ``--warm-start`` on the fused and the driver path: the ``warm_start``
  event carries the payload the JAX CLI's resolution gives (on the
  driver path, the count the JAX algorithm ingests), and the ledger
  header names the prior; this run's own ledger, a ledger of another
  space and ``auto`` without a corpus root are usage errors that leave
  no ledger header; a
  driver sweep resumed from its snapshot does not ingest again.
"""

import argparse
import contextlib
import io
import json
import os
import shutil

import pytest

import mpi_opt_tpu.cli as jcli
import mpi_opt_tpu.ledger.report as jreport
import mpi_opt_tpu_torch.cli as cli
import mpi_opt_tpu_torch.ledger.report as treport
from mpi_opt_tpu.workloads import get_workload as jax_get_workload
from mpi_opt_tpu_torch.utils import integrity

TPE = ["--workload", "tabular_mlp", "--algorithm", "tpe", "--trials", "8", "--population", "4",
       "--budget", "2", "--device", "cpu"]


def _main(argv, capsys):
    rc = cli.main(argv)
    out = capsys.readouterr()
    return rc, [json.loads(x) for x in out.out.splitlines() if x.startswith("{")], out.err


@pytest.fixture(scope="module")
def ledgers(tmp_path_factory):
    """A driver ledger (with its snapshot directory), a fused TPE ledger,
    a multi-objective fused PBT ledger and a torn copy, from the port's
    CLI."""
    d = tmp_path_factory.mktemp("ledgers")
    real = cli.get_workload
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "get_workload",
                   lambda name: real(name, n_train=256, n_val=128) if name == "fashion_mlp"
                   else real(name))
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            assert cli.main(["--workload", "fashion_mlp", "--algorithm", "asha", "--trials", "8",
                             "--min-budget", "1", "--max-budget", "3", "--population", "4",
                             "--ledger", str(d / "driver.jsonl"), "--checkpoint-dir",
                             str(d / "dck"), "--device", "cpu"]) == 0
            assert cli.main([*TPE, "--fused", "--ledger", str(d / "fused.jsonl")]) == 0
            assert cli.main(["--workload", "digits_mlp", "--algorithm", "pbt", "--fused",
                             "--population", "4", "--generations", "2",
                             "--steps-per-generation", "3", "--objectives",
                             "accuracy:max,params:min", "--ledger", str(d / "mo.jsonl"),
                             "--device", "cpu"]) == 0
    shutil.copy(d / "fused.jsonl", d / "torn.jsonl")
    with open(d / "torn.jsonl", "a") as f:
        f.write('{"kind": "trial", "trial_id": 99, "par')
    return d


_TARGETS = {
    "driver": ("driver.jsonl", []),
    "fused": ("fused.jsonl", []),
    "mo": ("mo.jsonl", ["--best-under", "params<=2400"]),
    "torn": ("torn.jsonl", []),
    "directory": (".", []),
}


@pytest.mark.parametrize("fmt", ["json", "text"])
@pytest.mark.parametrize("target", list(_TARGETS))
def test_report_prints_what_jax_prints(ledgers, target, fmt, capsys, monkeypatch):
    monkeypatch.chdir(ledgers)
    name, extra = _TARGETS[target]
    argv = [name, *extra, *(["--json"] if fmt == "json" else [])]
    rc = cli.main(["report", *argv])
    got = capsys.readouterr().out
    want_rc = jreport.report_main(argv)
    want = capsys.readouterr().out
    assert (rc, got) == (want_rc, want)
    if fmt == "json":
        reps = json.loads(got)["ledgers"]
        assert len(reps) == (4 if target == "directory" else 1)
        if target == "mo":
            assert reps[0]["multi_objective"]["best_under"]["kind"] in ("feasible",
                                                                         "least_violation")


@pytest.mark.parametrize("name,valid", [("fused.jsonl", True), ("torn.jsonl", False)])
def test_validate_exit_codes_equal_jax(ledgers, name, valid, capsys):
    argv = ["--validate", "--json", str(ledgers / name)]
    rc = cli.main(["report", *argv])
    got = capsys.readouterr().out
    assert (rc, got) == (jreport.report_main(argv), capsys.readouterr().out)
    assert rc == (0 if valid else 1) and json.loads(got)["valid"] is valid


def _cut(src, dst):
    """The header and the first half of the records of ``src``."""
    with open(src) as f:
        lines = f.read().splitlines()
    dst.write_text("\n".join(lines[:1 + (len(lines) - 1) // 2]) + "\n")
    return str(dst)


def test_replay_cross_checks_agree_with_jax(ledgers, tmp_path):
    root = str(ledgers / "dck")
    search = integrity.load_search_state(root, integrity._committed_steps(root)[-1])
    assert search is not None and integrity.load_sweep_meta(root, 1) is None
    for path, lags in ((str(ledgers / "driver.jsonl"), False),
                       (_cut(ledgers / "driver.jsonl", tmp_path / "d.jsonl"), True)):
        got = treport.replay_consistency(path, search)
        assert got == jreport.replay_consistency(path, search) and bool(got) == lags
    # the fused TPE ledger journals 2 boundaries (batches of 4 of 8 trials)
    for done, lags in ((2, False), (3, True)):
        got = treport.fused_replay_consistency(str(ledgers / "fused.jsonl"), done)
        assert got == jreport.fused_replay_consistency(str(ledgers / "fused.jsonl"), done)
        assert bool(got) == lags


def _jax_warm_payload(prior, driver):
    """What the JAX CLI logs for ``--warm-start prior`` on the TPE argv."""
    ns = argparse.Namespace(warm_start=prior, ledger=None, workload="tabular_mlp",
                            algorithm="tpe", seed=0, trials=8, budget=2)
    space = jax_get_workload("tabular_mlp").default_space()
    obs, info = jcli._resolve_warm_start(ns, space, None, None)
    n = jcli.make_algorithm(ns, space).ingest_observations(obs) if driver else len(obs)
    logged = {}
    jcli._log_warm_start(type("M", (), {"log": lambda self, e, **f: logged.update(f)})(),
                         ns, info, n)
    return logged


@pytest.mark.parametrize("path", ["fused", "driver"])
def test_warm_start_event_equals_jax(ledgers, tmp_path, path, capsys):
    prior = str(ledgers / "fused.jsonl")
    own = tmp_path / "own.jsonl"
    argv = [*TPE, *(["--fused"] if path == "fused" else []), "--warm-start", prior,
            "--ledger", str(own)]
    rc, lines, _ = _main(argv, capsys)
    assert rc == 0
    events = [x for x in lines if x.get("event") == "warm_start"]
    assert len(events) == 1
    got = {k: v for k, v in events[0].items() if k not in ("event", "t", "ts")}
    assert got == _jax_warm_payload(prior, driver=path == "driver")
    assert got["observations"] == 8 and got["skipped"] is None
    with open(own) as f:
        assert json.loads(f.readline())["config"]["warm_start"] == prior


@pytest.mark.parametrize("case,message", [
    ("self", "must name a PRIOR sweep's ledger"),
    ("other_space", "space hash"),
    # auto:DIR runs now (test_torch_corpus.py); auto without a corpus
    # root is refused (the case keeps its id)
    pytest.param("auto", "needs a corpus root: --warm-start auto:DIR", id="auto-not ported yet"),
])
def test_warm_start_refusals_leave_no_header(ledgers, tmp_path, case, message, capsys):
    own = tmp_path / "own.jsonl"
    warm = {"self": os.path.join(str(tmp_path), ".", "own.jsonl"),
            "other_space": str(ledgers / "driver.jsonl"),
            "auto": "auto"}[case]
    with pytest.raises(SystemExit) as exc:
        cli.main([*TPE, "--fused", "--warm-start", warm, "--ledger", str(own)])
    assert exc.value.code == 2 and message in capsys.readouterr().err
    assert not own.exists()


def test_a_resumed_driver_sweep_does_not_ingest_again(ledgers, tmp_path, capsys):
    argv = [*TPE, "--warm-start", str(ledgers / "fused.jsonl"), "--ledger",
            str(tmp_path / "l.jsonl"), "--checkpoint-dir", str(tmp_path / "ck")]
    rc, lines, _ = _main(argv, capsys)
    assert rc == 0 and [x["event"] for x in lines if "warm_start" in x.get("event", "")] == [
        "warm_start"]
    rc, lines, _ = _main([*argv, "--resume"], capsys)
    warm = [x for x in lines if "warm_start" in x.get("event", "")]
    assert rc == 0 and [x["event"] for x in warm] == ["warm_start_skipped"]
    assert warm[0]["step"] == 2  # the snapshot of the last of 2 batches

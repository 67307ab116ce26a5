"""The port's command line in process, on the CPU (mirrors the fused PBT
cases of the JAX package's ``tests/test_cli.py``): the summary line, the
refusals, and the exit codes 0, 2, 65, 74 and 75, with a drained or
corrupted sweep resumed to the unkilled run's ledger."""

import json
import os
import signal

import pytest

import mpi_opt_tpu_torch.cli as cli
from mpi_opt_tpu_torch.utils import integrity, resources

#: the JAX CLI's fused PBT summary keys (``_run_fused_dispatch``), with a ledger
SUMMARY_KEYS = {"workload", "algorithm", "backend", "mesh", "n_chips", "n_trials",
                "member_failures", "wall_s", "trials_per_sec_per_chip", "best_score",
                "best_params", "best_curve", "journal"}
FIELDS = ("trial_id", "member", "boundary", "boundary_size", "params", "status", "score", "step")


@pytest.fixture(autouse=True)
def _clear_seams():
    yield
    resources.set_boundary_fault_injector(None)
    resources.set_launch_fault_injector(None)


def _argv(tmp_path, *extra, ledger="l.jsonl", ckpt="ck"):
    return ["--workload", "fashion_mlp", "--algorithm", "pbt", "--fused", "--population", "4",
            "--generations", "4", "--steps-per-generation", "2", "--gen-chunk", "1",
            "--seed", "3", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path / ckpt), "--ledger", str(tmp_path / ledger), *extra]


@pytest.fixture(autouse=True)
def _small_data(monkeypatch):
    real = cli.get_workload
    monkeypatch.setattr(cli, "get_workload", lambda name: real(name, n_train=256, n_val=128))


def _run(argv, capsys):
    rc = cli.main(argv)
    out = capsys.readouterr()
    lines = [json.loads(x) for x in out.out.splitlines() if x.startswith("{")]
    return rc, lines, out.err


def _records(path):
    return [{k: r[k] for k in FIELDS} for r in (json.loads(x) for x in open(path).read().splitlines()[1:])]


def _sigterm_at(n):
    def inject(stage, calls={"n": 0}):
        calls["n"] += 1
        if calls["n"] == n:
            os.kill(os.getpid(), signal.SIGTERM)

    return inject


@pytest.fixture
def unkilled(tmp_path_factory, capsys):
    d = tmp_path_factory.mktemp("unkilled")
    rc, lines, _ = _run(_argv(d), capsys)
    assert rc == 0
    return d, lines[-1]


def test_cli_fused_pbt_summary_line(unkilled, capsys):
    d, summary = unkilled
    assert set(summary) == SUMMARY_KEYS
    assert (summary["workload"], summary["algorithm"], summary["backend"]) == ("fashion_mlp", "pbt", "fused")
    assert summary["n_trials"] == 16 and summary["member_failures"] == [0] * 4
    assert summary["journal"] == {"written": 16, "verified": 0}
    assert len(summary["best_curve"]) == 4 and 0 <= summary["best_score"] <= 1
    assert integrity._committed_steps(str(d / "ck")) == [2, 3, 4]
    # a second run on the same directory without --resume is a usage error
    with pytest.raises(SystemExit) as exc:
        cli.main(_argv(d))
    assert exc.value.code == 2
    assert "pass --resume" in capsys.readouterr().err


def test_cli_stale_ledger_without_resume_is_usage_error(unkilled, capsys):
    d, _ = unkilled
    with pytest.raises(SystemExit) as exc:
        cli.main(_argv(d, ckpt="fresh"))
    assert exc.value.code == 2
    assert "16 member records; pass --resume" in capsys.readouterr().err


def test_cli_drain_exits_75_and_resume_matches_unkilled(unkilled, tmp_path, capsys):
    d, want = unkilled
    resources.set_boundary_fault_injector(_sigterm_at(2))
    rc, lines, err = _run(_argv(tmp_path), capsys)
    resources.set_boundary_fault_injector(None)
    assert rc == 75
    assert lines[-1] == {"preempted": True, "signal": "SIGTERM", "at": "pbt launch 2/4",
                         "workload": "fashion_mlp", "algorithm": "pbt", "backend": "fused"}
    assert "relaunch with --resume" in err
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL  # the guard restored it
    rc, lines, _ = _run(_argv(tmp_path, "--resume"), capsys)
    assert rc == 0
    got = lines[-1]
    assert got["journal"] == {"written": 8, "verified": 0}
    for k in ("best_score", "best_params", "best_curve", "member_failures"):
        assert got[k] == want[k], k
    assert _records(tmp_path / "l.jsonl") == _records(d / "l.jsonl")


def test_cli_heartbeat_file_beats_every_launch(tmp_path, capsys):
    """--heartbeat-file beats at every launch boundary and, with
    --step-chunk, at every training sub-launch; the heartbeat is dropped
    when the run ends."""
    from mpi_opt_tpu_torch.health import heartbeat

    path = tmp_path / "beat.json"
    rc, _, _ = _run(_argv(tmp_path, "--heartbeat-file", str(path), "--step-chunk", "1"), capsys)
    assert rc == 0
    rec = heartbeat.read_beat(str(path))
    assert rec["beats"] == 4 * (2 + 1)  # two sub-launches and a boundary a generation
    assert rec["progress"] == {"stage": "pbt launch 4/4", "launch": 4, "of": 4}
    assert heartbeat._ACTIVE is None


def test_cli_retries_a_transient_failure_as_a_resume(unkilled, tmp_path, capsys):
    """A transient I/O failure in launch 3 with --retries 1: the retry
    re-enters the sweep with the same open ledger, resumes from snapshot
    2, and ends with the unkilled run's records."""
    d, want = unkilled

    def reset_at_3(kind, calls={"n": 0}):
        calls["n"] += 1
        if calls["n"] == 3:
            raise ConnectionResetError("connection reset by peer")

    resources.set_launch_fault_injector(reset_at_3)
    rc, lines, _ = _run(_argv(tmp_path, "--retries", "1"), capsys)
    assert rc == 0
    assert [x["attempt"] for x in lines if x.get("event") == "retry"] == [1]
    # the summary counts the last attempt's journal: generations 2 and 3
    assert lines[-1]["journal"] == {"written": 8, "verified": 0}
    assert (lines[-1]["best_score"], lines[-1]["best_curve"]) == (want["best_score"], want["best_curve"])
    assert _records(tmp_path / "l.jsonl") == _records(d / "l.jsonl")
    # a program error is not retried
    resources.set_launch_fault_injector(lambda kind: (_ for _ in ()).throw(KeyError("bug")))
    with pytest.raises(KeyError):
        cli.main(_argv(tmp_path / "x", "--retries", "3"))


def test_cli_tampered_ledger_exits_65(tmp_path, capsys):
    """Snapshots every 2 launches, a crash at boundary 3, then one
    journaled score of generation 2 edited: the resume re-computes
    generation 2 and refuses the journal."""

    def crash_at_3(stage, calls={"n": 0}):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("simulated crash")

    resources.set_boundary_fault_injector(crash_at_3)
    with pytest.raises(RuntimeError, match="simulated"):
        cli.main(_argv(tmp_path, "--checkpoint-every", "2"))
    resources.set_boundary_fault_injector(None)
    capsys.readouterr()
    path = tmp_path / "l.jsonl"
    lines = open(path).read().splitlines()
    rec = json.loads(lines[9])  # boundary 2, member 0
    assert rec["boundary"] == 2
    rec["score"] = rec["score"] + 0.25
    lines[9] = json.dumps(rec)
    open(path, "w").write("\n".join(lines) + "\n")
    rc, out, err = _run(_argv(tmp_path, "--checkpoint-every", "2", "--resume"), capsys)
    assert rc == 65
    assert "diverges from this sweep's trajectory" in out[-1]["data_error"]
    assert "exit 65" in err


def test_cli_no_verified_snapshot_exits_65(unkilled, capsys):
    d, _ = unkilled
    for step in (2, 3, 4):
        os.remove(os.path.join(d, "ck", str(step), integrity.SWEEP_FILE))
    rc, out, _ = _run(_argv(d, "--resume"), capsys)
    assert rc == 65
    assert "no verified snapshot remains" in out[-1]["data_error"]
    assert [x["event"] for x in out if "event" in x].count("snapshot_corrupt") == 3


def test_cli_device_oom_exits_74(tmp_path, capsys):
    resources.set_launch_fault_injector(lambda kind: (_ for _ in ()).throw(
        resources.synthetic_resource_exhausted()))
    rc, out, err = _run(_argv(tmp_path), capsys)
    assert rc == 74
    assert out[-1]["kind"] == "device_oom" and "CUDA out of memory" in out[-1]["resource_exhausted"]
    assert "exit 74" in err


def test_cli_full_disk_exits_74(tmp_path, capsys):
    def enospc(op, path):
        if op == "snapshot_save":
            raise resources.storage_full_error(path, op)

    resources.set_disk_fault_injector(enospc)
    try:
        rc, out, _ = _run(_argv(tmp_path), capsys)
    finally:
        resources.set_disk_fault_injector(None)
    assert rc == 74 and out[-1]["kind"] == "storage_full"


# the suggestion service's flags run now (test_torch_suggest.py,
# test_torch_http.py); each case keeps its id and checks the JAX CLI's
# usage error for the flag out of place
@pytest.mark.parametrize("flag,extra,message", [
    pytest.param("--suggest-serve", ["--suggest-serve", "sd"],
                 "--suggest-serve answers suggestion traffic instead of sweeping; it cannot "
                 "combine with --fused", id="--suggest-serve"),
    pytest.param("--suggest-idle-timeout", ["--suggest-idle-timeout", "2"],
                 "--suggest-idle-timeout requires --suggest-serve", id="--suggest-idle-timeout"),
    pytest.param("--http-port", ["--http-port", "2"], "--http-port requires --suggest-serve DIR",
                 id="--http-port"),
    pytest.param("--http-queue", ["--http-port", "2", "--http-queue", "0"],
                 "--http-port requires --suggest-serve DIR", id="--http-queue"),
    pytest.param("--http-state-dir", ["--http-state-dir", "2"],
                 "--http-state-dir requires --http-port", id="--http-state-dir"),
])
def test_cli_flags_not_ported_are_usage_errors(tmp_path, flag, extra, message, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(_argv(tmp_path, *extra))
    assert exc.value.code == 2
    assert message in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "ck")  # refused before anything ran


@pytest.mark.parametrize("argv,message", [
    # report, fsck and lint run now (test_torch_report.py,
    # test_torch_fsck.py, test_torch_analysis.py); lint refuses a path that
    # is not there, as the JAX lint does (the case keeps its id)
    pytest.param(["lint", "no-such-path"], "'no-such-path' does not exist",
                 id="argv0-'report' subcommand is not ported yet"),
    # the sweep service's subcommands and suggest-client run now
    # (test_torch_service.py, test_torch_suggest.py); suggest-client's
    # own parser refuses a flag it does not have (the case keeps its id)
    pytest.param(["suggest-client", "--state-dir", "sd"],
                 "argument op: invalid choice: 'sd'",
                 id="argv1-'fsck' subcommand is not ported yet"),
    # the driver path runs on the gpu and cpu backends now
    # (test_torch_driver.py, test_torch_backend_cpu.py); the JAX package's
    # tpu backend is the port's gpu, and its name is refused (the case
    # keeps its id)
    pytest.param(["--workload", "fashion_mlp", "--algorithm", "pbt", "--backend", "tpu"],
                 "--backend tpu is not a backend of the port",
                 id="argv2-driver path (no --fused) is not ported yet"),
    # TPE and BOHB are ported; what they leave out is refused
    # --n-pop is ported: a 2-rank 'pop' axis in a world of one is refused
    # as a mesh that needs more devices (the case keeps its id)
    pytest.param(["--workload", "fashion_mlp", "--algorithm", "bohb", "--fused", "--n-pop", "2"],
                 "mesh 2x1 needs 2 devices, have 1", id="argv3---n-pop is not ported yet"),
    # --warm-start PATH and auto:DIR run now (test_torch_report.py,
    # test_torch_corpus.py); auto: of a directory that is not there is
    # refused (the case keeps its id)
    pytest.param(["--workload", "fashion_mlp", "--algorithm", "tpe", "--fused", "--warm-start",
                  "auto:no-such-corpus"], "--warm-start auto: 'no-such-corpus' is not a directory",
                 id="argv4---warm-start is not ported yet"),
    (["--workload", "fashion_mlp", "--algorithm", "pbt", "--fused", "--resume"],
     "--resume requires --checkpoint-dir or --ledger"),
    (["--workload", "fashion_mlp", "--algorithm", "pbt", "--fused", "--trace"],
     "--trace needs --metrics-file"),
    # trace --diff/--gate/--timeline run now (test_torch_obs_diff.py,
    # test_torch_obs_timeline.py); a gate without a diff is refused (the
    # case keeps its id)
    pytest.param(["trace", "m.jsonl", "--gate", "tol.json"], "--gate requires --diff",
                 id="argv7-trace --diff is not ported yet"),
])
def test_cli_refusals_are_usage_errors(argv, message, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


# lint and suggest-client run now (test_torch_analysis.py,
# test_torch_suggest.py); their cases keep their ids with the JAX lint's and
# the JAX client's usage errors: a baseline that cannot be read (missing,
# a directory)
@pytest.mark.parametrize("argv,message", [
    (["lint", "--baseline", "no-such-baseline.json"], "--baseline: [Errno 2] No such file or directory"),
    (["lint", "--baseline", os.path.dirname(cli.__file__)], "--baseline: [Errno 21] Is a directory"),
    (["suggest-client"], "the following arguments are required: op"),
    (["suggest-client", "bench"], "need --dir SDIR (filesystem spool) or --url URL (HTTP)"),
], ids=["argv0", "argv1", "argv2", "argv3"])
def test_cli_subcommands_not_ported_are_usage_errors(argv, message, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("argv,rc,out", [
    (["submit", "--state-dir", "{sd}", "--", "--workload", "fashion_mlp", "--fused"], 0,
     '"state": "queued"'),
    (["status", "--state-dir", "{sd}"], 0, "server down"),
    (["status", "--state-dir", "{sd}", "--json"], 0, '"jobs": []'),
    (["drain", "--state-dir", "{sd}"], 0, '"drain": true'),
    (["corpus", "index", "{sd}"], 0, "0 ledger(s) indexed"),
    (["corpus", "resolve", "{sd}", "--workload", "fashion_mlp"], 0, "0 observation(s)"),
])
def test_cli_service_and_corpus_subcommands_run(tmp_path, argv, rc, out, capsys):
    """The sweep service's clients and the corpus subcommands run through
    the CLI's dispatch (their parity with the JAX package is
    test_torch_service.py's and test_torch_corpus.py's)."""
    from mpi_opt_tpu_torch.service.spool import Spool

    Spool(str(tmp_path))
    assert cli.main([a.format(sd=tmp_path) for a in argv]) == rc
    assert out in capsys.readouterr().out


@pytest.mark.parametrize("argv,message", [
    (["status", "--state-dir", "{sd}/nope"], "not a service spool"),
    (["cancel", "--state-dir", "{sd}", "job-0"], "unknown job"),
    (["submit", "--state-dir", "{sd}", "--", "--workload", "fashion_mlp", "--ledger", "x"],
     "server-owned --ledger"),
    (["serve", "--state-dir", "{sd}", "--slice-boundaries", "0"], "--slice-boundaries must be >= 1"),
])
def test_cli_service_usage_errors(tmp_path, argv, message, capsys):
    from mpi_opt_tpu_torch.service.spool import Spool

    Spool(str(tmp_path))
    with pytest.raises(SystemExit) as exc:
        cli.main([a.format(sd=tmp_path) for a in argv])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_cli_refuses_a_non_population_workload(monkeypatch, capsys):
    class Quadratic:
        name = "quadratic"

    monkeypatch.setitem(cli._REGISTRY, "quadratic", Quadratic)
    monkeypatch.setattr(cli, "get_workload", lambda name: Quadratic())
    with pytest.raises(SystemExit) as exc:
        cli.main(["--workload", "quadratic", "--algorithm", "pbt", "--fused", "--device", "cpu"])
    assert exc.value.code == 2
    assert "requires a population workload" in capsys.readouterr().err


def test_cli_runs_on_cuda_unless_told(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)


# -- the wave engine and successive halving through the CLI ----------------

#: the JAX CLI's summary wave fields (``_wave_extras``) and the port's ``waves_run``,
#: ``launch_width`` and ``launch_shape_changed``
WAVE_KEYS = {"wave_size", "n_waves", "staged_bytes", "stage_overlap_s", "stage_wait_s",
             "oom_backoffs", "waves_run", "launch_width", "launch_shape_changed"}


def _pbt(tmp_path, *extra, name="run"):
    return ["--workload", "fashion_mlp", "--algorithm", "pbt", "--fused", "--population", "6",
            "--generations", "2", "--steps-per-generation", "2", "--seed", "1", "--device", "cpu",
            "--ledger", str(tmp_path / f"{name}.jsonl"), *extra]


def _sha(tmp_path, *extra, algorithm="asha", name="sha"):
    return ["--workload", "fashion_mlp", "--algorithm", algorithm, "--fused", "--trials", "8",
            "--min-budget", "2", "--max-budget", "8", "--eta", "2", "--budget", "3", "--seed", "4",
            "--device", "cpu", "--ledger", str(tmp_path / f"{name}.jsonl"), *extra]


@pytest.mark.parametrize("value,message", [
    ("-1", "--wave-size must be >= 0, got -1"),
    ("half", "--wave-size must be an integer or 'auto', got 'half'"),
])
def test_cli_bad_wave_size_is_usage_error(tmp_path, value, message, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(_pbt(tmp_path, "--wave-size", value))
    assert exc.value.code == 2
    assert message in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "run.jsonl")


@pytest.mark.parametrize("extra,message", [
    (["--oom-backoff", "-1"], "--oom-backoff must be >= 0"),
    (["--wave-size", "2", "--step-chunk", "1"], "ambiguous"),
    (["--wave-size", "2", "--gen-chunk", "2"], "ambiguous"),
])
def test_cli_wave_refusals_are_usage_errors(tmp_path, extra, message, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(_pbt(tmp_path, *extra))
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_cli_wave_size_int_summary_and_records_equal_resident(tmp_path, capsys):
    rc, lines, _ = _run(_pbt(tmp_path, name="resident"), capsys)
    assert rc == 0
    resident = lines[-1]
    assert not WAVE_KEYS & set(resident)
    rc, lines, _ = _run(_pbt(tmp_path, "--wave-size", "4", name="waved"), capsys)
    assert rc == 0
    waved = lines[-1]
    assert set(waved) == SUMMARY_KEYS | WAVE_KEYS
    assert (waved["wave_size"], waved["n_waves"], waved["waves_run"], waved["oom_backoffs"]) == (4, 2, 4, 0)
    assert waved["staged_bytes"] > 0 and waved["stage_wait_s"] >= 0 and waved["stage_overlap_s"] >= 0
    for k in ("best_score", "best_params", "best_curve", "member_failures", "journal"):
        assert waved[k] == resident[k], k
    assert _records(tmp_path / "waved.jsonl") == _records(tmp_path / "resident.jsonl")
    events = {x["event"]: x for x in lines if "event" in x}
    assert events["summary"]["staged_bytes"] == waved["staged_bytes"]


def test_cli_wave_size_auto(tmp_path, capsys, monkeypatch):
    """``auto`` on the CPU with no budget runs resident (8 GiB fits); with
    an operator budget of two members it runs waves of 2 and logs the
    ``wave_resized`` event."""
    monkeypatch.delenv("MPI_OPT_TPU_DEVICE_BYTES", raising=False)
    rc, lines, _ = _run(_pbt(tmp_path, "--wave-size", "auto", name="a"), capsys)
    assert rc == 0 and "wave_size" not in lines[-1]
    member = cli.get_workload("fashion_mlp").make_trainer(device="cpu").member_bytes()
    monkeypatch.setenv("MPI_OPT_TPU_DEVICE_BYTES", str(int(member * 2 / 0.35) + 1024))
    rc, lines, _ = _run(_pbt(tmp_path, "--wave-size", "auto", name="b"), capsys)
    assert rc == 0
    assert lines[-1]["wave_size"] == 2 and lines[-1]["n_waves"] == 3
    events = [x for x in lines if "event" in x]
    assert [x for x in events if x["event"] == "wave_resized"] == [
        {**events[0], "event": "wave_resized", "requested": "auto", "wave_size": 2, "population": 6}]
    assert [x["wave_resized"] for x in events if x["event"] == "summary"] == [1]


def test_cli_oom_backoff_absorbs_a_device_oom(tmp_path, capsys):
    """A device OOM at the first wave: with --oom-backoff 2 the run halves
    its cap and ends with the clean run's records (exit 0); with 0 it
    exits 74."""
    rc, lines, _ = _run(_pbt(tmp_path, "--wave-size", "2", name="clean"), capsys)
    assert rc == 0
    clean = lines[-1]
    fired = {"n": 0}

    def first_wave(kind):
        if kind == "wave" and not fired["n"]:
            fired["n"] += 1
            raise resources.synthetic_resource_exhausted()

    resources.set_launch_fault_injector(first_wave)
    rc, lines, _ = _run(_pbt(tmp_path, "--wave-size", "4", "--oom-backoff", "2", name="oom"), capsys)
    assert rc == 0 and fired["n"] == 1
    got = lines[-1]
    assert got["oom_backoffs"] == 1 and got["wave_size"] == 2
    assert [x["oom_backoffs"] for x in lines if x.get("event") == "summary"] == [1]
    assert [x["gen"] for x in lines if x.get("event") == "oom_backoff"] == [1]
    for k in ("best_score", "best_params", "best_curve"):
        assert got[k] == clean[k], k
    assert _records(tmp_path / "oom.jsonl") == _records(tmp_path / "clean.jsonl")
    fired["n"] = 0
    rc, lines, err = _run(_pbt(tmp_path, "--wave-size", "4", "--oom-backoff", "0", name="no"), capsys)
    assert rc == 74 and lines[-1]["kind"] == "device_oom"
    assert "--wave-size auto" in err


@pytest.mark.parametrize("wave_size", ["0", "3"])
def test_cli_fused_asha_summary_and_ledger(tmp_path, wave_size, capsys):
    rc, lines, _ = _run(_sha(tmp_path, "--wave-size", wave_size), capsys)
    assert rc == 0
    s = lines[-1]
    keys = SUMMARY_KEYS - {"best_curve"} | {"rung_sizes", "rung_budgets"}
    assert set(s) == (keys | WAVE_KEYS if wave_size != "0" else keys)
    assert (s["algorithm"], s["n_trials"], s["rung_sizes"], s["rung_budgets"]) == ("asha", 8, [8, 4, 2], [2, 4, 8])
    assert s["journal"] == {"written": 14, "verified": 0} and len(s["member_failures"]) == 3
    with open(tmp_path / "sha.jsonl") as f:
        header = json.loads(f.readline())
    assert header["config"]["granularity"] == "rung"
    assert {k: header["config"][k] for k in ("trials", "min_budget", "max_budget", "eta")} == {
        "trials": 8, "min_budget": 2, "max_budget": 8, "eta": 2}


def test_cli_asha_waves_equal_resident_and_random_is_one_rung(tmp_path, capsys):
    rc, lines, _ = _run(_sha(tmp_path, name="res"), capsys)
    res = lines[-1]
    rc2, lines, _ = _run(_sha(tmp_path, "--wave-size", "3", name="wav"), capsys)
    assert rc == rc2 == 0
    for k in ("best_score", "best_params", "member_failures", "rung_sizes"):
        assert lines[-1][k] == res[k], k
    assert _records(tmp_path / "wav.jsonl") == _records(tmp_path / "res.jsonl")
    rc, lines, _ = _run(_sha(tmp_path, algorithm="random", name="rand"), capsys)
    assert rc == 0
    assert (lines[-1]["algorithm"], lines[-1]["rung_sizes"], lines[-1]["rung_budgets"]) == ("random", [8], [3])
    with open(tmp_path / "rand.jsonl") as f:
        config = json.loads(f.readline())["config"]
    assert (config["trials"], config["budget"], config["granularity"]) == (8, 3, "rung")


def test_cli_asha_drain_and_resume_match_unkilled(tmp_path, capsys):
    """Waves of 3: rung 1's 8 trials run waves [3, 3, 2], so the third
    boundary is rung 1's end. SIGTERM there: exit 75, and --resume
    journals rungs 2 and 3 only and ends with the unkilled sweep's
    records."""
    rc, lines, _ = _run(_sha(tmp_path, "--wave-size", "3", name="whole"), capsys)
    assert rc == 0
    want = lines[-1]
    argv = _sha(tmp_path, "--wave-size", "3", "--checkpoint-dir", str(tmp_path / "ck"), name="cut")
    resources.set_boundary_fault_injector(_sigterm_at(3))
    rc, lines, _ = _run(argv, capsys)
    resources.set_boundary_fault_injector(None)
    assert rc == 75 and lines[-1]["at"] == "sha rung 1/3"
    rc, lines, _ = _run(argv + ["--resume"], capsys)
    assert rc == 0
    assert lines[-1]["journal"] == {"written": 6, "verified": 0}
    for k in ("best_score", "best_params", "member_failures"):
        assert lines[-1][k] == want[k], k
    assert _records(tmp_path / "cut.jsonl") == _records(tmp_path / "whole.jsonl")


def test_cli_pbt_drain_between_waves_resumes_without_retraining(tmp_path, capsys):
    """SIGTERM before the first between-waves boundary of generation 1:
    the drain flushes a mid-generation snapshot and exits 75; --resume
    trains the 2 remaining waves and generation 2's 3 (``waves_run``)
    and ends with the unkilled run's records."""
    rc, lines, _ = _run(_pbt(tmp_path, "--wave-size", "2", name="whole"), capsys)
    assert rc == 0
    want = lines[-1]
    argv = _pbt(tmp_path, "--wave-size", "2", "--checkpoint-dir", str(tmp_path / "ck"), name="cut")
    resources.set_boundary_fault_injector(_sigterm_at(1))
    rc, lines, _ = _run(argv, capsys)
    resources.set_boundary_fault_injector(None)
    assert rc == 75 and lines[-1]["at"] == "pbt gen 1/2 wave 1/3"
    assert integrity._committed_steps(str(tmp_path / "ck")) == [1]
    rc, lines, _ = _run(argv + ["--resume"], capsys)
    assert rc == 0
    assert lines[-1]["waves_run"] == 5
    for k in ("best_score", "best_params", "best_curve", "member_failures"):
        assert lines[-1][k] == want[k], k
    assert _records(tmp_path / "cut.jsonl") == _records(tmp_path / "whole.jsonl")

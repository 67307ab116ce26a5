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


@pytest.mark.parametrize("flag", cli._NOT_PORTED_FLAGS + cli._NOT_PORTED_SWITCHES)
def test_cli_flags_not_ported_are_usage_errors(tmp_path, flag, capsys):
    extra = [flag] if flag in cli._NOT_PORTED_SWITCHES else [flag, "2"]
    with pytest.raises(SystemExit) as exc:
        cli.main(_argv(tmp_path, *extra))
    assert exc.value.code == 2
    assert f"{flag} is not ported yet" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "ck")  # refused before anything ran


@pytest.mark.parametrize("argv,message", [
    (["report", "l.jsonl"], "'report' subcommand is not ported yet"),
    (["fsck", "ck"], "'fsck' subcommand is not ported yet"),
    (["--workload", "fashion_mlp", "--algorithm", "pbt"], "driver path (no --fused) is not ported yet"),
    (["--workload", "fashion_mlp", "--algorithm", "asha", "--fused"], "--algorithm asha is not ported yet"),
    (["--workload", "fashion_mlp", "--fused"], "--algorithm random is not ported yet"),
    (["--workload", "fashion_mlp", "--algorithm", "pbt", "--fused", "--resume"],
     "--resume requires --checkpoint-dir or --ledger"),
])
def test_cli_refusals_are_usage_errors(argv, message, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
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

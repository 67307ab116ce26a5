"""The port's launch supervisor (``mpi_opt_tpu_torch/launch.py``) and stall
watchdog against the JAX package's: the helpers on the same inputs, the
supervisor's exit-code classes over fake ranks (``python -c`` programs,
no torch), each case run through both supervisors, and the rank argv,
equal to the JAX ``_spawn_ranks``' apart from the module name."""

import json
import os
import random
import subprocess
import sys

import pytest

from mpi_opt_tpu import launch as jlaunch
from mpi_opt_tpu.health.watchdog import StallDetector as JaxStallDetector
from mpi_opt_tpu_torch import launch as tlaunch
from mpi_opt_tpu_torch.health.watchdog import StallDetector

LAUNCHERS = {"port": tlaunch, "jax": jlaunch}


@pytest.mark.parametrize("attempt,base,jitter", [(1, 1.0, 0.5), (2, 1.0, 0.5), (3, 2.0, 0.0),
                                                 (4, 0.5, 0.25), (2, 0.0, 0.5)])
def test_backoff_equals_jax(attempt, base, jitter):
    got = [tlaunch._backoff_s(attempt, base, jitter, random.Random(7)) for _ in range(3)]
    want = [jlaunch._backoff_s(attempt, base, jitter, random.Random(7)) for _ in range(3)]
    assert got == want


def _beat(path, beats, phase=None, stage=None):
    with open(path, "w") as f:
        f.write(json.dumps({"pid": 1, "beats": beats, "ts": 0.0, "phase": phase,
                            "progress": {} if stage is None else {"stage": stage}}))


def test_stall_phases_equal_jax(tmp_path):
    d = str(tmp_path)
    _beat(tlaunch._hb_path(d, 0), 3, phase="train")
    _beat(tlaunch._hb_path(d, 1), 5, stage="boundary:pbt launch 2/3")
    _beat(tlaunch._hb_path(d, 2), 1)
    with open(tlaunch._hb_path(d, 3), "w") as f:
        f.write("{torn")
    ranks = [0, 1, 2, 3, 4]
    assert tlaunch._stall_phases(d, ranks) == jlaunch._stall_phases(d, ranks) == {
        "0": "train", "1": "boundary:pbt launch 2/3", "2": None, "3": None, "4": None}


@pytest.mark.parametrize("phase", [
    "train", "boundary:exploit", "boundary:pbt launch 1/3", "stage_in", "stage_out",
    "staging", None, "", "setup", "save", "driver", "journal",
])
def test_collective_phases_equal_jax(phase):
    assert tlaunch._is_collective_phase(phase) == jlaunch._is_collective_phase(phase)


@pytest.mark.parametrize("stage", [
    "boundary exploit",  # train/engine.py::boundary_span's beat
    "boundary rung_cut",
    "pbt train sub-launch 2/4",  # train/fused_pbt.py's --step-chunk beats
    "staging transfer",  # train/staging.py's stage-out worker
    "pbt gen 1/3 wave 2/4 dispatched",  # a wave, whose state gather follows
    "sha rung 2/3 wave 1/2 dispatched",
])
def test_the_ports_stage_names_are_collective_phases(stage):
    assert tlaunch._is_collective_phase(stage)


@pytest.mark.parametrize("text", [
    '{"event": "launch"}\n{"workload": "w", "best_score": 0.5}\n',
    '{"workload": "w"}\n{"event": "summary", "trials": 3}\nstray print\n',
    '{"preempted": true, "signal": "SIGTERM"}\n',
    "no json here\n",
    '{"a": 1}\n{not json}\n',
    "",
])
def test_find_summary_line_equals_jax(text):
    assert tlaunch._find_summary_line(text) == jlaunch._find_summary_line(text)


def test_stall_detector_equals_jax_on_the_same_files(tmp_path):
    paths = [str(tmp_path / f"rank{i}.hb") for i in range(3)]
    ours, theirs = StallDetector(paths, 5.0), JaxStallDetector(paths, 5.0)
    script = [
        (0.0, {0: 1}),  # rank 0 beats; ranks 1-2 not watched yet
        (2.0, {0: 2, 1: 1}),
        (6.0, {1: 2}),  # rank 0 frozen since t=2: not yet past 5 s
        (7.5, {}),  # rank 0 stale (5.5 s), rank 1 fresh
        (12.0, {0: 3}),  # rank 1 stale now; rank 0 recovered
        (30.0, {2: 1}),
    ]
    for now, beats in script:
        for i, b in beats.items():
            _beat(paths[i], b)
        assert ours.poll(now) == theirs.poll(now), now
    with pytest.raises(ValueError, match="stall_timeout must be > 0"):
        StallDetector(paths, 0)


# -- the supervisor over fake ranks -----------------------------------------

def _fake_spawn(mod, script, calls):
    """``_spawn_ranks`` replaced by ``python -c script LOG_DIR RANK
    EPOCH`` ranks; ``calls`` records each attempt's (rest, coord)."""

    def fake_spawn(n, rest, log_dir, heartbeat=False, coord=None):
        calls.append((list(rest), coord))
        procs = []
        for i in range(n):
            out = open(os.path.join(log_dir, f"rank{i}.out"), "w")
            err = open(os.path.join(log_dir, f"rank{i}.err"), "w")
            epoch = "" if coord is None else str(coord[1])
            hb = mod._hb_path(log_dir, i) if heartbeat else ""
            p = subprocess.Popen([sys.executable, "-c", script, log_dir, str(i), epoch, hb],
                                 stdout=out, stderr=err)
            procs.append((p, out, err))
        return procs

    return fake_spawn


def _main(mod, monkeypatch, tmp_path, script, *flags, rest=("--workload", "quadratic")):
    calls = []
    monkeypatch.setattr(mod, "_spawn_ranks", _fake_spawn(mod, script, calls))
    monkeypatch.setattr(mod.time, "sleep", lambda s: None if s >= 0.5 else _REAL_SLEEP(s))
    rc = mod.main(["--n-proc", "2", "--log-dir", str(tmp_path), "--poll-interval", "0.02",
                   "--term-grace", "2", *flags, "--", *rest])
    return rc, calls


_REAL_SLEEP = __import__("time").sleep

# rank 1 dies in the first attempt (epoch 0), every rank finishes after
_DIE_ONCE = """
import json, sys
log_dir, rank, epoch = sys.argv[1], int(sys.argv[2]), sys.argv[3]
if rank == 1 and epoch == "0":
    raise SystemExit(3)
print(json.dumps({"workload": "w", "rank": rank, "epoch": epoch}))
"""


@pytest.mark.parametrize("which", ["port", "jax"])
def test_rank_death_relaunches_with_resume_and_a_new_epoch(which, tmp_path, monkeypatch, capsys):
    mod = LAUNCHERS[which]
    rc, calls = _main(mod, monkeypatch, tmp_path, _DIE_ONCE, "--retries", "1",
                      rest=("--workload", "quadratic", "--checkpoint-dir", "ck"))
    assert rc == 0
    (rest0, coord0), (rest1, coord1) = calls
    assert "--resume" not in rest0 and rest1[-1] == "--resume"
    assert coord0 == (os.path.join(str(tmp_path), "coord"), 0) and coord1[1] == 1
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [e.get("event") for e in out] == ["launch", "restart", "launch", None, "done"]
    assert out[1]["rank"] == 1 and out[1]["returncode"] == 3
    assert out[3] == {"workload": "w", "rank": 0, "epoch": "1"}  # rank 0's summary relayed


@pytest.mark.parametrize("which", ["port", "jax"])
def test_preemption_relaunches_without_spending_a_retry(which, tmp_path, monkeypatch, capsys):
    script = _DIE_ONCE.replace("SystemExit(3)", "SystemExit(75)")
    rc, calls = _main(LAUNCHERS[which], monkeypatch, tmp_path, script, "--retries", "0",
                      rest=("--workload", "quadratic", "--ledger", "l.jsonl"))
    assert rc == 0 and len(calls) == 2 and calls[1][0][-1] == "--resume"
    events = [json.loads(line).get("event") for line in capsys.readouterr().out.splitlines()]
    assert "preempt_restart" in events and "restart" not in events


@pytest.mark.parametrize("which", ["port", "jax"])
def test_data_error_aborts_without_retrying(which, tmp_path, monkeypatch, capsys):
    rc, calls = _main(LAUNCHERS[which], monkeypatch, tmp_path, "raise SystemExit(65)",
                      "--retries", "5")
    assert rc == 1 and len(calls) == 1
    failed = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert failed["event"] == "failed" and failed["data_error"] is True


@pytest.mark.parametrize("which", ["port", "jax"])
def test_crash_loop_aborts_before_the_budget(which, tmp_path, monkeypatch, capsys):
    rc, calls = _main(LAUNCHERS[which], monkeypatch, tmp_path, "raise SystemExit(3)",
                      "--retries", "50", "--crash-loop-threshold", "3")
    assert rc == 1 and len(calls) == 3
    failed = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert failed["crash_loop"] is True and failed["consecutive_fast_failures"] == 3


# a rank that beats three times, then freezes alive (a wedged collective)
_BEAT_THEN_FREEZE = """
import json, os, sys, time
hb = sys.argv[4]
for b in range(1, 4):
    with open(hb + ".tmp", "w") as f:
        f.write(json.dumps({"pid": os.getpid(), "beats": b, "ts": time.time(),
                            "phase": None, "progress": {"stage": "boundary exploit"}}))
    os.replace(hb + ".tmp", hb)
    time.sleep(0.05)
time.sleep(300)
"""


@pytest.mark.parametrize("which", ["port", "jax"])
def test_stall_is_killed_and_reported(which, tmp_path, monkeypatch, capsys):
    rc, calls = _main(LAUNCHERS[which], monkeypatch, tmp_path, _BEAT_THEN_FREEZE,
                      "--stall-timeout", "0.5", "--retries", "0")
    assert rc == 1 and len(calls) == 1
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    stall = next(e for e in out if e.get("event") == "stall")
    # the first rank past the timeout is reported (the other may still be
    # a poll behind), with the phase its last beat named
    assert stall["ranks"] and set(stall["ranks"]) <= {0, 1}
    assert stall["phases"] == {str(r): "boundary exploit" for r in stall["ranks"]}


def test_rank_argv_equals_the_jax_argv_but_the_module(tmp_path, monkeypatch):
    argvs = {}
    for which, mod in LAUNCHERS.items():
        seen = []

        class FakePopen:
            def __init__(self, argv, stdout=None, stderr=None, text=None):
                seen.append(argv)

        monkeypatch.setattr(mod.subprocess, "Popen", FakePopen)
        monkeypatch.setattr(mod, "_free_port", lambda: 4242)
        d = tmp_path / which
        d.mkdir()
        procs = mod._spawn_ranks(2, ["--workload", "fashion_mlp", "--fused"], str(d),
                                 heartbeat=True, coord=(str(d / "coord"), 3))
        for _, out, err in procs:
            out.close()
            err.close()
        argvs[which] = [[a.replace(str(d), "D") for a in argv] for argv in seen]
    port, jax = argvs["port"], argvs["jax"]
    assert [a[2] for a in port] == ["mpi_opt_tpu_torch"] * 2 and [a[2] for a in jax] == ["mpi_opt_tpu"] * 2
    assert [a[:2] + a[3:] for a in port] == [a[:2] + a[3:] for a in jax]
    assert port[1][3:] == ["--workload", "fashion_mlp", "--fused", "--coordinator", "127.0.0.1:4242",
                           "--num-processes", "2", "--process-id", "1", "--heartbeat-file",
                           "D/rank1.hb", "--coord-dir", "D/coord", "--coord-epoch", "3"]


@pytest.mark.parametrize("flag", ["--coordinator", "--num-processes", "--process-id", "--retries",
                                  "--heartbeat-file", "--coord-dir", "--coord-epoch"])
def test_the_supervisor_owns_the_bring_up_flags(flag, capsys):
    with pytest.raises(SystemExit) as e:
        tlaunch.main(["--n-proc", "2", "--", "--workload", "quadratic", f"{flag}=1"])
    assert e.value.code == 2
    assert f"{flag} is owned by the supervisor" in capsys.readouterr().err

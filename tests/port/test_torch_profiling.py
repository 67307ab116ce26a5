"""The port's launch-window profiling (``mpi_opt_tpu_torch/utils/profiling.py``),
its launch ticks and its CLI flags, on the CPU, against the JAX package.

- ``parse_launch_window`` accepts and refuses what the JAX function
  does, with the same errors;
- ``profile_window`` without a directory writes nothing; a body's
  exception propagates; a window past the last launch closes at exit;
  the module's globals are left cleared;
- a launch is counted as the JAX package counts it: at each tick, the
  number of ``train`` spans already closed is the same sequence in both
  packages, for every fused sweep (resident and in waves; fused SHA in
  waves ticks twice a rung in both) and for the driver's batches (a
  batch served wholly from the ledger's replay is no launch);
- through the CLI, ``--profile-launches 2:2`` writes exactly one trace,
  whose ``train`` range is launch 2's (fused PBT) or batch 2's (the
  driver path); a whole-run window records the staging thread's spans;
- the CLI's usage errors are the JAX CLI's.
"""

import json
import os

import pytest
import torch

import mpi_opt_tpu.cli as jcli
import mpi_opt_tpu.driver as jdriver
import mpi_opt_tpu.ledger as jledger
import mpi_opt_tpu.trial as jtrial
import mpi_opt_tpu.utils.profiling as jprofiling
import torch_port_jax_draws as jd
from mpi_opt_tpu.obs import trace as jtrace
from mpi_opt_tpu.train.fused_asha import fused_sha as jax_fused_sha
from mpi_opt_tpu.train.fused_bohb import fused_bohb as jax_fused_bohb
from mpi_opt_tpu.train.fused_pbt import fused_pbt as jax_fused_pbt
from mpi_opt_tpu.train.fused_tpe import fused_tpe as jax_fused_tpe
from mpi_opt_tpu.workloads import get_workload as jax_get_workload
from mpi_opt_tpu_torch import bench, cli, get_workload
from mpi_opt_tpu_torch import driver as tdriver
from mpi_opt_tpu_torch import trial as ttrial
from mpi_opt_tpu_torch.ledger import SweepLedger
from mpi_opt_tpu_torch.obs import report, trace
from mpi_opt_tpu_torch.train.fused_asha import fused_sha
from mpi_opt_tpu_torch.train.fused_bohb import fused_bohb
from mpi_opt_tpu_torch.train.fused_pbt import fused_pbt
from mpi_opt_tpu_torch.train.fused_tpe import fused_tpe
from mpi_opt_tpu_torch.workloads.vision import Cifar10CNN
from mpi_opt_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _cleared():
    """Every test leaves the profiler and the span sink as it found them:
    a window left installed would profile a later test by surprise."""
    saved = trace.save()
    yield
    trace.deconfigure(saved)
    assert not profiling.active() and profiling._WINDOW is None and profiling._RUN is None


SPECS = ["3", "2:5", "1", "1:1", " 2", "0", "3:2", "a", "1:2:3", "", "2:", ":3", "-1:2", "1.5"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_launch_window_equals_jax(spec):
    def outcome(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return ("ValueError", str(e))

    assert outcome(profiling.parse_launch_window) == outcome(jprofiling.parse_launch_window)


@pytest.mark.parametrize("launches", [None, (1, 2)])
def test_no_directory_writes_nothing(tmp_path, monkeypatch, launches):
    monkeypatch.chdir(tmp_path)
    for directory in (None, ""):
        with profiling.profile_window(directory, launches=launches, device="cpu"):
            for _ in range(3):
                profiling.launch_tick()
                assert not profiling.active()
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("launches", [None, (1, 1), (2, 3)])
def test_a_body_exception_propagates(tmp_path, launches):
    d = tmp_path / "prof"
    with pytest.raises(RuntimeError, match="the body's"):
        with profiling.profile_window(str(d), launches=launches, device="cpu"):
            profiling.launch_tick()
            profiling.launch_tick()
            raise RuntimeError("the body's")
    # the window that opened is closed and written; (2, 3) opened at tick 2
    assert len(os.listdir(d)) == 1


def test_a_window_past_the_last_launch_closes_at_exit(tmp_path):
    d = tmp_path / "prof"
    with profiling.profile_window(str(d), launches=(2, 9), device="cpu"):
        for n in range(1, 4):
            profiling.launch_tick()
            assert profiling.active() == (n >= 2)
    assert not profiling.active()
    host_pid = os.listdir(d)[0].split(".")[0]
    assert os.listdir(d) == [f"{host_pid}.launches_2-9.pt.trace.json"]


def test_windows_and_spans(tmp_path, monkeypatch):
    """Ticks open and close the window (A..B inclusive, 1-based); a span
    enters ``record_function`` only while a window records; a second
    window of one process and name gets its own file."""
    entered = []
    real = torch.profiler.record_function

    def spy(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    d = str(tmp_path / "prof")
    for _ in range(2):
        with profiling.profile_window(d, launches=(2, 3), device="cpu"):
            for n in range(1, 6):
                profiling.launch_tick()
                assert profiling.active() == (2 <= n <= 3)
                with trace.span("train"):
                    pass
    assert entered == ["train", "train"] * 2
    names = sorted(os.listdir(d))
    stem = names[0].split(".")[0]
    assert names == [f"{stem}.launches_2-3.2.pt.trace.json", f"{stem}.launches_2-3.pt.trace.json"]
    with profiling.profile_window(d, device="cpu"):
        assert profiling.active()
    assert f"{stem}.run.pt.trace.json" in os.listdir(d)


def test_a_failed_start_leaves_the_run_unprofiled(tmp_path, capsys):
    blocker = tmp_path / "file"
    blocker.write_text("")
    with profiling.profile_window(str(blocker / "sub"), launches=(1, 1), device="cpu"):
        profiling.launch_tick()
        assert not profiling.active()
    assert "[profile] trace start failed (" in capsys.readouterr().err


# -- launches, counted as the JAX package counts them ---------------------


class Sink:
    def __init__(self):
        self.trains = 0

    def log(self, event, **fields):
        if fields.get("span") == "train":
            self.trains += 1


def _ticks(profiling_mod, trace_mod, run):
    """At each launch tick of ``run()``, the train spans already closed."""
    sink, seen = Sink(), []
    real = profiling_mod.launch_tick

    def tick():
        seen.append(sink.trains)
        real()

    profiling_mod.launch_tick = tick
    prior = trace_mod.configure(sink)
    try:
        run()
    finally:
        trace_mod.deconfigure(prior)
        profiling_mod.launch_tick = real
    return seen


FUSED = {
    "pbt": (jax_fused_pbt, fused_pbt, dict(population=4, generations=3, steps_per_gen=2, gen_chunk=1)),
    "pbt-waves": (jax_fused_pbt, fused_pbt, dict(population=4, generations=3, steps_per_gen=2,
                                                  wave_size=2)),
    "sha-waves": (jax_fused_sha, fused_sha, dict(n_trials=8, min_budget=2, max_budget=8, eta=2,
                                                 wave_size=3)),
    "tpe": (jax_fused_tpe, fused_tpe, dict(n_trials=12, batch=4, budget=2)),
    "tpe-waves": (jax_fused_tpe, fused_tpe, dict(n_trials=12, batch=4, budget=2, wave_size=2)),
    # fused BOHB runs Hyperband's brackets, each a fused SHA
    "bohb": (jax_fused_bohb, fused_bohb, dict(max_budget=4, eta=2)),
}
TICKS = {"pbt": 3, "pbt-waves": 3, "sha-waves": 6, "tpe": 3, "tpe-waves": 3, "bohb": 6}


@pytest.mark.parametrize("case", list(FUSED))
def test_fused_launches_are_counted_as_jax_counts_them(case):
    jfn, tfn, kw = FUSED[case]
    jwl = jax_get_workload("fashion_mlp", n_train=256, n_val=128)
    twl = get_workload("fashion_mlp", n_train=256, n_val=128)
    want = _ticks(jprofiling, jtrace, lambda: jfn(jwl, seed=3, **kw))
    got = _ticks(profiling, trace, lambda: tfn(twl, seed=3, device="cpu", **kw))
    assert got == want and len(got) == TICKS[case]
    if case == "sha-waves":  # a rung ticks, then its wave interval does
        assert got == [0, 0, 1, 1, 2, 2]


class Twin:
    """A scripted backend for either package's driver (scores from
    ``jd.score``); ``evaluate`` calls are counted, and past ``die_after``
    evaluations the next call raises KeyboardInterrupt (a killed run)."""

    name = "twin"

    def __init__(self, trial_mod, capacity, die_after=None):
        self.trial, self.capacity, self.die_after = trial_mod, capacity, die_after
        self.calls = self.evaluated = 0

    def evaluate(self, trials):
        if self.die_after is not None and self.evaluated >= self.die_after:
            raise KeyboardInterrupt("killed")
        self.calls += 1
        self.evaluated += len(trials)
        return [self.trial.TrialResult(t.trial_id, jd.score(t.params, t.budget), t.budget)
                for t in trials]


SIDES = {"jax": (jdriver, jtrial, jprofiling, jtrace, jledger.SweepLedger),
         "port": (tdriver, ttrial, profiling, trace, SweepLedger)}


@pytest.mark.parametrize("name", ["random", "asha", "pbt", "tpe", "hyperband", "bohb"])
def test_driver_batches_are_counted_as_jax_counts_them(name, monkeypatch):
    """Each batch that dispatches trials is a launch, ticked before its
    train span."""
    jd.install(monkeypatch)
    capacity = jd.CASES[name][1]
    jalgo, talgo = jd.pair(name)
    jtwin, ttwin = Twin(jtrial, capacity), Twin(ttrial, capacity)
    want = _ticks(jprofiling, jtrace, lambda: jdriver.run_search(jalgo, jtwin))
    got = _ticks(profiling, trace, lambda: tdriver.run_search(talgo, ttwin))
    assert got == want and len(got) == ttwin.calls == jtwin.calls
    assert got == list(range(len(got)))


def test_replayed_batches_are_not_launches(tmp_path, monkeypatch):
    """A run killed after two batches of four, resumed from its ledger:
    the two replayed batches dispatch nothing and do not tick, in either
    package; the third is launch 1."""
    jd.install(monkeypatch)
    out = {}
    for i, side in enumerate(SIDES):
        drv, trial_mod, prof, tr, ledger_cls = SIDES[side]
        path = str(tmp_path / f"{side}.jsonl")
        for twin in (Twin(trial_mod, 4, die_after=8), Twin(trial_mod, 4)):
            led = ledger_cls(path, read_only=False)
            led.ensure_header({"algorithm": "parity", "seed": 11})
            algo = jd.pair("random", max_trials=10)[i]
            try:
                out[side] = _ticks(prof, tr, lambda: drv.run_search(algo, twin, ledger=led))
            except KeyboardInterrupt:
                pass
            finally:
                led.close()
        out[side] = (out[side], twin.calls, twin.evaluated)
    assert out["port"] == out["jax"] == ([0], 1, 2)


# -- the CLI ---------------------------------------------------------------


def _trace_doc(directory):
    names = os.listdir(directory)
    assert len(names) == 1, names
    with open(os.path.join(directory, names[0])) as f:
        return names[0], json.load(f)


def _ranges(doc, name):
    """(begin, end) epoch seconds of the ``record_function`` ranges
    called ``name`` (the trace's clock is its base time plus ts)."""
    base = doc["baseTimeNanoseconds"] / 1e9
    return [(base + e["ts"] / 1e6, base + (e["ts"] + e["dur"]) / 1e6) for e in doc["traceEvents"]
            if e.get("cat") == "user_annotation" and e.get("name") == name]


def _nearest_train(stream, end, key):
    spans = [r for r in report.load_stream(stream) if r.get("span") == "train"]
    return min(spans, key=lambda r: abs(r["ts"] - end))[key], len(spans)


@pytest.mark.parametrize("argv,key,launches", [
    (["--algorithm", "pbt", "--fused", "--population", "4", "--generations", "3",
      "--steps-per-generation", "2", "--gen-chunk", "1"], "launch", 3),
    (["--algorithm", "random", "--trials", "12", "--budget", "2", "--population", "4"],
     "batch", 3),
], ids=["fused-pbt", "driver"])
def test_cli_window_holds_launch_2_only(tmp_path, capsys, argv, key, launches):
    d, m = str(tmp_path / "prof"), str(tmp_path / "m.jsonl")
    rc = cli.main(["--workload", "fashion_mlp", *argv, "--device", "cpu", "--trace",
                   "--metrics-file", m, "--profile-dir", d, "--profile-launches", "2:2"])
    assert rc == 0
    capsys.readouterr()
    name, doc = _trace_doc(d)
    assert name.endswith(".launches_2-2.pt.trace.json")
    trains = _ranges(doc, "train")
    assert len(trains) == 1
    assert _nearest_train(m, trains[0][1], key) == (2, launches)


def test_a_whole_run_window_records_the_staging_thread(tmp_path, capsys):
    """Every span of a wave sweep enters the trace, the staging worker's
    stage_out on a thread of its own (torch's profile_all_threads)."""
    d, m = str(tmp_path / "prof"), str(tmp_path / "m.jsonl")
    rc = cli.main(["--workload", "fashion_mlp", "--algorithm", "asha", "--fused", "--trials", "8",
                   "--min-budget", "2", "--max-budget", "8", "--eta", "2", "--wave-size", "3",
                   "--device", "cpu", "--trace", "--metrics-file", m, "--profile-dir", d])
    assert rc == 0
    capsys.readouterr()
    name, doc = _trace_doc(d)
    assert name.endswith(".run.pt.trace.json")
    ranges = [(e["name"], e["tid"]) for e in doc["traceEvents"] if e.get("cat") == "user_annotation"]
    spans = [r["span"] for r in report.load_stream(m) if r.get("event") == "span"]
    assert sorted(n for n, _ in ranges) == sorted(spans)
    tids = lambda name: {t for n, t in ranges if n == name}
    assert len(tids("stage_out")) == 1 and tids("stage_out").isdisjoint(tids("train"))


class _NarrowCNN(Cifar10CNN):
    """cifar10_cnn at width 8, so the CPU run takes seconds."""

    width = 8


def test_bench_profiles_the_measured_run(tmp_path, monkeypatch):
    """``--profile-dir`` wraps the measured run only: one generation, so
    one train range (spans enter the window whether or not a sink is
    configured)."""
    monkeypatch.setattr(bench, "get_workload", lambda name: _NarrowCNN(n_train=256, n_val=64))
    d = str(tmp_path / "prof")
    record, _ = bench.run(population=2, generations=1, steps=1, member_chunk=1, device="cpu",
                          traced=False, profile_dir=d)
    name, doc = _trace_doc(d)
    assert name.endswith(".run.pt.trace.json") and record["value"] > 0
    assert len(_ranges(doc, "train")) == 1


BASE = ["--workload", "fashion_mlp", "--algorithm", "pbt", "--fused"]


@pytest.mark.parametrize("extra", [
    ["--profile-launches", "2"],
    ["--profile-dir", "D", "--profile-launches", "0"],
    ["--profile-dir", "D", "--profile-launches", "3:2"],
    ["--profile-dir", "D", "--profile-launches", "x"],
    ["--profile-dir", "D", "--profile-launches", "1:2:3"],
], ids=["no-dir", "zero", "inverted", "malformed", "three-parts"])
def test_cli_usage_errors_equal_the_jax_cli(extra, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    errors = []
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit) as exc:
            main(BASE + extra)
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1])
    assert errors[0] == errors[1]
    assert os.listdir(tmp_path) == []

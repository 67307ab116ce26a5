"""Fault injection in the port (``mpi_opt_tpu_torch/workloads/chaos.py``),
held against the JAX package's ``mpi_opt_tpu/workloads/chaos.py`` and
mirroring ``tests/test_chaos.py``:

- spec parsing and the probability sum;
- the faulted set: the port's ``fault_for`` bit-equal to the live JAX
  ``ChaosWorkload.fault_for`` over 256 sampled params at several seeds
  (params sampled by either package, which have the same Python types),
  ``preempt`` last in the cascade;
- hang and crash reaped as ``timeout`` under ``trial_timeout`` through
  the pool (and counted as stalls), a hang reaped on the isolated
  stateful path;
- a chaos sweep's failures equal the faults ``fault_for`` predicts over
  its trials, and its best equals the clean sweep's;
- ``preempt`` on the in-parent path is a graceful drain;
- against the JAX package on the same trials: the exc/nan and preempt
  drills through both CLIs (every run's exit code and counters, the
  final ledger's records) and a hang and a crash through both
  ``CPUBackend``s (the result statuses);
- the storage and OOM injectors against the port's ``fsck``, its
  snapshot-save and ledger-fsync seams, and its OOM backoff.
"""

import math
import os
import shutil

import numpy as np
import pytest
import torch

import mpi_opt_tpu.workloads.chaos as jchaos
from mpi_opt_tpu.workloads import get_workload as jax_get_workload
from mpi_opt_tpu_torch.algorithms import RandomSearch
from mpi_opt_tpu_torch.backends.cpu import CPUBackend
from mpi_opt_tpu_torch.driver import run_search
from mpi_opt_tpu_torch.utils import integrity, resources
from mpi_opt_tpu_torch.utils.metrics import MetricsLogger
from mpi_opt_tpu_torch.workloads import chaos, get_workload

ALL = {"exc": 0.1, "nan": 0.1, "hang": 0.05, "crash": 0.05, "slow": 0.05, "preempt": 0.1}
CHAOS = {"inner": "quadratic", "exc": 0.12, "nan": 0.08, "seed": 10}


def test_parse_chaos_spec():
    assert chaos.parse_chaos_spec("exc=0.1,nan=0.05,seed=7") == {"exc": 0.1, "nan": 0.05, "seed": 7}
    assert chaos.parse_chaos_spec("hang=1.0,hang_s=30") == {"hang": 1.0, "hang_s": 30.0}
    assert chaos.parse_chaos_spec(" preempt=0.2, slow-s=1 ,seed=3,") == {
        "preempt": 0.2, "slow_s": 1.0, "seed": 3}
    for bad, match in (("explode=0.5", "unknown chaos key"), ("exc", "key=value"),
                       ("exc=1.5", "outside"), ("preempt=-0.1", "outside")):
        with pytest.raises(ValueError, match=match):
            chaos.parse_chaos_spec(bad)
        with pytest.raises(ValueError, match=match):
            jchaos.parse_chaos_spec(bad)
    spec = "exc=0.1,nan=0.1,hang=0.05,crash=0.05,seed=7"
    assert chaos.parse_chaos_spec(spec) == jchaos.parse_chaos_spec(spec)


def test_chaos_probabilities_must_sum_to_one_or_less():
    with pytest.raises(ValueError, match="sum"):
        get_workload("chaos", inner="quadratic", exc=0.7, nan=0.6)


def _sampled(workload, n=256, seed=0):
    algo = RandomSearch(get_workload(workload).default_space(), seed=seed, max_trials=n, budget=1)
    return [t.params for t in algo.next_batch(n)]


@pytest.mark.parametrize("inner", ["quadratic", "digits"])
@pytest.mark.parametrize("seed", [0, 7, 10, 26])
def test_faulted_set_bit_equal_to_jax(inner, seed):
    """Over 256 params sampled by the port and 256 by the JAX package,
    each fault drawn is the JAX draw, every kind occurs, and internal
    keys never change it."""
    from mpi_opt_tpu.algorithms import RandomSearch as JaxRandomSearch

    port = get_workload("chaos", inner=inner, seed=seed, **ALL)
    ref = jax_get_workload("chaos", inner=inner, seed=seed, **ALL)
    jax_params = [t.params for t in JaxRandomSearch(
        jax_get_workload(inner).default_space(), seed=seed, max_trials=256, budget=1).next_batch(256)]
    ours = _sampled(inner, seed=seed)
    assert [type(v) for v in ours[0].values()] == [type(v) for v in jax_params[0].values()]
    for params in (ours, jax_params):
        got = [port.fault_for(p) for p in params]
        assert got == [ref.fault_for(p) for p in params]
        assert set(got) == {None, "exc", "nan", "hang", "crash", "slow", "preempt"}
    p = ours[0]
    assert port.fault_for({**p, "__slot__": 3, "__inherit_from__": 1}) == port.fault_for(p)


def test_preempt_is_last_in_the_cascade():
    """With preempt at 0 every other draw is unchanged; with it on the
    draw stays a pure function of (seed, params)."""
    params = _sampled("quadratic", n=64)
    base = get_workload("chaos", **CHAOS)
    plus = get_workload("chaos", **{**CHAOS, "preempt": 0.0})
    assert [base.fault_for(p) for p in params] == [plus.fault_for(p) for p in params]
    pre = get_workload("chaos", inner="quadratic", preempt=0.3, seed=5)
    draws = [pre.fault_for(p) for p in params]
    assert "preempt" in draws and [pre.fault_for(p) for p in params] == draws
    assert draws == [jax_get_workload("chaos", inner="quadratic", preempt=0.3, seed=5).fault_for(p)
                     for p in params]


def test_injected_exception_is_distinct():
    with pytest.raises(chaos.ChaosInjectedError):
        get_workload("chaos", inner="quadratic", exc=1.0).evaluate({"lr": 0.5, "reg": 0.3}, 10, 0)


def _sweep(workload, workload_kwargs=None, trials=30):
    algo = RandomSearch(workload.default_space(), seed=0, max_trials=trials, budget=20)
    b = CPUBackend(workload, n_workers=2, workload_kwargs=workload_kwargs)
    m = MetricsLogger()
    try:
        res = run_search(algo, b, metrics=m)
    finally:
        b.close()
    return algo, res, m


def test_chaos_sweep_counts_the_predicted_faults_and_keeps_the_best():
    clean_algo, clean_res, _ = _sweep(get_workload("quadratic"))
    wl = get_workload("chaos", **CHAOS)
    algo, res, m = _sweep(wl, workload_kwargs=CHAOS)
    predicted = sum(wl.fault_for(t.params) is not None for t in algo.trials.values())
    assert predicted > 0 and algo.finished()
    s = m.summary()
    assert s["trials_failed"] == res.n_failed == predicted
    assert s["trials_retried"] == 0 and s["trials_timeout"] == 0
    assert res.best is not None and wl.fault_for(clean_res.best.params) is None
    assert res.best.params == clean_res.best.params
    assert res.best.score == clean_res.best.score


def test_hang_and_crash_are_reaped_as_timeouts_and_counted_as_stalls():
    """A hang and a crash through the pool (digits is stateless): both
    come back as ``timeout`` results at their deadlines, the driver
    counts both as stalls, and the pool is recycled."""
    kw = {"inner": "digits", "hang": 0.5, "crash": 0.5, "hang_s": 120.0, "seed": 0}
    wl = get_workload("chaos", **kw)
    algo = RandomSearch(wl.default_space(), seed=0, max_trials=2, budget=20)
    kinds = sorted(wl.fault_for(t.params) for t in RandomSearch(
        wl.default_space(), seed=0, max_trials=2, budget=20).next_batch(2))
    assert kinds == ["crash", "hang"]
    b = CPUBackend(wl, n_workers=2, trial_timeout=1.5, workload_kwargs=kw)
    m = MetricsLogger()
    try:
        res = run_search(algo, b, metrics=m)
        assert b._pool is None  # recycled after the reap
    finally:
        b.close()
    s = m.summary()
    assert s["trials_timeout"] == s["stalls_detected"] == 2 and s["trials_failed"] == 0
    assert res.best is None
    for t in algo.trials.values():
        assert "within 1.5s" in t.error


def test_injected_hang_on_stateful_path_times_out_under_isolation():
    kw = {"inner": "quadratic", "hang": 1.0, "hang_s": 120.0}
    wl = get_workload("chaos", **kw)
    assert wl.stateful
    b = CPUBackend(wl, n_workers=1, trial_timeout=1.5, isolate_stateful=True, workload_kwargs=kw)
    algo = RandomSearch(wl.default_space(), seed=0, max_trials=1, budget=10)
    try:
        (r,) = b.evaluate(algo.next_batch(1))
    finally:
        b.close()
    assert r.status == "timeout" and math.isnan(r.score)
    assert "hung" in r.error
    assert r.wall_time < 2 * 1.5  # the worker's start-up is outside the deadline


def test_preempt_fault_is_graceful_on_in_parent_paths():
    """``preempt`` SIGTERMs this process; under a ShutdownGuard the
    trial completes with its real score and only the drain flag rises."""
    from mpi_opt_tpu_torch.health import ShutdownGuard
    from mpi_opt_tpu_torch.health import shutdown as shutdown_mod

    wl = get_workload("chaos", inner="quadratic", preempt=1.0)
    algo = RandomSearch(wl.default_space(), seed=0, max_trials=1, budget=10)
    b = CPUBackend(wl, n_workers=1)
    try:
        with ShutdownGuard() as g:
            (t,) = algo.next_batch(1)
            (r,) = b.evaluate([t])
            assert r.ok and r.score == get_workload("quadratic").evaluate(t.params, 10, 0)
            assert g.requested and g.signal_name == "SIGTERM"
        assert not shutdown_mod.requested()
    finally:
        b.close()


# -- the storage and OOM injectors ------------------------------------------


def _snapshot_dir(path):
    """A 2-step snapshot directory of the port's layout, whose tensor
    payload is most of ``sweep.pt``, as in a real sweep (a flip in the
    zip's ~1.5 KB of directory records that no reader uses changes no
    content, and no check sees it)."""
    from mpi_opt_tpu_torch.utils.checkpoint import SweepCheckpointer

    ck = SweepCheckpointer(str(path), {"seed": 0, "momentum_dtype": "float32"})
    for s in (1, 2):
        ck.save(s, sweep={"state": {"p": torch.arange(16384, dtype=torch.float32) * s}},
                meta_extra={"gen": s})
    ck.close()
    return str(path)


def _fsck(d):
    import contextlib
    import io
    import json

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = integrity.fsck_main([d, "--json"])
    return rc, json.loads(buf.getvalue())


@pytest.mark.parametrize("kind", ["corrupt", "torn"])
def test_snapshot_injectors_match_jax_and_fsck_catches_them(tmp_path, monkeypatch, kind):
    """The port's injector mangles the newest step's largest file exactly
    as the JAX injector does on a copy of the same directory (the same
    file, the same bit or cut), and the port's fsck then exits 1 naming
    that step, which it passed before."""
    d = _snapshot_dir(tmp_path / "a")
    assert _fsck(d)[0] == 0
    twin = str(tmp_path / "b")
    shutil.copytree(d, twin)
    port_fn = getattr(chaos, f"inject_{kind}_save")
    jax_fn = getattr(jchaos, f"inject_{kind}_save")
    path = port_fn(d, seed=3)
    assert f"{os.sep}2{os.sep}" in path  # the newest step
    monkeypatch.setattr(jchaos, "_resolve_step_dir", lambda directory, step: os.path.join(twin, "2"))
    jpath = jax_fn(twin, seed=3)
    assert os.path.relpath(jpath, twin) == os.path.relpath(path, d)
    assert open(jpath, "rb").read() == open(path, "rb").read()
    rc, rep = _fsck(d)
    assert rc == 1
    assert [(s["step"], s["status"]) for s in rep["steps"]] == [(1, "verified"), (2, "corrupt")]


def test_snapshot_injectors_target_explicit_step_and_refuse_empty_dirs(tmp_path):
    d = _snapshot_dir(tmp_path / "ck")
    assert f"{os.sep}1{os.sep}" in chaos.inject_corrupt_save(d, step=1)
    with pytest.raises(ValueError, match="step 9 not found"):
        chaos.inject_corrupt_save(d, step=9)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(ValueError, match="no committed snapshot steps"):
        chaos.inject_torn_save(str(tmp_path / "empty"))


@pytest.mark.parametrize("n,seed,window", [(0, 0, None), (3, 0, None), (3, 1, 20), (5, 9, 8)])
def test_enospc_schedule_equals_jax(n, seed, window):
    assert chaos._schedule("disk", n, seed, window) == jchaos.SpoolFaultInjector._schedule(
        "disk", n, seed, window)


def test_enospc_on_the_ledger_fsync_and_the_snapshot_save(tmp_path):
    """``inject_enospc`` strikes the port's seams: a ledger fsync raises
    the classified ``StorageFull``; a snapshot save that finds the disk
    full once prunes a superseded step and retries, and one that stays
    full parks with ``StorageFull``."""
    from mpi_opt_tpu_torch.ledger import SweepLedger
    from mpi_opt_tpu_torch.utils.checkpoint import SweepCheckpointer

    inj, uninstall = chaos.inject_enospc(fail_from=0, op="ledger_fsync")
    try:
        ledger = SweepLedger(str(tmp_path / "l.jsonl"), read_only=False)
        with pytest.raises(resources.StorageFull):
            ledger.ensure_header({"algorithm": "random"})
        ledger.close()
    finally:
        uninstall()
    assert inj.faults_fired == 1 and resources._DISK_FAULTS is None

    events = []
    resources.set_observer(lambda e, **f: events.append((e, f)))
    ck = SweepCheckpointer(str(tmp_path / "ck"), {"seed": 0}, keep=3)
    sweep = {"state": {"p": torch.zeros(4)}}
    try:
        ck.save(1, sweep, {})
        ck.save(2, sweep, {})
        inj, uninstall = chaos.inject_enospc(fail=1, op="snapshot_save")
        try:
            ck.save(3, sweep, {})  # full once: step 1 pruned, the retry commits
        finally:
            uninstall()
        assert inj.faults_fired == 1 and ck.all_steps() == [2, 3]
        assert [e for e, _ in events] == ["snapshot_pruned"] and events[0][1]["step"] == 1
        inj, uninstall = chaos.inject_enospc(fail_from=0, op="snapshot_save")
        try:
            with pytest.raises(resources.StorageFull):
                ck.save(4, sweep, {})
        finally:
            uninstall()
    finally:
        resources.clear_observer()
    assert ck.all_steps() == [3]  # one superseded step pruned, the newest kept


def test_inject_oom_drives_the_wave_backoff():
    """``inject_oom`` at the second wave launch: the fused PBT halves its
    wave and re-runs the generation, ending with the unfaulted result;
    at a wave of one there is nothing to halve and ``DeviceOOM``
    propagates."""
    import mpi_opt_tpu_torch.train.fused_pbt as fp

    wl = get_workload("fashion_mlp", n_train=256, n_val=128)
    kw = dict(population=4, generations=2, steps_per_gen=2, seed=2, device="cpu", wave_size=2)
    events = []
    resources.set_observer(lambda e, **f: events.append(e))
    try:
        clean = fp.fused_pbt(wl, **kw)
        inj, uninstall = chaos.inject_oom(at_launch=2, kind="wave")
        try:
            faulted = fp.fused_pbt(wl, oom_backoff=2, **kw)
        finally:
            uninstall()
        assert inj.faults_fired == 1 and events == ["oom_backoff"]
        assert faulted["oom_backoffs"] == 1 and faulted["wave_size"] == 1
        np.testing.assert_array_equal(clean["best_curve"], faulted["best_curve"])
        assert clean["best_params"] == faulted["best_params"]
        inj, uninstall = chaos.inject_oom(at_launch=1)
        try:
            with pytest.raises(resources.DeviceOOM):
                fp.fused_pbt(wl, oom_backoff=2, **{**kw, "wave_size": 1})
        finally:
            uninstall()
    finally:
        resources.clear_observer()
    with pytest.raises(ValueError, match="1-based"):
        chaos.OOMInjector(at_launch=0)


# -- the CLI drills -----------------------------------------------------------


def _cli(argv, main=None):
    """(exit code, JSON lines) of the port's CLI, or of ``main``."""
    import contextlib
    import io
    import json

    from mpi_opt_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rc = (main or cli.main)(argv)
        except SystemExit as e:
            rc = e.code
    return rc, [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]


def _records(path):
    import json

    with open(path) as f:
        recs = [json.loads(x) for x in f]
    keep = ("trial_id", "params", "status", "score", "step")
    return [{k: r[k] for k in keep} for r in recs if "trial_id" in r]


@pytest.mark.parametrize("argv,message", [
    (["--trial-timeout", "0"], "--trial-timeout must be > 0"),
    (["--workers", "-1"], "--workers must be >= 0"),
    (["--backend", "gpu", "--isolate-stateful"], "--isolate-stateful moves the cpu backend"),
    (["--fused", "--isolate-stateful"], "--isolate-stateful moves the cpu backend"),
    (["--backend", "gpu", "--chaos", "exc=0.1"], "--chaos exercises the host driver"),
    (["--chaos", "explode=0.5"], "--chaos: unknown chaos key"),
    (["--chaos", "exc=0.7,nan=0.6"], "--chaos: chaos probabilities sum"),
])
def test_cli_refuses_bad_cpu_backend_flags(argv, message, capsys):
    base = ["--workload", "quadratic", "--algorithm", "random"]
    if "--backend" not in argv:
        base += ["--backend", "cpu"]
    rc, _ = _cli([*base, *argv])
    assert rc == 2
    assert message in capsys.readouterr().err


def test_cli_chaos_drill_counts_the_predicted_faults(tmp_path):
    """The CLI's exc/nan drill on quadratic (in-parent): exit 0, failures
    as ``fault_for`` predicts over the ledger's params, every other
    record as the clean sweep's, and the spec in the ledger's header."""
    import json

    base = ["--backend", "cpu", "--workload", "quadratic", "--trials", "32", "--workers", "4"]
    spec = "exc=0.1,nan=0.1,seed=7"
    rc, clean = _cli([*base, "--ledger", str(tmp_path / "clean.jsonl")])
    assert rc == 0
    rc, out = _cli([*base, "--chaos", spec, "--ledger", str(tmp_path / "chaos.jsonl")])
    assert rc == 0
    wl = get_workload("chaos", inner="quadratic", **chaos.parse_chaos_spec(spec))
    recs = _records(tmp_path / "chaos.jsonl")
    predicted = [r["trial_id"] for r in recs if wl.fault_for(r["params"]) is not None]
    assert predicted and [r["trial_id"] for r in recs if r["status"] != "ok"] == predicted
    assert out[-1]["trials_failed"] == len(predicted) and out[-1]["trials_timeout"] == 0
    # every clean trial scores as in the clean sweep, so the drill's best
    # is the clean sweep's best over the trials it did not fault (here
    # the clean winner itself is faulted)
    clean_recs = _records(tmp_path / "clean.jsonl")
    assert [r for r in recs if r["status"] == "ok"] == [
        r for r in clean_recs if r["trial_id"] not in predicted]
    survivors = max((r for r in clean_recs if r["trial_id"] not in predicted),
                    key=lambda r: r["score"])
    assert out[-1]["best_score"] == round(survivors["score"], 6) != clean[-1]["best_score"]
    assert out[-1]["best_params"] == survivors["params"]
    with open(tmp_path / "chaos.jsonl") as f:
        assert json.loads(f.readline())["config"]["chaos"] == spec


def test_cli_preempt_drill_drains_and_resumes_to_the_clean_records(tmp_path):
    """``preempt`` on the in-parent stateful path: the preempted trial
    completes with its real score and the CLI drains (75); reruns with
    ``--resume`` each make progress until one exits 0, and the ledger
    then holds the records of the same sweep without chaos."""
    base = ["--backend", "cpu", "--workload", "quadratic", "--trials", "16", "--workers", "4"]
    rc, _ = _cli([*base, "--ledger", str(tmp_path / "clean.jsonl")])
    assert rc == 0
    ledger = str(tmp_path / "chaos.jsonl")
    argv = [*base, "--chaos", "preempt=0.2,seed=3", "--ledger", ledger]
    rcs, sizes = [], []
    for _ in range(8):
        rc, out = _cli(argv + (["--resume"] if rcs else []))
        rcs.append(rc)
        sizes.append(len(_records(ledger)))
        if rc != 75:
            break
        assert out[-1]["preempted"] is True
    assert rcs[0] == 75 and rcs[-1] == 0 and set(rcs[:-1]) == {75}
    # every drained run journaled more than the one before it
    assert sizes[0] > 0 and all(sizes[i] > sizes[i - 1] for i in range(1, len(sizes) - 1))
    assert _records(ledger) == _records(tmp_path / "clean.jsonl")


# -- against the JAX package: the same drills, the same trials -----------------


def _jax_params(monkeypatch, workload):
    """The port's host algorithms fed JAX's draws, and its params made by
    the JAX space's own transform: LogUniform's float32 ``exp`` differs
    by an ulp between XLA and torch on some draws, and the fault draw
    hashes ``repr`` of the params, so one ulp would move a trial's fault."""
    import torch_port_jax_draws
    from mpi_opt_tpu_torch import space as tspace

    torch_port_jax_draws.install(monkeypatch)
    jspace = jax_get_workload(workload).default_space()

    def materialize_row(self, u_row):
        assert self.names == list(jspace.names)
        return jspace.materialize_row(np.asarray(u_row))

    monkeypatch.setattr(tspace.SearchSpace, "materialize_row", materialize_row)


_COUNTERS = ("n_trials", "trials_failed", "trials_retried", "trials_timeout", "replayed",
             "preempted", "best_score", "best_params")


@pytest.mark.parametrize("spec,trials", [("exc=0.1,nan=0.1,seed=7", 32),
                                         ("preempt=0.2,seed=3", 16)])
def test_cli_drill_against_the_jax_cli(spec, trials, tmp_path, monkeypatch):
    """A drill through the JAX CLI and the port's on ``quadratic`` (the
    in-parent stateful path), rerun with ``--resume`` while it exits 75:
    every run's exit code and summary counters, and the final ledger's
    records (id, params, status, score, step), are equal."""
    from mpi_opt_tpu.cli import main as jax_main

    argv = ["--backend", "cpu", "--workload", "quadratic", "--trials", str(trials),
            "--workers", "4", "--chaos", spec]

    def drill(main, name):
        ledger = str(tmp_path / f"{name}.jsonl")
        runs = []
        for _ in range(8):
            rc, out = _cli([*argv, "--ledger", ledger] + (["--resume"] if runs else []), main)
            runs.append((rc, {k: out[-1].get(k) for k in _COUNTERS}))
            if rc != 75:
                break
        return runs, _records(ledger)

    want = drill(jax_main, "jax")
    _jax_params(monkeypatch, "quadratic")
    got = drill(None, "port")
    assert got == want
    runs, recs = want
    assert len(recs) == trials and runs[-1][0] == 0
    faulted = [r for r in recs if r["status"] != "ok"]
    if "preempt" in spec:
        assert runs[0] == (75, {**dict.fromkeys(_COUNTERS), "preempted": True}) and not faulted
    else:
        assert len(runs) == 1 and runs[0][1]["trials_failed"] == len(faulted) > 0


def test_hang_and_crash_statuses_equal_the_jax_backend(monkeypatch):
    """The same hang and crash trials (digits: the pool path) through the
    JAX ``CPUBackend`` and the port's, each with two workers and a 1.5 s
    deadline: the same result statuses, steps and NaN scores."""
    from mpi_opt_tpu.algorithms import RandomSearch as JaxRandomSearch
    from mpi_opt_tpu.backends.cpu import CPUBackend as JaxCPUBackend

    monkeypatch.setenv("MPI_OPT_TPU_CPU_CACHE_DIR", "")  # JAX's workers: no compile cache
    kw = {"inner": "digits", "hang": 0.5, "crash": 0.5, "hang_s": 120.0, "seed": 1}
    jwl = jax_get_workload("chaos", **kw)
    jtrials = JaxRandomSearch(jwl.default_space(), seed=0, max_trials=2, budget=20).next_batch(2)
    assert sorted(jwl.fault_for(t.params) for t in jtrials) == ["crash", "hang"]
    _jax_params(monkeypatch, "digits")
    trials = RandomSearch(get_workload("digits").default_space(), seed=0, max_trials=2,
                          budget=20).next_batch(2)
    assert [t.params for t in trials] == [t.params for t in jtrials]

    def statuses(backend, batch):
        try:
            res = backend.evaluate(batch)
        finally:
            backend.close()
        return [(r.trial_id, r.status, r.step, math.isnan(r.score)) for r in res]

    want = statuses(JaxCPUBackend(jwl, n_workers=2, trial_timeout=1.5, workload_kwargs=kw), jtrials)
    got = statuses(CPUBackend(get_workload("chaos", **kw), n_workers=2, trial_timeout=1.5,
                              workload_kwargs=kw), trials)
    assert got == want == [(0, "timeout", 20, True), (1, "timeout", 20, True)]

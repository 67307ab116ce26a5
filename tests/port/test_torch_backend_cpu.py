"""The CPU backend of the port (``mpi_opt_tpu_torch/backends/cpu.py``),
mirroring ``tests/test_backends_cpu.py`` on the port: pool and inline
evaluation, warm resume and inheritance, the failure, NaN and timeout
contracts, the isolated stateful worker equal to the in-parent path
exactly, a dead worker respawned. Every workload evaluates on the CPU
(the backend asks for it); the pool's workers are spawned processes,
kept to a few here (each imports torch)."""

import os
import queue

import numpy as np
import pytest
import torch

from mpi_opt_tpu_torch.backends import available_backends, cpu, get_backend
from mpi_opt_tpu_torch.backends.cpu import CPUBackend, _clean
from mpi_opt_tpu_torch.trial import Trial
from mpi_opt_tpu_torch.workloads import get_workload

DIGITS = {"C": 1.0, "tol": 1e-4, "fit_intercept": True}


def _trial(tid, params, budget, space):
    unit = space.params_to_unit({k: v for k, v in params.items() if not k.startswith("__")})
    return Trial(trial_id=tid, params=params, unit=unit, budget=budget)


def test_backend_registry():
    assert {"cpu", "gpu"} <= set(available_backends())
    with pytest.raises(ValueError, match="unknown backend"):
        get_backend("tpu", get_workload("quadratic"))


def test_clean_strips_internal_keys():
    assert _clean({"lr": 1.0, "__slot__": 3, "__inherit_from__": None}) == {"lr": 1.0}


def test_backend_asks_its_workload_for_the_cpu():
    """The inline and in-parent paths run in the caller's process: the
    backend sets the workload's per-trial device to the CPU when it is
    built, so ``--backend cpu`` never trains on the card."""
    wl = get_workload("fashion_mlp")
    assert wl.eval_device is None  # the card, by default
    CPUBackend(wl, n_workers=1).close()
    assert wl.eval_device == "cpu"
    chaos = get_workload("chaos", inner="fashion_mlp")
    CPUBackend(chaos, n_workers=1).close()
    assert chaos.inner.eval_device == "cpu"


def test_stateless_pool_and_inline_evaluation_agree():
    """Two trials through a pool of two spawned workers, and the same
    trials inline (one worker, no deadline: in this process): ordered
    results, the same scores."""
    wl = get_workload("digits")
    space = wl.default_space()
    trials = [_trial(0, dict(DIGITS), 60, space),
              _trial(1, {**DIGITS, "C": 0.01}, 60, space)]
    b = CPUBackend(wl, n_workers=2)
    try:
        pooled = b.evaluate(trials)
        assert len(b.worker_pids) == 2
        reports = b.worker_report()
        assert sorted(reports) == sorted(b.worker_pids)
        assert all(r == {"CUDA_VISIBLE_DEVICES": "", "cuda_initialized": False, "device_count": 0}
                   for r in reports.values())
    finally:
        b.close()
    assert b.worker_pids == []
    inline = CPUBackend(wl, n_workers=1).evaluate(trials)
    assert [r.trial_id for r in pooled] == [0, 1]
    assert 0.5 < pooled[0].score <= 1.0
    assert [r.score for r in pooled] == [r.score for r in inline]


_EXIT_CHILD = """
import sys
from multiprocessing import forkserver, resource_tracker
from mpi_opt_tpu_torch.backends.cpu import CPUBackend
from mpi_opt_tpu_torch.trial import Trial
from mpi_opt_tpu_torch.workloads import get_workload
if __name__ == "__main__":
    wl = get_workload("digits")
    params = {"C": 1.0, "tol": 1e-4, "fit_intercept": True}
    b = CPUBackend(wl, n_workers=1, trial_timeout=60.0)
    (r,) = b.evaluate([Trial(0, params, wl.default_space().params_to_unit(params), 5)])
    b.close()
    print(r.status, forkserver._forkserver._forkserver_pid,
          resource_tracker._resource_tracker._pid)
"""


def test_the_fork_server_and_resource_tracker_end_with_the_process(tmp_path):
    """A process that used the pool leaves no process behind when it
    exits: the fork server (which preloads torch, so takes a moment to
    unload it) and the resource tracker are stopped and waited for at
    exit, not left to notice on their own. The child's output goes to a
    file, since both would hold a pipe open and a reader would wait them
    out."""
    import subprocess
    import sys

    out = tmp_path / "out.txt"
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with open(out, "w") as f:
        rc = subprocess.run([sys.executable, "-c", _EXIT_CHILD], cwd=root, stdout=f,
                            stderr=subprocess.STDOUT, timeout=240).returncode
    text = out.read_text()
    assert rc == 0, text
    status, *pids = text.split()[-3:]
    assert status == "ok", text
    left = [pid for pid in pids if os.path.exists(f"/proc/{pid}")]
    assert not left, f"processes {left} outlived the process that started them"

def test_stateful_warm_resume_matches_budget():
    """Training 10 then resuming to 30 == training 30 from scratch."""
    wl = get_workload("quadratic")
    space = wl.default_space()
    b = CPUBackend(wl, n_workers=1)
    params = {"lr": 0.5, "reg": 0.3}
    t = _trial(0, dict(params), 10, space)
    r10 = b.evaluate([t])[0]
    t.budget = 30
    r30_resumed = b.evaluate([t])[0]
    r30_scratch = CPUBackend(wl, n_workers=1).evaluate([_trial(1, dict(params), 30, space)])[0]
    assert r30_resumed.score == pytest.approx(r30_scratch.score, rel=1e-9)
    assert r30_resumed.score > r10.score  # more budget, better score (lr < 1)


def test_stateful_inheritance_copies_source_state():
    wl = get_workload("quadratic")
    space = wl.default_space()
    b = CPUBackend(wl, n_workers=1)
    b.evaluate([_trial(0, {"lr": 1.0, "reg": 0.3, "__inherit_from__": None, "__slot__": 0}, 5,
                       space)])
    # the child inherits t0's converged weights and trains 0 more steps
    (r1,) = b.evaluate([_trial(1, {"lr": 1e-3, "reg": 0.3, "__inherit_from__": 0, "__slot__": 1},
                               5, space)])
    assert r1.score > -0.05


def test_state_store_is_fifo_bounded_and_reset_clears_it():
    wl = get_workload("quadratic")
    space = wl.default_space()
    b = CPUBackend(wl, n_workers=1, max_states=3)
    for tid in range(5):
        b.evaluate([_trial(tid, {"lr": 0.5, "reg": 0.3}, 4, space)])
    assert list(b._states) == [2, 3, 4] and sorted(b._trained) == [2, 3, 4]
    b.reset()
    assert not b._states and not b._trained


def test_inline_exception_becomes_failed_result():
    wl = get_workload("chaos", inner="digits", exc=1.0)
    b = CPUBackend(wl, n_workers=1)
    (r,) = b.evaluate([_trial(0, dict(DIGITS), 10, wl.default_space())])
    b.close()
    assert r.status == "failed"
    assert "ChaosInjectedError" in r.error
    assert np.isnan(r.score)


def test_stateful_exception_becomes_failed_and_stores_no_state():
    wl = get_workload("chaos", inner="quadratic", exc=1.0)
    b = CPUBackend(wl, n_workers=1)
    (r,) = b.evaluate([_trial(7, {"lr": 0.5, "reg": 0.3}, 10, wl.default_space())])
    b.close()
    assert r.status == "failed" and not r.ok
    assert 7 not in b._states


@pytest.mark.parametrize("inner,params", [("quadratic", {"lr": 0.5, "reg": 0.3}),
                                          ("digits", DIGITS)])
def test_nan_score_becomes_failed(inner, params):
    wl = get_workload("chaos", inner=inner, nan=1.0)
    b = CPUBackend(wl, n_workers=1)
    (r,) = b.evaluate([_trial(0, dict(params), 10, wl.default_space())])
    b.close()
    assert r.status == "failed"
    assert "non-finite" in r.error
    assert np.isnan(r.score)


def test_trial_timeout_validation():
    with pytest.raises(ValueError, match="trial_timeout"):
        CPUBackend(get_workload("quadratic"), n_workers=1, trial_timeout=0.0)


def test_stateful_trial_timeout_warns_unenforceable():
    wl = get_workload("quadratic")
    b = CPUBackend(wl, n_workers=1, trial_timeout=5.0)
    with pytest.warns(UserWarning, match="cannot be enforced for stateful"):
        (r,) = b.evaluate([_trial(0, {"lr": 0.5, "reg": 0.3}, 10, wl.default_space())])
    b.close()
    assert r.ok


# -- process-isolated stateful evaluation (--isolate-stateful) ---------------


def test_isolated_stateful_matches_in_parent_exactly():
    """The isolated worker runs the same ``_stateful_eval``: warm resume,
    inheritance and ``reset`` give bit-equal scores to the in-parent
    path, and no unenforceable-timeout warning fires."""
    import warnings

    wl = get_workload("quadratic")
    space = wl.default_space()
    params = {"lr": 0.5, "reg": 0.3}

    def run(backend):
        t = _trial(0, dict(params), 10, space)
        r10 = backend.evaluate([t])[0]
        t.budget = 30
        r30 = backend.evaluate([t])[0]  # warm resume to 30
        rc = backend.evaluate([_trial(1, {**params, "__inherit_from__": 0}, 30, space)])[0]
        backend.reset()  # the store is gone: trial 0 at 30 trains from scratch
        rr = backend.evaluate([_trial(0, dict(params), 30, space)])[0]
        return (r10.score, r30.score, rc.score, rr.score)

    b_in = CPUBackend(wl, n_workers=1)
    b_iso = CPUBackend(wl, n_workers=1, isolate_stateful=True, trial_timeout=60.0)
    try:
        ref = run(b_in)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            iso = run(b_iso)
        assert list(b_iso.worker_report()) == b_iso.worker_pids
    finally:
        b_in.close()
        b_iso.close()
    assert iso == ref
    assert b_iso.worker_pids == []


def test_isolated_stateful_worker_death_fails_trial_and_respawns():
    """A worker dying hard mid-trial (chaos crash) fails the trial at
    once (the pipe's EOF is the signal); the next trial respawns a
    fresh worker."""
    kw = {"inner": "quadratic", "crash": 0.5, "seed": 1}
    wl = get_workload("chaos", **kw)
    space = wl.default_space()
    crash_p = clean_p = None
    for i in range(200):
        p = {"lr": 0.1 + i * 0.007, "reg": 0.3}
        f = wl.fault_for(p)
        if f == "crash" and crash_p is None:
            crash_p = p
        elif f is None and clean_p is None:
            clean_p = p
        if crash_p and clean_p:
            break
    b = CPUBackend(wl, n_workers=1, isolate_stateful=True, trial_timeout=60.0,
                   workload_kwargs=kw)
    try:
        (r,) = b.evaluate([_trial(0, dict(crash_p), 10, space)])
        assert not r.ok and r.status == "failed"
        assert "died" in r.error
        (r2,) = b.evaluate([_trial(1, dict(clean_p), 10, space)])
        assert r2.ok
        assert r2.score == get_workload("quadratic").evaluate(clean_p, 10, 0)
    finally:
        b.close()


def test_a_worker_that_sees_a_card_refuses_to_start(monkeypatch):
    """A worker hides the card before CUDA can initialise; one that
    still sees a device raises instead of training on it quietly."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="can see a CUDA device"):
        cpu._init_worker("quadratic", {}, 1)
    assert os.environ["CUDA_VISIBLE_DEVICES"] == ""
    ready = queue.Queue()
    monkeypatch.setattr(cpu, "_WORKER_ERROR", None)
    cpu._init_pool_worker("quadratic", {}, 1, ready)
    pid, err, probe = ready.get_nowait()
    assert pid == os.getpid() and "can see a CUDA device" in err
    assert probe["CUDA_VISIBLE_DEVICES"] == "" and not probe["cuda_initialized"]
    with pytest.raises(RuntimeError, match="failed to start"):
        cpu._eval_one((0, {"lr": 0.5, "reg": 0.3}, 1, 0))
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.delenv("OPENBLAS_NUM_THREADS", raising=False)
    with cpu._worker_env():
        assert os.environ["CUDA_VISIBLE_DEVICES"] == "" and os.environ["OPENBLAS_NUM_THREADS"] == "1"
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0" and "OPENBLAS_NUM_THREADS" not in os.environ


def test_a_worker_refuses_a_fork_server_started_outside_the_backend(monkeypatch):
    """Workers inherit the fork server's environment and preloads, which
    are fixed when it first starts: one started without one BLAS thread
    or without scipy's optimisers preloaded makes every worker refuse to
    start; with both, the worker builds its workload for the CPU."""
    import sys

    import scipy.optimize  # noqa: F401  (preloaded in a real worker)

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setattr(cpu, "_WORKER_WORKLOAD", None)
    monkeypatch.delenv("OPENBLAS_NUM_THREADS", raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with pytest.raises(RuntimeError, match="fork server was started outside"):
        cpu._init_worker("quadratic", {}, 1)
    monkeypatch.setenv("OPENBLAS_NUM_THREADS", "1")
    monkeypatch.delitem(sys.modules, "scipy.optimize")
    with pytest.raises(RuntimeError, match="scipy.optimize preloaded: False"):
        cpu._init_worker("quadratic", {}, 1)
    monkeypatch.undo()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setattr(cpu, "_WORKER_WORKLOAD", None)
    for k, v in cpu._WORKER_ENV.items():
        monkeypatch.setenv(k, v)
    threads = torch.get_num_threads()
    try:
        cpu._init_worker("fashion_mlp", {}, 1)
    finally:
        torch.set_num_threads(threads)
    assert cpu._WORKER_WORKLOAD.name == "fashion_mlp" and cpu._WORKER_WORKLOAD.eval_device == "cpu"


def test_a_pool_whose_workers_fail_to_start_raises():
    """The pool waits for every worker's start-up report: a worker that
    cannot build its workload fails the evaluation loudly, before any
    trial is sent."""
    wl = get_workload("digits")
    b = CPUBackend(wl, n_workers=1, trial_timeout=30.0, workload_kwargs={"no_such_arg": 1})
    try:
        with pytest.raises(RuntimeError, match="worker failed to start: TypeError"):
            b.evaluate([_trial(0, dict(DIGITS), 10, wl.default_space())])
        assert b._pool is None
    finally:
        b.close()

"""The CPU backend (port of ``mpi_opt_tpu/backends/cpu.py``): trials
evaluated one a process, on the host.

The JAX package's default path, rebuilt on ``multiprocessing`` as the
reference's MPI ranks (a coordinator sends hyperparameters to workers,
which train and report a score). It never trains on the card:

- the backend sets its workload's per-trial evaluation to the CPU when
  it is constructed (``Workload.set_eval_device("cpu")``), so the inline
  and in-parent paths, which run in this process, train CPU tensors;
- workers never fork this process (forking a process with CUDA
  initialised breaks CUDA in the child): they are forks of a fork
  server, a fresh interpreter started like a spawned child with the card
  hidden, which imports torch and the port once and never touches CUDA.
  A worker starts in a fraction of a second instead of paying ``import
  torch`` (seconds) again, which matters each time a reaped pool is
  rebuilt. Each worker hides the card again before anything can
  initialise CUDA, refuses to start if one is still visible, and
  rebuilds the workload by registry name, for the CPU. The fork server
  and multiprocessing's resource tracker are stopped, and waited for,
  when this process exits (``stop_fork_server``): neither outlives it.

Two paths:
- stateless (random/TPE/ASHA from scratch): trials fan out to a process
  pool, one async job a trial, so a raising trial never takes its batch
  with it; under ``trial_timeout`` a hung or crashed worker's job is
  reaped as ``timeout`` and the pool rebuilt;
- stateful (PBT inheritance, ASHA warm resume): the training states
  persist between evaluations, in a FIFO-bounded store. By default they
  live in this process and training runs here: sequential, and no
  deadline can interrupt it. ``isolate_stateful=True`` moves the path,
  store included, into one worker process: the same semantics, and a
  hung trial is reaped as ``timeout`` and the worker respawned (its
  store resets, so successors of lost states retrain from scratch).

Threads: a worker's torch intra-op threads are ``os.cpu_count() //
n_workers`` (at least 1) and its BLAS (numpy, scipy) one thread, so a
pool does not oversubscribe the host.

Every worker reports on start-up what it knows of CUDA
(``worker_report``): a worker that starts with no visible device can
never hold a CUDA context, since the CUDA driver fixes its device list
when it first initialises.
"""

from __future__ import annotations

import contextlib
import math
import multiprocessing as mp
import multiprocessing.util as mp_util
import os
import queue
import sys
import time
from collections import OrderedDict
from typing import Any, Sequence

from mpi_opt_tpu_torch.backends.base import Backend, register_backend
from mpi_opt_tpu_torch.trial import Trial, TrialResult, failed_result

_WORKER_WORKLOAD = None
_WORKER_ERROR: str | None = None  # why this pool worker could not start
_STOP_AT_EXIT = None  # the exit finaliser that runs stop_fork_server


def _context():
    """The fork-server context every worker starts from, preloaded with
    this module (torch and the port) and scipy's optimisers (the digits
    fit's; ~2 s to import), so a worker's first trial does not pay them
    against its deadline. Its first use arranges for the fork server and
    the resource tracker to be stopped when this process exits."""
    global _STOP_AT_EXIT
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload([__name__, "scipy.optimize"])
    if _STOP_AT_EXIT is None:
        # negative exit priorities run last: after multiprocessing has
        # released this process's semaphores and terminated and joined
        # its daemonic workers
        _STOP_AT_EXIT = mp_util.Finalize(None, _stop_helpers, exitpriority=-1)
    return ctx


def stop_fork_server() -> None:
    """Stop multiprocessing's fork server and wait for it to exit. Call
    it only once every backend is closed: a live worker keeps the fork
    server up. The next backend starts it again."""
    from multiprocessing import forkserver

    forkserver._forkserver._stop()


def _stop_helpers() -> None:
    """Stop the fork server and the resource tracker, both children of
    this process, and wait for them. Otherwise they outlive it (the fork
    server by the time it takes to unload torch), holding its standard
    streams."""
    from multiprocessing import resource_tracker

    stop_fork_server()
    resource_tracker._resource_tracker._stop()  # exits once nothing holds its pipe


# a worker's environment: no CUDA device, and one BLAS thread (numpy's and
# scipy's; torch's intra-op threads are set per worker)
_WORKER_ENV = {"CUDA_VISIBLE_DEVICES": "", "OPENBLAS_NUM_THREADS": "1", "OMP_NUM_THREADS": "1"}


@contextlib.contextmanager
def _worker_env():
    """Start the fork server in ``_WORKER_ENV`` if this is its first use;
    this process keeps its own environment. The fork server is one a
    process and keeps the environment and preload list it started with,
    and its children inherit them: a fork server that something else
    started first would give workers neither, so ``_init_worker``
    checks both and refuses to start without them."""
    old = {k: os.environ.get(k) for k in _WORKER_ENV}
    os.environ.update(_WORKER_ENV)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def _cuda_probe() -> dict:
    """What this process knows of CUDA."""
    import torch

    return {"CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "cuda_initialized": torch.cuda.is_initialized(),
            "device_count": torch.cuda.device_count()}


def _init_worker(workload_name: str, workload_kwargs: dict, n_threads: int):
    """Set up a worker process (never the parent): hide the card before
    CUDA can initialise, refuse to go on if one is still visible or if
    the fork server did not start in ``_WORKER_ENV`` with scipy's
    optimisers preloaded, then build the workload for the CPU."""
    global _WORKER_WORKLOAD
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch

    if torch.cuda.is_available():
        raise RuntimeError("a cpu backend worker can see a CUDA device; it must not use one")
    env = {k: os.environ.get(k) for k in _WORKER_ENV if k != "CUDA_VISIBLE_DEVICES"}
    if any(v != _WORKER_ENV[k] for k, v in env.items()) or "scipy.optimize" not in sys.modules:
        raise RuntimeError(
            f"the fork server was started outside the cpu backend (worker environment {env}, "
            f"scipy.optimize preloaded: {'scipy.optimize' in sys.modules}); a worker would run "
            "several BLAS threads and import scipy against its first trial's deadline")
    torch.set_num_threads(max(1, n_threads))
    from mpi_opt_tpu_torch.workloads import get_workload

    _WORKER_WORKLOAD = get_workload(workload_name, **workload_kwargs)
    _WORKER_WORKLOAD.set_eval_device("cpu")


def _init_pool_worker(workload_name: str, workload_kwargs: dict, n_threads: int, ready):
    """Pool initialiser: reports ``(pid, error or None, _cuda_probe())``
    on ``ready``. A failure is kept for every job too, since a pool whose
    initialiser raises respawns the worker forever."""
    global _WORKER_ERROR
    try:
        _init_worker(workload_name, workload_kwargs, n_threads)
    except Exception as e:
        _WORKER_ERROR = f"{type(e).__name__}: {e}"
    ready.put((os.getpid(), _WORKER_ERROR, _cuda_probe()))


def _eval_one(args):
    """Evaluate one job; a trial's exception never escapes the worker
    (it becomes a failed result where it happens), and a non-finite
    score is failed too."""
    trial_id, params, budget, seed = args
    if _WORKER_ERROR is not None:
        raise RuntimeError(f"cpu backend worker failed to start: {_WORKER_ERROR}")
    t0 = time.perf_counter()
    try:
        score = float(_WORKER_WORKLOAD.evaluate(params, budget, seed))
    except Exception as e:
        return failed_result(trial_id, budget, f"{type(e).__name__}: {e}",
                             wall_time=time.perf_counter() - t0)
    if not math.isfinite(score):
        return failed_result(trial_id, budget, f"non-finite score {score!r}", score=score,
                             wall_time=time.perf_counter() - t0)
    return TrialResult(trial_id=trial_id, score=score, step=budget,
                       wall_time=time.perf_counter() - t0)


def _stateful_eval(workload, states: "OrderedDict[int, Any]", trained: dict, max_states: int,
                   trial_id: int, raw_params: dict, budget: int, seed: int) -> TrialResult:
    """One stateful evaluation against a (states, trained) store: the
    one implementation behind the in-parent path and the isolated
    worker, so their warm-resume and inheritance cannot drift apart."""
    t0 = time.perf_counter()
    params = _clean(raw_params)
    src = raw_params.get("__inherit_from__")
    if src is not None and src in states:
        state = states[src]
        done = trained.get(src, 0)
    elif trial_id in states:
        state = states[trial_id]
        done = trained[trial_id]
    else:
        state = workload.init_state(params, seed)
        done = 0
    remaining = max(0, budget - done)
    try:
        state, score = workload.train(state, params, remaining, seed)
    except Exception as e:
        # a failed member's state is not stored: a successor inheriting
        # from it would resume a half-trained wreck
        return failed_result(trial_id, budget, f"{type(e).__name__}: {e}",
                             wall_time=time.perf_counter() - t0)
    if not math.isfinite(float(score)):
        return failed_result(trial_id, budget, f"non-finite score {float(score)!r}",
                             score=float(score), wall_time=time.perf_counter() - t0)
    states[trial_id] = state
    states.move_to_end(trial_id)
    trained[trial_id] = budget
    while len(states) > max_states:
        old, _ = states.popitem(last=False)
        trained.pop(old, None)
    return TrialResult(trial_id=trial_id, score=float(score), step=budget,
                       wall_time=time.perf_counter() - t0)


def _stateful_worker_main(conn, workload_name, workload_kwargs, seed, max_states, n_threads):
    """The isolated stateful worker (a child process). It owns the store;
    jobs arrive as ``(trial_id, raw_params, budget)`` and leave as
    results, ``"reset"`` clears the store, ``None`` exits. The first
    message, ``("ready", pid, _cuda_probe())``, keeps the child's
    start-up out of any trial's deadline."""
    try:
        _init_worker(workload_name, workload_kwargs, n_threads)
    # sweeplint: disable=drain-swallow -- worker process: no drain protocol here; init failure is reported to the parent over the pipe and the worker exits
    except BaseException as e:
        try:
            conn.send(("init_failed", f"{type(e).__name__}: {e}"))
        finally:
            return
    states: "OrderedDict[int, Any]" = OrderedDict()
    trained: dict = {}
    conn.send(("ready", os.getpid(), _cuda_probe()))
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            return
        if msg is None:
            return
        if msg == "reset":
            states.clear()
            trained.clear()
            conn.send("reset_ok")
            continue
        trial_id, raw_params, budget = msg
        conn.send(_stateful_eval(_WORKER_WORKLOAD, states, trained, max_states,
                                 trial_id, raw_params, budget, seed))


@register_backend
class CPUBackend(Backend):
    name = "cpu"

    def __init__(
        self,
        workload,
        n_workers: int = 0,  # 0 -> os.cpu_count()
        seed: int = 0,
        workload_kwargs: dict | None = None,
        max_states: int = 256,
        trial_timeout: float | None = None,  # seconds a trial, None = unbounded
        isolate_stateful: bool = False,  # the stateful path in a worker process
    ):
        super().__init__(workload)
        workload.set_eval_device("cpu")
        self.n_workers = n_workers or (os.cpu_count() or 1)
        self.seed = seed
        if trial_timeout is not None and trial_timeout <= 0:
            raise ValueError(f"trial_timeout must be > 0, got {trial_timeout}")
        self.trial_timeout = trial_timeout
        self.isolate_stateful = bool(isolate_stateful)
        self._workload_kwargs = workload_kwargs or {}
        self._threads = max(1, (os.cpu_count() or 1) // self.n_workers)
        self._pool = None
        self._ready = None
        self._stateful_proc = None
        self._stateful_conn = None
        self._warned_stateful_timeout = False
        self._reports: dict[int, dict] = {}  # worker pid -> its start-up _cuda_probe()
        # trial_id -> training state, FIFO-bounded: PBT mints new ids every
        # generation, and inheritance reaches one generation back
        self.max_states = max_states
        self._states: "OrderedDict[int, Any]" = OrderedDict()
        self._trained: dict[int, int] = {}  # trial_id -> steps completed

    @property
    def capacity(self) -> int:
        return self.n_workers

    @property
    def worker_pids(self) -> list[int]:
        """Pids of the live worker processes (pool and isolated)."""
        pids = [p.pid for p in getattr(self._pool, "_pool", None) or [] if p.is_alive()]
        if self._stateful_proc is not None and self._stateful_proc.is_alive():
            pids.append(self._stateful_proc.pid)
        return pids

    def worker_report(self, timeout: float = 10.0) -> dict[int, dict | None]:
        """The start-up report (``_cuda_probe``) of every worker this
        backend has started, by pid, and ``None`` for a live worker that
        has not reported within ``timeout`` (workers the pool respawned
        report as they come up)."""
        deadline = time.monotonic() + timeout
        while self._ready is not None:
            missing = set(self.worker_pids) - set(self._reports)
            try:
                pid, _err, probe = self._ready.get(
                    timeout=max(0.0, deadline - time.monotonic()) if missing else 0.0)
            except queue.Empty:
                break
            self._reports[pid] = probe
        return {**self._reports, **{p: None for p in self.worker_pids if p not in self._reports}}

    def _get_pool(self):
        if self._pool is None:
            ctx = _context()
            ready = ctx.Queue()
            with _worker_env():
                self._pool = ctx.Pool(
                    self.n_workers,
                    initializer=_init_pool_worker,
                    initargs=(self.workload.name, self._workload_kwargs, self._threads, ready),
                )
            # every worker up before a trial is sent: start-up is never
            # billed to a trial's deadline
            deadline = time.monotonic() + 120.0
            for _ in range(self.n_workers):
                try:
                    pid, err, probe = ready.get(timeout=max(0.0, deadline - time.monotonic()))
                    self._reports[pid] = probe
                except queue.Empty:
                    err = "not up within 120s"
                if err is not None:
                    self._rebuild_pool()
                    raise RuntimeError(f"cpu backend worker failed to start: {err}")
            self._ready = ready  # respawned workers report here too
        return self._pool

    def evaluate(self, trials: Sequence[Trial]) -> list[TrialResult]:
        if self.workload.stateful:
            if self.isolate_stateful:
                return [self._evaluate_stateful_isolated(t) for t in trials]
            if self.trial_timeout is not None and not self._warned_stateful_timeout:
                # an in-process call cannot be interrupted: say so rather
                # than pretend the deadline holds
                self._warned_stateful_timeout = True
                import warnings

                warnings.warn(
                    "cpu backend: trial_timeout cannot be enforced for stateful workloads "
                    "evaluating in-parent (an in-process call can't be interrupted) — "
                    "exceptions and non-finite scores are still caught, hangs are not "
                    "reaped. Pass isolate_stateful=True (--isolate-stateful) to run the "
                    "stateful path in a killable worker process",
                    stacklevel=3,
                )
            return [_stateful_eval(self.workload, self._states, self._trained, self.max_states,
                                   t.trial_id, t.params, t.budget, self.seed) for t in trials]
        jobs = [(t.trial_id, _clean(t.params), t.budget, self.seed) for t in trials]
        # a deadline holds only across a process boundary, so it takes
        # the pool even for one trial
        if self.trial_timeout is None and (self.n_workers == 1 or len(jobs) == 1):
            global _WORKER_WORKLOAD
            _WORKER_WORKLOAD = self.workload  # evaluates on the CPU (set at construction)
            return [_eval_one(j) for j in jobs]
        return self._evaluate_pool(jobs)

    def _evaluate_pool(self, jobs) -> list[TrialResult]:
        """One async job a trial. Under ``trial_timeout``, job i has until
        (i // n_workers + 1) timeouts (+1 s) from the batch's start: it
        starts no later than wave i // n_workers, so a job queued behind
        a hung worker still gets its own window. A crashed worker's job
        never completes (the pool replaces the worker, not the job), so
        without a deadline its ``get`` blocks: ``--trial-timeout`` is the
        production setting. A reaped batch rebuilds the pool."""
        pool = self._get_pool()
        t0 = time.monotonic()
        asyncs = [pool.apply_async(_eval_one, (j,)) for j in jobs]
        out: list[TrialResult] = []
        broken = False
        for i, (job, a) in enumerate(zip(jobs, asyncs)):
            if self.trial_timeout is None:
                wait = None
            else:
                allowance = self.trial_timeout * (i // self.n_workers + 1) + 1.0
                wait = max(0.05, t0 + allowance - time.monotonic())
            try:
                out.append(a.get(wait))
            except mp.TimeoutError:
                broken = True
                out.append(failed_result(
                    job[0], job[2],
                    f"no result within {self.trial_timeout}s (trial hung, or its worker crashed)",
                    status="timeout", wall_time=time.monotonic() - t0))
            except Exception as e:
                # the result machinery itself failed (a worker killed hard)
                broken = True
                out.append(failed_result(job[0], job[2],
                                         f"worker failure: {type(e).__name__}: {e}",
                                         wall_time=time.monotonic() - t0))
        if broken:
            self._rebuild_pool()
        return out

    def _rebuild_pool(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    # -- the isolated stateful worker (--isolate-stateful) --------------------

    def _ensure_stateful_worker(self) -> None:
        """Spawn (or respawn) the stateful worker and wait for its ready
        message, so its start-up is never billed to a trial's deadline."""
        if self._stateful_proc is not None and self._stateful_proc.is_alive():
            return
        self._kill_stateful_worker()
        ctx = _context()
        parent, child = ctx.Pipe()
        proc = ctx.Process(
            target=_stateful_worker_main,
            args=(child, self.workload.name, self._workload_kwargs, self.seed, self.max_states,
                  self._threads),
            daemon=True,
        )
        with _worker_env():
            proc.start()
        child.close()
        self._stateful_proc, self._stateful_conn = proc, parent
        if not parent.poll(120.0):  # process bring-up, not a trial
            self._kill_stateful_worker()
            raise RuntimeError("stateful worker did not come up within 120s")
        try:
            msg = parent.recv()
        except (EOFError, OSError) as e:
            self._kill_stateful_worker()
            raise RuntimeError(f"stateful worker died during startup ({type(e).__name__})") from None
        if not (isinstance(msg, tuple) and msg[0] == "ready"):
            self._kill_stateful_worker()
            raise RuntimeError(f"stateful worker failed to initialize: {msg!r}")
        self._reports[msg[1]] = msg[2]

    def _kill_stateful_worker(self) -> None:
        if self._stateful_proc is None:
            return
        proc, conn = self._stateful_proc, self._stateful_conn
        self._stateful_proc = self._stateful_conn = None
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=2.0)
            if proc.is_alive():  # ignored the TERM: truly wedged
                proc.kill()
        proc.join()
        if conn is not None:
            conn.close()

    def _evaluate_stateful_isolated(self, t: Trial) -> TrialResult:
        self._ensure_stateful_worker()
        t0 = time.monotonic()
        try:
            self._stateful_conn.send((t.trial_id, t.params, t.budget))
        except (BrokenPipeError, OSError):
            # the worker died between trials: one respawn
            self._kill_stateful_worker()
            self._ensure_stateful_worker()
            self._stateful_conn.send((t.trial_id, t.params, t.budget))
        if self._stateful_conn.poll(self.trial_timeout):
            try:
                return self._stateful_conn.recv()
            except (EOFError, OSError):
                # died mid-trial: no result will come, and the store died
                # with it; inheritors of lost states retrain from scratch
                self._kill_stateful_worker()
                return failed_result(
                    t.trial_id, t.budget,
                    "stateful worker died mid-trial (state store reset; inheritors retrain "
                    "from scratch)",
                    wall_time=time.monotonic() - t0)
        # past the deadline with the worker alive: the trial hung
        self._kill_stateful_worker()
        return failed_result(
            t.trial_id, t.budget,
            f"no result within {self.trial_timeout}s (stateful trial hung; worker killed, "
            "state store reset)",
            status="timeout", wall_time=time.monotonic() - t0)

    def reset(self):
        """Drop the state store (a new search's trial ids must not resume
        the last one's states). The pool is kept, and so is the isolated
        worker, whose store is cleared by message (or the worker killed
        if it does not answer)."""
        self._states.clear()
        self._trained.clear()
        if self._stateful_proc is not None and self._stateful_proc.is_alive():
            try:
                self._stateful_conn.send("reset")
                if self._stateful_conn.poll(10.0) and self._stateful_conn.recv() == "reset_ok":
                    return
            except (BrokenPipeError, EOFError, OSError):
                pass
            self._kill_stateful_worker()

    def close(self):
        self._rebuild_pool()
        if self._stateful_proc is not None:
            try:
                self._stateful_conn.send(None)  # a clean exit
                self._stateful_proc.join(timeout=2.0)
            except (BrokenPipeError, OSError):
                pass
            self._kill_stateful_worker()


def _clean(params: dict) -> dict:
    """Params without the framework's ``__`` keys."""
    return {k: v for k, v in params.items() if not k.startswith("__")}

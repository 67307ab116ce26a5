"""Seeded fault injection (port of ``mpi_opt_tpu/workloads/chaos.py``):
wrap any workload in configured chaos, and strike the durable layers.

``ChaosWorkload`` injects the production failure shapes at configured
probabilities, to exercise the trial-level failure layer (the trial's
status, the CPU backend's per-job reaping, ``driver.FailurePolicy``):

- ``exc``: the evaluation raises (``ChaosInjectedError``);
- ``nan``: training "succeeds" but the score is NaN (diverged loss);
- ``hang``: the evaluation blocks, reaped by the CPU backend's
  per-trial timeout;
- ``crash``: the worker process dies hard (``os._exit``): its result
  never arrives, so it too is reaped by the timeout and the pool is
  recycled;
- ``slow``: the evaluation takes extra wall time (a straggler);
- ``preempt``: SIGTERM to the evaluating process itself. Where the
  evaluation runs in the driver process (the inline and in-parent
  stateful paths), the installed ``ShutdownGuard`` turns it into a
  graceful drain: the trial completes, the sweep flushes and exits 75.
  In a pool or isolated worker the signal kills that worker, a
  crash-shaped outcome.

Determinism: whether a trial is faulted is a pure function of
``(chaos seed, params)`` through SHA-256 over ``repr`` of the cleaned
params, bit-equal to the JAX package's draw for the same values (the
port's sampled params have the same Python types). A faulted trial is
faulted on every retry, and clean trials score exactly what the inner
workload scores.

Registry shape: ``get_workload("chaos", inner="quadratic", exc=0.2)``.
The CPU backend's workers rebuild workloads from ``(name, kwargs)``, so
the CLI passes one kwargs dict to both the wrapper and the backend.

The direct-call injectors strike the durable state: ``inject_torn_save``
and ``inject_corrupt_save`` mangle a committed snapshot step (what
``fsck`` must catch), ``inject_enospc`` installs a seeded ENOSPC
schedule on the snapshot-save and ledger-fsync seam, ``inject_oom``
a device OOM at a chosen guarded launch (``utils/resources.py``), and
``inject_rank_kill`` (``--rank-kill``) a hard rank death at a chosen
boundary of a multi-process sweep, ``inject_spool_faults`` delayed
or failed replaces and EIO status reads on the sweep service's spool
(``service/spool.py``'s fault seam), and ``inject_net`` refused
connections, torn replies and delays on the HTTP client transport
(``corpus/transport.py``'s seam).
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import threading
import time

from mpi_opt_tpu_torch.space import SearchSpace
from mpi_opt_tpu_torch.workloads import get_workload, register
from mpi_opt_tpu_torch.workloads.base import Workload


class ChaosInjectedError(RuntimeError):
    """The exception ``exc`` faults raise, distinct from organic failures."""


def parse_chaos_spec(spec: str) -> dict:
    """``"exc=0.1,nan=0.05,hang=0.02,slow=0.1,seed=7"`` -> kwargs for
    ``ChaosWorkload``. Unknown keys are refused: a typoed fault name that
    injects nothing would fake a green drill."""
    out: dict = {}
    numeric = {
        "exc": float, "nan": float, "hang": float, "crash": float,
        "slow": float, "preempt": float, "hang_s": float, "slow_s": float,
        "seed": int,
    }
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"chaos spec entry {part!r} is not key=value (known keys: {sorted(numeric)})"
            )
        k, v = part.split("=", 1)
        k = k.strip().replace("-", "_")
        if k not in numeric:
            raise ValueError(f"unknown chaos key {k!r} (known: {sorted(numeric)})")
        out[k] = numeric[k](v)
    for p in ("exc", "nan", "hang", "crash", "slow", "preempt"):
        if not 0.0 <= out.get(p, 0.0) <= 1.0:
            raise ValueError(f"chaos probability {p}={out[p]} outside [0, 1]")
    return out


# -- snapshot-corruption injectors -----------------------------------------


def _committed_step_dirs(checkpoint_dir: str) -> list:
    """(step, path) of every committed step under ``checkpoint_dir``
    (Hyperband nests a root a bracket), enumerated as ``fsck`` does."""
    from mpi_opt_tpu_torch.utils.integrity import _committed_steps, find_checkpoint_roots

    out = []
    for root in find_checkpoint_roots(checkpoint_dir):
        out.extend((s, os.path.join(root, str(s))) for s in _committed_steps(root))
    return sorted(out)


def _corruption_target(step_dir: str) -> str:
    """The file a fault strikes: the largest regular file in the step
    (ties broken by path), the tensor payload in a real snapshot."""
    candidates = []
    for root, _dirs, files in os.walk(step_dir):
        for f in files:
            p = os.path.join(root, f)
            candidates.append((os.path.getsize(p), p))
    if not candidates:
        raise ValueError(f"no files to corrupt under {step_dir}")
    return sorted(candidates)[-1][1]


def _resolve_step_dir(checkpoint_dir: str, step) -> str:
    steps = _committed_step_dirs(checkpoint_dir)
    if not steps:
        raise ValueError(f"no committed snapshot steps under {checkpoint_dir}")
    if step is None:
        return steps[-1][1]
    for s, path in steps:
        if s == int(step):
            return path
    raise ValueError(f"step {step} not found under {checkpoint_dir}")


def inject_torn_save(checkpoint_dir: str, seed: int = 0, step=None) -> str:
    """Truncate a file inside the latest (or given) committed step, the
    shape a SIGKILL mid-save leaves; the cut is a seeded draw over the
    file's interior. Returns the mangled path."""
    path = _corruption_target(_resolve_step_dir(checkpoint_dir, step))
    size = os.path.getsize(path)
    h = hashlib.sha256(f"torn:{seed}".encode()).digest()
    cut = 1 + int.from_bytes(h[:8], "big") % max(size - 1, 1)
    with open(path, "r+b") as f:
        f.truncate(cut)
    return path


def inject_corrupt_save(checkpoint_dir: str, seed: int = 0, step=None) -> str:
    """Flip one seeded bit inside the latest (or given) committed step,
    the silent bit-rot only content digests catch. Returns the path."""
    path = _corruption_target(_resolve_step_dir(checkpoint_dir, step))
    size = os.path.getsize(path)
    h = hashlib.sha256(f"corrupt:{seed}".encode()).digest()
    off = int.from_bytes(h[:8], "big") % size
    bit = h[8] % 8
    with open(path, "r+b") as f:
        f.seek(off)
        byte = f.read(1)
        f.seek(off)
        f.write(bytes([byte[0] ^ (1 << bit)]))
    return path


# -- resource-exhaustion injectors -----------------------------------------


def _schedule(kind: str, n: int, seed: int, window: int | None) -> frozenset:
    """Which op ordinals (0-based) fault: the first ``n`` without a
    window, else ``n`` distinct ordinals of ``range(window)`` drawn by
    SHA-256, as the JAX package's spool schedule draws them."""
    if n <= 0:
        return frozenset()
    if window is None or window <= n:
        return frozenset(range(n))
    picked: set = set()
    i = 0
    while len(picked) < n:
        h = hashlib.sha256(f"spool:{kind}:{seed}:{i}".encode()).digest()
        picked.add(int.from_bytes(h[:8], "big") % window)
        i += 1
    return frozenset(picked)


class DiskFullInjector:
    """The schedule ``inject_enospc`` installs on ``utils.resources``'
    disk-fault seam: counts every op a kind (``snapshot_save``,
    ``ledger_fsync``) and raises a classified ``StorageFull`` on the
    scheduled ordinals; ``fail_from`` fails every op from that ordinal
    on (the disk stays full). Thread-safe."""

    def __init__(self, fail: int = 0, seed: int = 0, ops_window: int | None = None,
                 fail_from: int | None = None, op: str | None = None):
        self._lock = threading.Lock()
        self._counts: dict = {}
        self._op = op  # None: every seam kind
        self._fail_from = fail_from
        self._fail = _schedule("disk", fail, seed, ops_window)
        self.faults_fired = 0

    def __call__(self, op: str, path: str) -> None:
        if self._op is not None and op != self._op:
            return
        with self._lock:
            ordinal = self._counts.get(op, 0)
            self._counts[op] = ordinal + 1
            fire = ordinal in self._fail or (self._fail_from is not None and ordinal >= self._fail_from)
            if fire:
                self.faults_fired += 1
        if fire:
            from mpi_opt_tpu_torch.utils.resources import storage_full_error

            raise storage_full_error(path, op=f"chaos-injected {op} (op {ordinal})")


def inject_enospc(fail: int = 0, seed: int = 0, ops_window: int | None = None,
                  fail_from: int | None = None, op: str | None = None):
    """Install a seeded ENOSPC schedule on the snapshot-save and
    ledger-fsync seam; returns ``(injector, uninstall)``."""
    from mpi_opt_tpu_torch.utils import resources

    injector = DiskFullInjector(fail=fail, seed=seed, ops_window=ops_window,
                                fail_from=fail_from, op=op)
    resources.set_disk_fault_injector(injector)

    def uninstall() -> None:
        resources.set_disk_fault_injector(None)

    return injector, uninstall


class OOMInjector:
    """The schedule ``inject_oom`` installs on ``utils.resources``'
    launch seam: every guarded launch (a resident launch, one wave)
    ticks one ordinal, and the scheduled ordinals (1-based: "OOM at wave
    k") raise a synthetic CUDA out-of-memory error through the real
    classification path."""

    def __init__(self, at_launch: int = 1, n: int = 1, kind: str | None = None):
        if at_launch < 1:
            raise ValueError(f"at_launch is 1-based, got {at_launch}")
        self._lock = threading.Lock()
        self._kind = kind  # None: any guarded launch ("launch"/"wave")
        self._fire_at = frozenset(range(at_launch, at_launch + max(1, n)))
        self.launches = 0
        self.faults_fired = 0

    def __call__(self, kind: str) -> None:
        if self._kind is not None and kind != self._kind:
            return
        with self._lock:
            self.launches += 1
            ordinal = self.launches
            fire = ordinal in self._fire_at
            if fire:
                self.faults_fired += 1
        if fire:
            from mpi_opt_tpu_torch.utils.resources import synthetic_resource_exhausted

            raise synthetic_resource_exhausted(f"chaos: injected device OOM at {kind} ordinal {ordinal}")


def inject_oom(at_launch: int = 1, n: int = 1, kind: str | None = None):
    """Install a device-OOM schedule on the fused launch seam: the
    ``at_launch``-th guarded launch (``n`` in a row) raises. Returns
    ``(injector, uninstall)``."""
    from mpi_opt_tpu_torch.utils import resources

    injector = OOMInjector(at_launch=at_launch, n=n, kind=kind)
    resources.set_launch_fault_injector(injector)

    def uninstall() -> None:
        resources.set_launch_fault_injector(None)

    return injector, uninstall


class RankKillInjector:
    """The schedule ``inject_rank_kill`` installs on ``utils.resources``'
    boundary seam (``train.common.launch_boundary`` ticks it once a
    launch/rung/generation boundary): on the scheduled 1-based boundary
    ordinals, IF this process is the chosen rank
    (``torch.distributed.get_rank()``, 0 without a process group), die
    by SIGKILL: no handlers, no atexit, no flushes, the hard rank death
    that wedges an SPMD cohort's survivors in their next collective.
    Other ranks count the same ordinals and do nothing, so the drill is
    deterministic across the world.

    ``once_marker``: a sentinel file created (O_EXCL) just before dying.
    A coordinated ``--resume`` relaunch re-runs the same boundaries with
    the same spec; the marker makes the kill fire once across restarts."""

    def __init__(self, rank: int = 0, at_boundary: int = 1, n: int = 1,
                 once_marker: str | None = None):
        if at_boundary < 1:
            raise ValueError(f"at_boundary is 1-based, got {at_boundary}")
        self._lock = threading.Lock()
        self._rank = int(rank)
        self._fire_at = frozenset(range(at_boundary, at_boundary + max(1, n)))
        self._once_marker = once_marker
        self.boundaries = 0
        self.faults_fired = 0

    def __call__(self, stage: str) -> None:
        with self._lock:
            self.boundaries += 1
            fire = self.boundaries in self._fire_at
        if not fire:
            return
        import torch.distributed as dist

        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        if rank != self._rank:
            return
        if self._once_marker is not None:
            try:
                fd = os.open(self._once_marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
            except FileExistsError:
                return  # already fired in a previous attempt
        with self._lock:
            self.faults_fired += 1
        os.kill(os.getpid(), signal.SIGKILL)


def parse_rank_kill_spec(spec: str) -> dict:
    """``"rank=1,at=3,n=1,marker=/tmp/m"`` -> ``inject_rank_kill``
    kwargs. Unknown keys are rejected loudly: a typoed drill spec that
    injects nothing would fake a green wedge drill."""
    out: dict = {}
    keys = {"rank": int, "at": int, "n": int, "marker": str}
    names = {"rank": "rank", "at": "at_boundary", "n": "n", "marker": "once_marker"}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"rank-kill spec entry {part!r} is not key=value (known keys: {sorted(keys)})"
            )
        k, v = part.split("=", 1)
        k = k.strip()
        if k not in keys:
            raise ValueError(f"unknown rank-kill key {k!r} (known: {sorted(keys)})")
        out[names[k]] = keys[k](v)
    return out


def inject_rank_kill(rank: int = 0, at_boundary: int = 1, n: int = 1,
                     once_marker: str | None = None):
    """Install a rank-death schedule on the boundary seam: at the
    ``at_boundary``-th boundary (1-based; ``n`` in a row) the process of
    rank ``rank`` SIGKILLs itself. Returns ``(injector, uninstall)``."""
    from mpi_opt_tpu_torch.utils import resources

    injector = RankKillInjector(rank=rank, at_boundary=at_boundary, n=n, once_marker=once_marker)
    resources.set_boundary_fault_injector(injector)

    def uninstall() -> None:
        resources.set_boundary_fault_injector(None)

    return injector, uninstall


class SpoolFaultInjector:
    """The schedule ``inject_spool_faults`` installs on ``service.spool``'s
    fault seam: counts every op a kind ("replace" / "read" / "list") and
    raises ``OSError(EIO)`` on the scheduled ordinals (``_schedule``,
    the JAX package's draw). Read faults strike status.json reads only,
    so job-spec parsing stays out of scope; ``replace_delay_s`` sleeps
    before every replace while installed (the slow shared filesystem).
    Thread-safe: the server's heartbeat-riding refreshes share the seam."""

    def __init__(self, replace_fail: int = 0, read_fail: int = 0,
                 replace_delay_s: float = 0.0, seed: int = 0, ops_window: int | None = None):
        self.replace_delay_s = float(replace_delay_s)
        self._lock = threading.Lock()
        self._counts = {"replace": 0, "read": 0, "list": 0}
        self._fail = {
            "replace": _schedule("replace", replace_fail, seed, ops_window),
            "read": _schedule("read", read_fail, seed, ops_window),
        }
        self.faults_fired = {"replace": 0, "read": 0}

    def __call__(self, op: str, path: str) -> None:
        import errno

        if op == "replace" and self.replace_delay_s > 0:
            time.sleep(self.replace_delay_s)
        if op == "read" and not path.endswith("status.json"):
            return
        with self._lock:
            ordinal = self._counts.get(op, 0)
            self._counts[op] = ordinal + 1
            fire = ordinal in self._fail.get(op, ())
            if fire:
                self.faults_fired[op] += 1
        if fire:
            raise OSError(errno.EIO, f"chaos: injected spool {op} fault (op {ordinal})", path)


def inject_spool_faults(replace_fail: int = 0, read_fail: int = 0, replace_delay_s: float = 0.0,
                        seed: int = 0, ops_window: int | None = None):
    """Install a seeded fault schedule on the service spool's metadata
    ops. Returns ``(injector, uninstall)``. The spool's bounded retry
    (``spool.retry_io``) absorbs schedules shorter than its attempt
    budget; a longer one surfaces the ``OSError``."""
    from mpi_opt_tpu_torch.service import spool as spool_mod

    injector = SpoolFaultInjector(replace_fail=replace_fail, read_fail=read_fail,
                                  replace_delay_s=replace_delay_s, seed=seed,
                                  ops_window=ops_window)
    spool_mod.set_fault_injector(injector)

    def uninstall() -> None:
        spool_mod.set_fault_injector(None)

    return injector, uninstall


# -- network-fault injectors (the HTTP front door) ---------------------------
#
# The spool injectors above strike filesystem metadata; this one strikes
# the wire: the HTTP client transport's chaos seam
# (``corpus/transport.py::net_fault``) fires at the three places a real
# network fails: before the TCP connect ("connect": refused or reset),
# before the request body is written ("send") and before the response is
# read ("read": a torn reply, the did-it-execute ambiguity the
# idempotency key exists for). Faults fire on exact per-stage op
# ordinals from a seeded draw, never by wall clock.


class NetFaultInjector:
    """The schedule ``inject_net`` installs on ``corpus.transport``'s
    net-fault seam. Counts every transport op a stage ("connect" /
    "send" / "read") and fires the scheduled ordinals (``_schedule``,
    the JAX package's draw, under its names ``net-refuse``, ``net-torn``
    and ``net-delay``): connect ordinals raise ``transport.Unreachable``,
    read ordinals ``transport.TornResponse`` (the request may have
    executed), and the ``delay`` read ordinals sleep ``delay_s`` first.
    Thread-safe: bench and drill clients retry from many threads through
    one seam."""

    def __init__(self, refuse: int = 0, torn: int = 0, delay: int = 0, delay_s: float = 0.05,
                 seed: int = 0, ops_window: int | None = None):
        self.delay_s = float(delay_s)
        self._lock = threading.Lock()
        self._counts = {"connect": 0, "send": 0, "read": 0}
        self._fail = {
            "connect": _schedule("net-refuse", refuse, seed, ops_window),
            "read": _schedule("net-torn", torn, seed, ops_window),
        }
        self._delay = _schedule("net-delay", delay, seed, ops_window)
        self.faults_fired = {"refuse": 0, "torn": 0, "delay": 0}

    def __call__(self, stage: str, url: str) -> None:
        from mpi_opt_tpu_torch.corpus.transport import TornResponse, Unreachable

        with self._lock:
            ordinal = self._counts.get(stage, 0)
            self._counts[stage] = ordinal + 1
            fire = ordinal in self._fail.get(stage, ())
            delay = stage == "read" and ordinal in self._delay
            if fire:
                self.faults_fired["refuse" if stage == "connect" else "torn"] += 1
            if delay:
                self.faults_fired["delay"] += 1
        if delay:
            time.sleep(self.delay_s)
        if not fire:
            return
        if stage == "connect":
            raise Unreachable(f"chaos: injected connection refused (op {ordinal}) to {url}")
        raise TornResponse(f"chaos: injected torn response (op {ordinal}) from {url}")


def inject_net(refuse: int = 0, torn: int = 0, delay: int = 0, delay_s: float = 0.05,
               seed: int = 0, ops_window: int | None = None):
    """Install a seeded network-fault schedule on the HTTP transport
    seam. Returns ``(injector, uninstall)``. ``refuse`` connect ordinals
    are refused, ``torn`` read ordinals tear the reply, ``delay`` read
    ordinals sleep ``delay_s`` first; with ``ops_window`` each schedule
    is a seeded sample of that window instead of the first n. The
    client's retry absorbs schedules shorter than its attempt budget, and
    since every retry reuses its idempotency key, a torn but executed
    request is answered from the server's dedup window."""
    from mpi_opt_tpu_torch.corpus import transport

    injector = NetFaultInjector(refuse=refuse, torn=torn, delay=delay, delay_s=delay_s, seed=seed,
                                ops_window=ops_window)
    transport.set_net_fault_injector(injector)

    def uninstall() -> None:
        transport.set_net_fault_injector(None)

    return injector, uninstall


@register
class ChaosWorkload(Workload):
    name = "chaos"

    def __init__(self, inner: str = "quadratic", exc: float = 0.0, nan: float = 0.0,
                 hang: float = 0.0, crash: float = 0.0, slow: float = 0.0, preempt: float = 0.0,
                 hang_s: float = 600.0, slow_s: float = 0.25, seed: int = 0,
                 inner_kwargs: dict | None = None):
        total = exc + nan + hang + crash + slow + preempt
        if total > 1.0:
            raise ValueError(
                f"chaos probabilities sum to {total} > 1 (exc+nan+hang+crash+slow+preempt)"
            )
        self.inner = get_workload(inner, **(inner_kwargs or {}))
        self.p_exc = exc
        self.p_nan = nan
        self.p_hang = hang
        self.p_crash = crash
        self.p_slow = slow
        self.p_preempt = preempt
        self.hang_s = hang_s
        self.slow_s = slow_s
        self.chaos_seed = seed

    def default_space(self) -> SearchSpace:
        return self.inner.default_space()

    def set_eval_device(self, device) -> None:
        self.inner.set_eval_device(device)

    # -- the seeded draw ------------------------------------------------------

    def fault_for(self, params: dict) -> str | None:
        """Which fault (if any) this trial draws: SHA-256 over (chaos
        seed, the cleaned params' reprs), stable across processes."""
        payload = json.dumps(
            [
                self.chaos_seed,
                sorted((k, repr(v)) for k, v in params.items() if not k.startswith("__")),
            ]
        )
        h = hashlib.sha256(payload.encode()).digest()
        u = int.from_bytes(h[:8], "big") / 2**64  # uniform [0, 1)
        edge = 0.0
        # preempt last: a fault appended at probability 0 leaves every
        # existing (seed, params) draw as it was
        for fault, p in (
            ("exc", self.p_exc),
            ("nan", self.p_nan),
            ("hang", self.p_hang),
            ("crash", self.p_crash),
            ("slow", self.p_slow),
            ("preempt", self.p_preempt),
        ):
            edge += p
            if u < edge:
                return fault
        return None

    def _apply(self, fault: str | None) -> None:
        """The faults that strike before the evaluation."""
        if fault == "exc":
            raise ChaosInjectedError(f"chaos: injected trial failure (seed={self.chaos_seed})")
        if fault == "preempt":
            # under a ShutdownGuard this only raises the drain flag: the
            # trial completes and is journaled, so after a --resume it
            # replays instead of preempting again
            os.kill(os.getpid(), signal.SIGTERM)
        elif fault == "hang":
            time.sleep(self.hang_s)
        elif fault == "crash":
            os._exit(13)  # no exception, no result: a killed worker
        elif fault == "slow":
            time.sleep(self.slow_s)

    # -- stateless protocol ---------------------------------------------------

    def evaluate(self, params: dict, budget: int, seed: int) -> float:
        fault = self.fault_for(params)
        self._apply(fault)
        score = self.inner.evaluate(params, budget, seed)
        return float("nan") if fault == "nan" else score

    # -- stateful protocol (delegated; faults fire in train) ------------------

    @property
    def stateful(self) -> bool:
        # this wrapper always defines train; it is stateful when its
        # inner workload is
        return self.inner.stateful

    def init_state(self, params: dict, seed: int):
        return self.inner.init_state(params, seed)

    def train(self, state, params: dict, steps: int, seed: int):
        fault = self.fault_for(params)
        self._apply(fault)
        state, score = self.inner.train(state, params, steps, seed)
        return state, (float("nan") if fault == "nan" else score)

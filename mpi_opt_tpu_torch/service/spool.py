"""Filesystem job spool: the service's durable queue + control plane
(port of ``mpi_opt_tpu/service/spool.py``, which imports no JAX). The
layout and every file's JSON are the JAX package's, so one spool serves
both packages' clients.

No network dependency (this container has none to offer): clients and
server rendezvous on a shared ``--state-dir``. Every write is atomic
(tmp + rename, the heartbeat pattern), every decision the scheduler
makes is re-derivable from the files — so the spool IS the queue
checkpoint: a SIGKILLed server restarts, reads the tree, and continues
where it left off with no separate recovery file.

Layout::

    state-dir/
      servers/<id>.json     # one registration per live server (fleet)
      server-metrics.jsonl  # the server's own JSONL metrics stream
      control/drain         # flag: finish the active slice, park, exit
      queue/<job>.json      # submitted jobs not yet admitted
      tenants/<job>/
        job.json            # the submitted spec (argv, tenant, ts)
        status.json         # tenant state machine record (tenants.py)
        lease.json          # per-job claim (service/leases.py ONLY)
        cancel              # flag: cancel this job at its next boundary
        ledger.jsonl        # per-tenant durable trial journal
        ckpt/               # per-tenant snapshot root
        run.log             # captured stdout/stderr of every slice

Job ids are zero-padded submit-nanosecond stamps, so lexicographic
order IS submission order (the FIFO tiebreak needs no extra index).

Fleet federation: N servers share one spool. Each registers under
``servers/<server-id>.json`` (a server-id collision is the ONE refusal
left — two processes claiming the same identity is operator error, and
the default id keeps one server a spool);
per-JOB admission is arbitrated by ``tenants/<job>/lease.json``, owned
end to end by ``service/leases.py``.

Spool metadata I/O rides :func:`retry_io` — bounded, jitter-backed
retries on transient ``OSError`` — so a slow or contended shared
filesystem (the multi-server deployment's substrate) degrades to
latency, not crashes.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Callable, Optional

#: sweep flags the server owns per tenant; a submitted job naming one
#: would fight the server over the tenant's durable-state layout (or,
#: for the SPMD flags, over the device itself)
RESERVED_FLAGS = (
    "--ledger",
    "--checkpoint-dir",
    "--resume",
    "--metrics-file",
    "--heartbeat-file",
    "--coordinator",
    "--num-processes",
    "--process-id",
    "--multihost",
    # the server owns the device: it is chosen ONCE at `serve` bring-up
    # (`--platform`), not per tenant. The port's CLI also names the
    # device with --device, which the JAX CLI lacks: it is the server's
    # too, and the scheduler passes the server's to every slice
    "--platform",
    "--local-devices",
    "--device",
)


class SpoolError(ValueError):
    """Malformed spool content or an invalid client request."""


class ServerClaimError(RuntimeError):
    """Another live server already owns this server-id on this spool.
    The ONE serve failure that is usage-shaped: the operator pointed a
    second server at an identity that is still alive — federating needs
    a distinct ``--server-id`` per server, not a shared one."""


#: answers, not faults: the retry layer must never spin on a path that
#: is genuinely absent/present/misshaped — those outcomes are what the
#: caller is asking about (O_EXCL losing a race, a missing status file)
_NON_TRANSIENT_OS = (
    FileNotFoundError,
    FileExistsError,
    IsADirectoryError,
    NotADirectoryError,
    PermissionError,
)

#: chaos seam (workloads/chaos.py inject_spool_faults): when installed,
#: called as ``fn(op, path)`` before every spool metadata primitive
#: ("replace" before os.replace, "read" before a JSON read, "list"
#: before a directory listing) and may raise OSError or sleep — INSIDE
#: the retry wrapper, so each attempt re-consults the schedule
_FAULTS: Optional[Callable[[str, str], None]] = None


def set_fault_injector(fn: Optional[Callable[[str, str], None]]) -> None:
    global _FAULTS
    _FAULTS = fn


def _fault(op: str, path: str) -> None:
    if _FAULTS is not None:
        _FAULTS(op, path)


def retry_io(fn, attempts: int = 4, base_s: float = 0.02, sleep=time.sleep):
    """Run ``fn`` with bounded retry-with-jittered-backoff on transient
    ``OSError`` (EIO under load, NFS ESTALE, EAGAIN — the weather of a
    contended shared filesystem). Non-transient shapes
    (``FileNotFoundError``, ``FileExistsError``, permission refusals)
    raise immediately: they are answers the caller's protocol depends
    on, and "retrying" an O_EXCL loss would turn a lost race into a
    4x-slower lost race. Storage exhaustion (ENOSPC/EDQUOT,
    ``utils.resources.is_storage_full``) is ALSO an answer, not
    weather: a full disk does not heal on a jittered backoff — spinning
    on it only delays the diagnosis — so it raises immediately into the
    resource-exhaustion classification. The last attempt's
    error propagates raw."""
    from mpi_opt_tpu_torch.utils.resources import is_storage_full

    for i in range(attempts):
        try:
            return fn()
        except _NON_TRANSIENT_OS:
            raise
        except OSError as e:
            if is_storage_full(e) or i == attempts - 1:
                raise
            sleep(base_s * (2**i) * (0.5 + random.random()))


def _write_json_atomic(path: str, obj: dict) -> None:
    def _go():
        # pid AND thread in the tmp name: writers on different threads
        # (the serve loop vs the heartbeat-riding refresh) must never
        # truncate each other's half-written tmp out from under its
        # rename (the heartbeat module learned this the hard way)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "w") as f:
                json.dump(obj, f)
                f.flush()
                os.fsync(f.fileno())
            _fault("replace", path)
            os.replace(tmp, path)
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    retry_io(_go)


def _read_json(path: str) -> Optional[dict]:
    def _go():
        _fault("read", path)
        try:
            with open(path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    try:
        return retry_io(_go)
    except OSError:
        # persistently unreadable == unreadable: every caller treats
        # None as "no usable record here", which is the degraded truth
        return None


def _pid_start(pid: int) -> Optional[str]:
    """The kernel's start-time identity for a pid (Linux /proc; None
    where unavailable). pid + starttime is collision-proof against pid
    reuse; a bare pid is not — the kernel recycles them."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            stat = f.read()
        # comm (field 2) may itself contain spaces and parens: the
        # numeric fields resume after the LAST ')', where state is
        # field 3 — starttime is field 22, i.e. index 19 from there
        return stat.rsplit(")", 1)[1].split()[19]
    except (OSError, IndexError):
        return None


# -- the exclusive-claim primitives ----------------------------------------
#
# ONE home for the subtle parts of every claim-file transaction (server
# registrations, and — via service/leases.py — per-job lease acquire,
# refresh, and release all ride these; diverging copies of this dance
# is how fencing bugs are born): an O_EXCL fsync'd create that exactly
# one process can win, and a rename-into-tomb that exactly one process
# can perform. Composed, they give check-free exclusivity — never
# read-modify-write.


def excl_write_json(path: str, record: dict) -> bool:
    """Atomically create ``path`` holding ``record`` iff absent
    (``O_EXCL``, fsync'd). False = the path exists (the caller lost the
    race and must concede); transient I/O rides :func:`retry_io` and a
    persistently sick filesystem raises raw."""
    try:
        fd = retry_io(lambda: os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
    except FileExistsError:
        return False
    with os.fdopen(fd, "w") as f:
        json.dump(record, f)
        f.flush()
        os.fsync(f.fileno())
    return True


def tomb_take(path: str) -> Optional[tuple]:
    """Exclusively move ``path`` into a caller-owned tomb (rename wins
    for exactly ONE process) and read it: ``(tomb_path, record_or_None)``,
    or None when the path did not exist. The caller must end with
    :func:`tomb_discard` (and restore via :func:`excl_write_json` first
    when the record turns out not to be its to take)."""
    tomb = f"{path}.tomb.{os.getpid()}.{threading.get_ident()}"
    try:
        retry_io(lambda: os.rename(path, tomb))
    except FileNotFoundError:
        return None
    return tomb, _read_json(tomb)


def tomb_discard(tomb: str) -> None:
    """Best-effort tomb cleanup — orphaned tomb debris is inert (it is
    never a claim), so failure here is never worth raising over."""
    try:
        os.unlink(tomb)
    except OSError:
        pass


def claim_file(path: str, payload: dict, stealable, attempts: int = 8) -> Optional[dict]:
    """The exclusive-claim protocol: atomically create ``path`` holding
    ``payload`` iff it is absent or ``stealable(current)``. A stealable
    claim is replaced via rename-tomb, and the tomb is inspected AFTER
    the steal so a peer's fresh re-claim that raced our staleness read
    is restored and conceded, never destroyed. Returns ``payload`` on
    win, None on concede."""
    for _ in range(attempts):  # bounded: every retry means the file changed
        if excl_write_json(path, payload):
            return payload
        cur = _read_json(path)
        if cur is not None and not stealable(cur):
            return None  # live holder; we lose
        taken = tomb_take(path)
        if taken is None:
            continue  # another claimant removed it; retry the create
        tomb, stolen = taken
        tomb_discard(tomb)
        if stolen is not None and not stealable(stolen):
            # we stole a LIVE claim (the holder refreshed between our
            # read and our rename) — put it back and concede
            try:
                excl_write_json(path, stolen)
            except OSError:
                pass  # can't restore: still concede; TTL re-heals
            return None
        continue  # the claim really was stealable; retry the create
    return None


_HOST_ID: Optional[str] = None


def _local_host() -> str:
    """This machine's identity, for cross-host liveness judgement (a
    pid recorded by another host is not a pid here). The nodename alone
    is NOT unique enough to gate a "provably dead, take over now"
    verdict — cloned VMs and templated containers ship identical
    hostnames, and a collision would let a peer probe a REMOTE holder's
    pid locally, find it absent, and steal a live lease with no TTL
    wait. The kernel boot id (random per boot) disambiguates; it also
    makes a rebooted host read as "different host", which is correct —
    its old pids mean nothing after the reboot, so freshness/TTL (not
    pid probing) is the right judgement there. Hosts without the proc
    file (non-Linux) fall back to the bare nodename, keeping the old
    behavior and its documented residual risk."""
    global _HOST_ID
    if _HOST_ID is None:
        try:
            node = os.uname().nodename
        except (AttributeError, OSError):  # pragma: no cover - non-posix
            node = "unknown-host"
        try:
            with open("/proc/sys/kernel/random/boot_id") as f:
                _HOST_ID = f"{node}/{f.read().strip()[:13]}"
            # boot_id is KERNEL-wide: two containers sharing a kernel
            # (and, via a templated config, a nodename) would still
            # collide — and a pid probed across PID namespaces is just
            # as meaningless as one probed across machines. The pid-ns
            # inode completes the "same pid world" judgement.
            _HOST_ID += f"/{os.stat('/proc/self/ns/pid').st_ino}"
        except OSError:  # pragma: no cover - non-linux
            _HOST_ID = node
    return _HOST_ID


def check_argv(argv: list) -> None:
    """Client-side admission gate: refuse reserved / server-owned flags
    at submit time, where the error is cheap and attributable."""
    for a in argv:
        flag = a.split("=", 1)[0]
        if not flag.startswith("--"):
            continue
        # prefix match, not equality: argparse resolves unambiguous
        # abbreviations (allow_abbrev), so `--platfor` would reach the
        # slice's parser as --platform and bypass an exact-string gate
        for reserved in RESERVED_FLAGS:
            if len(flag) > 2 and reserved.startswith(flag):
                raise SpoolError(
                    f"{flag} is (or abbreviates) server-owned {reserved} "
                    "(the service assigns each tenant its own "
                    "ledger/checkpoint root and owns the device "
                    "bring-up); submit the sweep without it"
                )


class TenantDir:
    """One tenant's slice of the spool: paths + status accessors."""

    def __init__(self, root: str, job_id: str):
        self.job_id = job_id
        self.dir = os.path.join(root, job_id)
        self.job_path = os.path.join(self.dir, "job.json")
        self.status_path = os.path.join(self.dir, "status.json")
        # per-job claim file (fleet federation): written ONLY by
        # service/leases.py — the path lives here so readers (status,
        # report) and the lease helpers agree on one location
        self.lease = os.path.join(self.dir, "lease.json")
        self.cancel_path = os.path.join(self.dir, "cancel")
        self.ledger = os.path.join(self.dir, "ledger.jsonl")
        self.ckpt = os.path.join(self.dir, "ckpt")
        self.log = os.path.join(self.dir, "run.log")
        # observability surfaces (both server-owned, like ledger/ckpt):
        # the heartbeat's phase field is the ACTIVE tenant's live-phase
        # source; metrics.jsonl is the tenant's span-trace stream under
        # `serve --trace` (renders with `python -m mpi_opt_tpu_torch
        # trace STATE_DIR`)
        self.heartbeat = os.path.join(self.dir, "heartbeat.json")
        self.metrics = os.path.join(self.dir, "metrics.jsonl")

    @property
    def job(self) -> dict:
        job = _read_json(self.job_path)
        if job is None:
            raise SpoolError(f"{self.job_path}: unreadable job spec")
        return job

    @property
    def status(self) -> dict:
        return _read_json(self.status_path) or {}

    def write_status(self, status: dict) -> None:
        status = dict(status, updated_ts=round(time.time(), 4))
        _write_json_atomic(self.status_path, status)

    def create_status(self, status: dict) -> bool:
        """Write the INITIAL status record only if none exists yet
        (``excl_write_json``: with N servers racing the same admission,
        exactly one initial write wins and a peer's later duplicate
        admission can never reset a tenant that is already running —
        and the shared primitive carries the retry budget, so transient
        admission-time I/O degrades to latency like every other spool
        metadata op). Returns whether THIS call created it."""
        return excl_write_json(
            self.status_path, dict(status, updated_ts=round(time.time(), 4))
        )

    def cancel_requested(self) -> bool:
        return os.path.exists(self.cancel_path)

    def request_cancel(self) -> None:
        with open(self.cancel_path, "w") as f:
            f.write("")


def live_phase(tenant_dir: str, status: dict) -> Optional[dict]:
    """An ACTIVE tenant's live phase + slice-elapsed, for the status and
    report surfaces: ``{"phase": ..., "slice_elapsed_s": ...}`` when the
    status says ``running``, else None.

    The phase comes from the tenant's heartbeat file (the scheduler
    wires ``--heartbeat-file`` into every slice): each beat carries the
    rank's active trace span (health/heartbeat.py ``phase``) with the
    beat's progress ``stage`` label as fallback. Slice elapsed is
    against the ``slice_started_ts`` the scheduler stamps into the
    RUNNING status write. Read-only and best-effort — a pre-upgrade
    status or a beat-less slice reports None fields, never an error."""
    if status.get("state") != "running":
        return None
    from mpi_opt_tpu_torch.health.heartbeat import read_beat

    rec = read_beat(os.path.join(tenant_dir, "heartbeat.json")) or {}
    out = {
        "phase": rec.get("phase") or (rec.get("progress") or {}).get("stage"),
        "slice_elapsed_s": None,
    }
    started = status.get("slice_started_ts")
    if started is not None:
        out["slice_elapsed_s"] = round(max(0.0, time.time() - float(started)), 3)
    return out


class Spool:
    def __init__(self, state_dir: str, create: bool = True):
        """``create=False`` is the read-only clients' mode (status /
        cancel / drain): they must refuse a path that is not already a
        spool — silently fabricating an empty tree at a mistyped
        ``--state-dir`` would answer "server down, no jobs" about a
        spool that does not exist (and drop drain flags no server
        watches). ``serve`` and ``submit`` create: submitting to a
        not-yet-started spool is the documented queue-ahead shape."""
        self.state_dir = state_dir
        self.queue_dir = os.path.join(state_dir, "queue")
        self.tenants_dir = os.path.join(state_dir, "tenants")
        self.control_dir = os.path.join(state_dir, "control")
        self.servers_dir = os.path.join(state_dir, "servers")
        self.metrics_path = os.path.join(state_dir, "server-metrics.jsonl")
        self._drain_path = os.path.join(self.control_dir, "drain")
        if create:
            for d in (
                self.queue_dir,
                self.tenants_dir,
                self.control_dir,
                self.servers_dir,
            ):
                os.makedirs(d, exist_ok=True)
        elif not os.path.isdir(self.queue_dir):
            raise SpoolError(
                f"{state_dir}: not a service spool (no queue/ underneath) "
                "— mistyped --state-dir?"
            )

    # -- client side -------------------------------------------------

    def submit(
        self,
        argv: list,
        tenant: str = "default",
        priority: int = 0,
        deadline_ts: Optional[float] = None,
    ) -> str:
        """Drop a job file in the queue; returns the job id. The id's
        nanosecond stamp makes collisions impossible within a process
        and sorts by submission time across processes.

        ``priority`` (higher admits first) and ``deadline_ts`` (absolute
        epoch seconds; earlier admits first within a priority class) are
        the scheduler's sort keys ahead of fair-share — see
        ``_pick_next``; its starvation floor promotes long-waiting
        low-priority jobs so a priority class cannot starve the rest."""
        check_argv(argv)
        job_id = f"job-{time.time_ns():020d}-{os.getpid() % 100000:05d}"
        spec = {
            "id": job_id,
            "tenant": tenant,
            "argv": list(argv),
            "priority": int(priority),
            "deadline_ts": None if deadline_ts is None else float(deadline_ts),
            "submitted_ts": round(time.time(), 4),
        }
        _write_json_atomic(os.path.join(self.queue_dir, f"{job_id}.json"), spec)
        return job_id

    def cancel(self, job_id: str) -> str:
        """Cancel a job wherever it lives. Queued jobs cancel
        immediately (they never ran: the queue file becomes a terminal
        tenant record); admitted jobs get a cancel flag the server
        honors at the tenant's next boundary — nothing is killed, so
        nothing needs quarantine. Returns the resulting state."""
        from mpi_opt_tpu_torch.service import tenants as tstates

        qpath = os.path.join(self.queue_dir, f"{job_id}.json")
        if os.path.exists(qpath):
            try:
                t = self._materialize(qpath)
            except SpoolError:
                # lost the claim race to the server's admission — the
                # tenant dir exists now; fall through and cancel it there
                t = None
            if t is not None:
                # flag FIRST: if the server's racing QUEUED status write
                # lands after our CANCELLED one, the flag still cancels
                # the tenant at admission or its first boundary
                t.request_cancel()
                t.write_status(
                    dict(
                        t.status,
                        state=tstates.CANCELLED,
                        note="cancelled while queued",
                    )
                )
                return tstates.CANCELLED
        t = self.tenant(job_id)
        if t is None:
            raise SpoolError(f"unknown job {job_id!r}")
        state = t.status.get("state")
        if state in tstates.TERMINAL:
            return state
        if state in (tstates.QUEUED, tstates.PARKED):
            # not on the device: terminal immediately — but raise the
            # flag FIRST, so a server that picked this tenant between
            # our state read and the status write still drains it at
            # the next boundary instead of silently overwriting the
            # CANCELLED record at slice end
            t.request_cancel()
            t.write_status(dict(t.status, state=tstates.CANCELLED))
            return tstates.CANCELLED
        t.request_cancel()
        return state or tstates.QUEUED

    def request_drain(self) -> None:
        with open(self._drain_path, "w") as f:
            f.write("")

    def drain_requested(self) -> bool:
        return os.path.exists(self._drain_path)

    def clear_drain(self) -> None:
        try:
            os.unlink(self._drain_path)
        except FileNotFoundError:
            pass

    # -- server side -------------------------------------------------

    def pending_jobs(self) -> list:
        """Queue files in submission (= lexicographic) order."""

        def _go():
            _fault("list", self.queue_dir)
            return sorted(
                os.path.join(self.queue_dir, f)
                for f in os.listdir(self.queue_dir)
                if f.endswith(".json")
            )

        return retry_io(_go)

    def _materialize(self, queue_path: str) -> TenantDir:
        """Move a queue file into a tenant dir (the admission step's
        mechanical half; scheduler.py decides WHEN)."""
        from mpi_opt_tpu_torch.service import tenants as tstates

        spec = _read_json(queue_path)
        if spec is None or "id" not in spec or "argv" not in spec:
            if not os.path.exists(queue_path):
                # lost a race: the other side of a concurrent
                # cancel-while-queued / admission already took it
                raise SpoolError(f"{queue_path}: already claimed by a peer")
            # a torn/garbage submit: park it out of the queue loudly
            bad = queue_path + ".malformed"
            try:
                os.replace(queue_path, bad)
            except FileNotFoundError:
                raise SpoolError(f"{queue_path}: already claimed by a peer")
            raise SpoolError(f"malformed job file moved to {bad}")
        t = TenantDir(self.tenants_dir, spec["id"])
        os.makedirs(t.dir, exist_ok=True)
        _write_json_atomic(t.job_path, spec)
        # create-if-absent: with N servers sharing the spool, a slow
        # peer re-running this admission (it read the queue file before
        # we unlinked it) must not RESET a tenant that already ran —
        # only the first initial-status write lands
        t.create_status(
            {
                "id": spec["id"],
                "tenant": spec.get("tenant", "default"),
                "state": tstates.QUEUED,
                "slices": 0,
                "preemptions": 0,
                "boundaries": 0,
                "takeovers": 0,
                "rc_history": [],
                "program_cache": {"hits": 0, "misses": 0},
                "priority": int(spec.get("priority") or 0),
                "deadline_ts": spec.get("deadline_ts"),
                "submitted_ts": spec.get("submitted_ts"),
            }
        )
        try:
            os.unlink(queue_path)
        except FileNotFoundError:
            pass  # a racing peer already removed it; the tenant dir wins
        return t

    def admit(self, queue_path: str) -> TenantDir:
        return self._materialize(queue_path)

    def tenant(self, job_id: str) -> Optional[TenantDir]:
        t = TenantDir(self.tenants_dir, job_id)
        return t if os.path.isdir(t.dir) else None

    def tenants(self) -> list:
        """All admitted tenants, submission-ordered."""

        def _go():
            _fault("list", self.tenants_dir)
            return [
                TenantDir(self.tenants_dir, d)
                for d in sorted(os.listdir(self.tenants_dir))
                if os.path.isdir(os.path.join(self.tenants_dir, d))
            ]

        return retry_io(_go)

    # -- server registry (fleet liveness) ----------------------------

    #: the id a server registers under when the operator names none —
    #: a FIXED default on purpose: two default-id servers collide, so
    #: one server a spool holds until the operator opts into federation
    #: with distinct --server-id values
    DEFAULT_SERVER_ID = "server"

    #: a registration whose refresh timestamp is older than this many
    #: seconds is treated as dead when its pid cannot be judged (the
    #: holder runs on another host); local pids are judged directly.
    #: GENEROUS on purpose: the refresh rides the serve loop AND the
    #: active tenant's heartbeat beats, whose longest gap is a tenant's
    #: cold set-up (data upload, cuDNN's first launches) — judging a
    #: remote server dead mid-set-up would let a same-id peer usurp a
    #: live process. The cost of the slack is only that a genuinely dead
    #: REMOTE server's id stays refused this long (same-host death is
    #: pid-judged instantly, and per-job leases — not registrations —
    #: gate the actual work).
    SERVER_STALE_S = 600.0

    def server_file(self, server_id: str) -> str:
        return os.path.join(self.servers_dir, f"{server_id}.json")

    @property
    def server_path(self) -> str:
        """The default-id registration path (the single-server shape
        tests and drills forge against)."""
        return self.server_file(self.DEFAULT_SERVER_ID)

    def read_servers(self) -> list:
        """Every registration on the spool (live or stale), sorted by
        server id. Missing servers/ (a pre-fleet spool a read-only
        client points at) reads as an empty fleet, not an error."""

        def _go():
            if not os.path.isdir(self.servers_dir):
                return []
            _fault("list", self.servers_dir)
            return sorted(
                f for f in os.listdir(self.servers_dir) if f.endswith(".json")
            )

        out = []
        for fname in retry_io(_go):
            rec = _read_json(os.path.join(self.servers_dir, fname))
            if rec is not None:
                rec.setdefault("server_id", fname[: -len(".json")])
                out.append(rec)
        return out

    def read_server(self) -> Optional[dict]:
        """The most recently refreshed registration, or None — the
        aggregate single-server view ``drain --wait`` and the status
        header key on."""
        servers = self.read_servers()
        if not servers:
            return None
        return max(servers, key=lambda r: float(r.get("ts") or 0.0))

    def server_alive(self, info: Optional[dict] = None) -> bool:
        """Is any server (or the given registration) live?"""
        if info is not None:
            return self._server_live(info)
        return any(self._server_live(r) for r in self.read_servers())

    def _claim_fields(self, server_id: str, **fields) -> dict:
        return {
            "server_id": server_id,
            "pid": os.getpid(),
            "pid_start": _pid_start(os.getpid()),
            "host": _local_host(),
            "ts": round(time.time(), 4),
            **fields,
        }

    def write_server(self, server_id: str = DEFAULT_SERVER_ID, **fields) -> None:
        """Forge/refresh a registration AS THIS PROCESS (tests, and the
        serve loop's refresh path goes through refresh_server below)."""
        _write_json_atomic(self.server_file(server_id), self._claim_fields(server_id, **fields))

    def _server_live(self, info: Optional[dict]) -> bool:
        if not info or "pid" not in info:
            return False
        host = info.get("host")
        if host is not None and host != _local_host():
            # a pid means nothing across machines: judge a remote
            # server by registration freshness only
            try:
                return (time.time() - float(info["ts"])) <= self.SERVER_STALE_S
            except (KeyError, TypeError, ValueError):
                return False
        try:
            pid = int(info["pid"])
            os.kill(pid, 0)
        except PermissionError:
            # EPERM is a LIVE process owned by someone else — on a
            # shared state-dir the same-id refusal must still see it
            # (and /proc/<pid>/stat below stays readable)
            pass
        except (OSError, ValueError):
            return False
        # the pid exists — but is it the SAME process? A SIGKILLed
        # server never clears its registration, and the kernel
        # eventually recycles its pid for an unrelated process, which
        # would hold the server-id hostage until an operator deleted
        # the file by hand. The recorded start time settles it; records
        # without one (non-Linux hosts) keep the bare-pid behavior.
        recorded = info.get("pid_start")
        if recorded is not None:
            current = _pid_start(pid)
            if current is not None and current != recorded:
                return False
        return True

    # back-compat alias (pre-fleet name; scheduler/tests used it)
    def _pid_alive(self, info: Optional[dict]) -> bool:
        return self._server_live(info)

    def register_server(self, server_id: str = DEFAULT_SERVER_ID, **fields) -> bool:
        """Atomically register THIS process under ``server_id`` (O_EXCL
        create — a check-then-write would let two servers racing through
        the same window both believe they own the identity).

        A registration held by a dead pid (SIGKILLed server) is broken
        via rename-takeover: rename wins for exactly ONE claimant, and
        the renamed file is inspected AFTER the steal — if it turns out
        to be a peer's fresh LIVE registration (the peer broke the stale
        one and re-registered between our read and our rename), it is
        restored and we lose. Returns False when a live server holds
        the id."""
        won = claim_file(
            self.server_file(server_id),
            self._claim_fields(server_id, **fields),
            stealable=lambda cur: not self._server_live(cur),
        )
        return won is not None

    def _registration_is_mine(self, cur: Optional[dict]) -> bool:
        return (
            cur is not None
            and cur.get("pid") == os.getpid()
            and cur.get("pid_start") == _pid_start(os.getpid())
        )

    def refresh_server(self, server_id: str, **fields) -> Optional[bool]:
        """Re-stamp our registration's heartbeat ``ts`` (and any counter
        fields). Identity-checked against THIS process before AND after
        the write. Tri-state: True = refreshed and still ours; False =
        the file READABLY records someone else (or is gone) — another
        process claimed the id while we were presumed dead, the caller
        (the serve loop) must STEP DOWN rather than fight; None = the
        file is present but unreadable (torn read, persistent EIO the
        retry budget couldn't clear) — CANNOT TELL, and a caller that
        treated it as usurped would have a healthy server abandon its
        fleet slot over one NFS blip. Retry later instead.

        Honesty note: check-write-verify is not fully exclusive (a
        usurper's registration landing inside the write window is
        clobbered, detected only by whoever verifies last). Making it
        so would rename the file away mid-refresh, and a concurrent
        ``server_alive`` poll would see a live server flicker absent.
        The race is survivable by construction: usurping requires the
        registration to be STALE (``SERVER_STALE_S`` with refresh
        riding both the serve loop and the tenant's heartbeat beats),
        so a clobber needs a >10-minute-hung process — and per-job
        leases, not registrations, gate the actual work either way."""
        path = self.server_file(server_id)
        cur = _read_json(path)
        if cur is None:
            return None if os.path.exists(path) else False
        if not self._registration_is_mine(cur):
            return False
        _write_json_atomic(path, dict(cur, ts=round(time.time(), 4), **fields))
        after = _read_json(path)
        if after is None:
            return None if os.path.exists(path) else False
        return True if self._registration_is_mine(after) else False

    def clear_server(self, server_id: str = DEFAULT_SERVER_ID) -> None:
        try:
            os.unlink(self.server_file(server_id))
        except FileNotFoundError:
            pass

    def clear_server_if_mine(self, server_id: str) -> bool:
        """Deregister on the way out — but ONLY if the file still
        records this process. A stepped-down zombie must not unlink the
        usurper's live registration as its parting act."""
        if not self._registration_is_mine(_read_json(self.server_file(server_id))):
            return False
        self.clear_server(server_id)
        return True

"""Per-job leases: fleet admission arbitration for a shared spool (port
of ``mpi_opt_tpu/service/leases.py``, which imports no JAX; the lease
files are the JAX package's, so a JAX server's live lease blocks a port
server and the reverse).

One exclusive server claim on a whole spool would let one dead host
strand every queued tenant. Per-job leases let N ``serve`` processes
(one per host or card) share one spool and arbitrate admission per
tenant:

- **claim** — a server claims a tenant by atomically creating
  ``tenants/<job>/lease.json`` (``O_EXCL``; an expired lease is
  replaced through a rename-tomb protocol, never read-modify-write),
  carrying the server's identity, a fencing token, and a TTL deadline.
- **refresh** — the holder re-extends the deadline on a monotonic
  cadence well under the TTL, riding the tenant's existing heartbeat
  path (health/heartbeat.py beat listener) so refresh granularity is
  sub-launch, not per-boundary.
- **takeover** — any live server may claim a job whose lease expired
  (or whose holder is provably dead: same host, pid gone or /proc
  start time mismatching — pid reuse cannot fake liveness). The
  takeover itself is just the existing verified-snapshot +
  journal-prefix ``--resume``, so a tenant whose server was SIGKILLed
  mid-slice finishes on a survivor with a ledger record-identical to a
  solo run.
- **fencing** — every lease carries a unique token; the holder's
  tenant-metadata writes (status, terminal transitions) compare-and-
  check the token first, so a presumed-dead server that wakes up after
  a takeover has its late writes REFUSED instead of clobbering the new
  owner's record.

Clock honesty: the on-disk deadline is wall-clock ``time.time()`` (the
only clock shared through a filesystem); the HOLDER schedules its
refreshes against ``time.monotonic()`` so a suspend/step never makes it
think it refreshed recently. Takeover therefore requires expiry as
judged by the taker's wall clock — modest skew degrades to takeover
latency, never to double execution, because acquisition stays exclusive
(``O_EXCL`` / rename wins for exactly one claimant) and the TTL is the
operator's skew budget (see README: TTL tuning).

Residual window, stated honestly: a holder stalled LONGER than the TTL
(SIGSTOP, multi-second GC on a dying box) can still be executing one
in-flight launch while the taker resumes from the last boundary. The
fence turns the zombie's metadata writes into refusals and its own
drain request fires at the first beat after it wakes; the journal's
verify-don't-rewrite resume refuses divergence (exit 65) rather than
double-recording. Size the TTL above the longest beat gap (one launch)
to keep that window theoretical.

This module is the ONLY writer of lease files — a sweeplint checker
(``lease-write``) machine-enforces that, because a lease written any
other way (read-modify-write, non-atomic) silently breaks the
exactly-one-claimant argument everything above rests on.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from mpi_opt_tpu_torch.service.spool import (
    _local_host,
    _pid_start,
    _read_json,
    claim_file,
    excl_write_json,
    tomb_discard,
    tomb_take,
)


class LeaseFenced(RuntimeError):
    """The caller's lease token no longer matches the lease file: the
    job was taken over while the caller was presumed dead. Every write
    the caller intended for this tenant must be abandoned — the new
    owner's record is authoritative."""


_TOKEN_SEQ = [0]
_TOKEN_LOCK = threading.Lock()


@dataclass(frozen=True)
class ServerIdentity:
    """Who is claiming: the fencing identity a lease (and a server
    registration) records. ``pid_start`` is the kernel's /proc start
    time — pid + start time is collision-proof against pid reuse, the
    exact hole a bare-pid liveness check leaves open."""

    server_id: str
    pid: int
    pid_start: Optional[str]
    host: str

    @classmethod
    def local(cls, server_id: str) -> "ServerIdentity":
        pid = os.getpid()
        return cls(server_id, pid, _pid_start(pid), _local_host())

    def new_token(self) -> str:
        """A token unique per ACQUISITION, not just per process: the
        sequence suffix keeps re-acquire-after-release by the same
        process distinguishable, so fencing judgements never alias two
        different ownership epochs of one server."""
        with _TOKEN_LOCK:
            _TOKEN_SEQ[0] += 1
            seq = _TOKEN_SEQ[0]
        return f"{self.server_id}@{self.host}:{self.pid}:{self.pid_start}#{seq}"


def read_lease(path: str) -> Optional[dict]:
    """The lease record at ``path`` or None (absent/unreadable — an
    unreadable lease is treated as expired by ``acquire``, because a
    torn file can only result from a crashed writer)."""
    return _read_json(path)


def holder_dead(lease: dict) -> bool:
    """Is the lease's holder PROVABLY dead? Only judgeable on the
    holder's own host (a pid means nothing across machines): pid gone,
    or alive but with a different /proc start time (the kernel recycled
    the pid for an unrelated process)."""
    if lease.get("host") != _local_host():
        return False
    try:
        pid = int(lease["pid"])
    except (KeyError, TypeError, ValueError):
        return True
    try:
        os.kill(pid, 0)
    except PermissionError:
        pass  # EPERM: alive, owned by someone else
    except OSError:
        return True
    recorded = lease.get("pid_start")
    if recorded is not None:
        current = _pid_start(pid)
        if current is not None and current != recorded:
            return True
    return False


def expired(lease: dict, now: Optional[float] = None) -> bool:
    """May this lease be taken over? True past the wall-clock deadline,
    or immediately when the holder is provably dead (the SIGKILL fast
    path: no reason to wait out a TTL for a corpse)."""
    if holder_dead(lease):
        return True
    try:
        deadline = float(lease["expires_ts"])
    except (KeyError, TypeError, ValueError):
        return True  # a lease without a deadline is not a lease
    return (time.time() if now is None else now) > deadline


def _fresh(ident: ServerIdentity, ttl_s: float, token: Optional[str] = None) -> dict:
    now = time.time()
    return {
        "server_id": ident.server_id,
        "pid": ident.pid,
        "pid_start": ident.pid_start,
        "host": ident.host,
        "token": token or ident.new_token(),
        "ttl_s": float(ttl_s),
        "acquired_ts": round(now, 4),
        "expires_ts": round(now + float(ttl_s), 4),
        "refreshes": 0,
    }


def acquire(path: str, ident: ServerIdentity, ttl_s: float) -> Optional[dict]:
    """Claim the lease at ``path`` for ``ident``; returns the lease
    record we now hold, or None when a live peer holds it.

    Never read-modify-write: delegates to ``spool.claim_file`` — the
    ONE exclusive-claim protocol (O_EXCL create, rename-tomb steal of
    an expired claim, inspect-after-steal restore-and-concede) that
    server registrations also ride, with "stealable" meaning *expired*
    here (an unreadable lease reads as expired too: a torn file can
    only result from a crashed writer)."""
    return claim_file(
        path,
        _fresh(ident, ttl_s),
        stealable=lambda cur: expired(cur),
    )


def held(path: str, lease: dict) -> bool:
    """The compare-and-check fence: does the lease file still carry OUR
    token? Every tenant-metadata write a holder makes must pass this
    first, so a taken-over server's late writes are refused."""
    cur = _read_json(path)
    return cur is not None and cur.get("token") == lease.get("token")


def check_fence(path: str, lease: dict) -> None:
    """``held`` or raise :class:`LeaseFenced`."""
    if not held(path, lease):
        raise LeaseFenced(
            f"lease {path} no longer carries token {lease.get('token')!r} "
            "— the job was taken over; abandoning all writes for it"
        )


def refresh(path: str, lease: dict, ttl_s: Optional[float] = None) -> dict:
    """Extend the deadline of a lease we hold. Raises
    :class:`LeaseFenced` when the file no longer carries our token —
    the holder must stop touching the tenant and drain. Returns the
    refreshed record (the caller's new ``lease``).

    EXCLUSIVE, not check-then-write: the file is taken into a tomb
    first (rename wins for exactly one process — ``spool.tomb_take``),
    inspected, and only then rewritten via ``O_EXCL`` create. A
    check-then-write refresh would let a holder that stalled past its
    TTL clobber a taker's fresh lease with its own token — re-arming
    the zombie and fencing the rightful new owner, the exact inversion
    fencing exists to prevent. The cost is a microsecond window where
    the lease reads as absent; a peer that claims it in that window
    simply wins (our ``O_EXCL`` re-create fails and we fence
    OURSELVES) — a rare spurious handoff, never a safety loss."""
    ttl = float(ttl_s if ttl_s is not None else lease.get("ttl_s") or 0.0)
    taken = tomb_take(path)
    if taken is None:
        raise LeaseFenced(f"lease {path} vanished (taken over and released)")
    tomb, cur = taken
    if cur is None or cur.get("token") != lease.get("token"):
        # not ours: put the rightful owner's record back where we found
        # it (a torn tomb — cur None — was garbage and stays gone:
        # absent reads as claimable, which is what torn already meant)
        if cur is not None:
            try:
                excl_write_json(path, cur)
            except OSError:
                pass  # can't restore: absent is still claimable
        tomb_discard(tomb)
        raise LeaseFenced(
            f"lease {path} was taken over (token mismatch on refresh)"
        )
    now = time.time()
    new = dict(
        cur,
        expires_ts=round(now + ttl, 4),
        refreshed_ts=round(now, 4),
        refreshes=int(cur.get("refreshes") or 0) + 1,
    )
    try:
        created = excl_write_json(path, new)
    except OSError:
        # the re-create failed AFTER the rename emptied the path: put
        # the original record back (best-effort) so one transient I/O
        # burst doesn't turn into a vanished lease that self-fences a
        # healthy holder on its next beat — then let the error reach
        # the Refresher, whose throttle rewind retries immediately
        try:
            excl_write_json(path, cur)
        except OSError:
            pass  # truly sick: absent is claimable, the TTL re-heals
        tomb_discard(tomb)
        raise
    if not created:
        # a peer claimed the absence window our rename opened — it
        # holds a fresh valid lease now; concede and self-fence
        tomb_discard(tomb)
        raise LeaseFenced(f"lease {path} was re-claimed mid-refresh; conceding")
    tomb_discard(tomb)
    return new


def release(path: str, lease: dict) -> bool:
    """Give the lease up (slice end: parked, or terminal). Token-checked
    through the same rename-tomb protocol as ``acquire`` so a racing
    taker's fresh lease is never unlinked by a stale releaser: rename
    claims the file exclusively, the tomb is inspected, and a lease
    that turned out not to be ours is restored. Returns whether WE
    released it.

    Best-effort by contract: transient I/O rides ``retry_io`` (inside
    the shared primitives) and a PERSISTENT failure returns False
    instead of raising — release runs on the server's scheduling path,
    where crashing over an unreleased lease would strand every tenant
    to save one file the TTL (or the next acquirer's steal) reclaims
    anyway."""
    try:
        taken = tomb_take(path)
    except OSError:
        return False  # sick filesystem: the TTL is the backstop
    if taken is None:
        return False
    tomb, cur = taken
    if cur is not None and cur.get("token") != lease.get("token"):
        # not ours (we were fenced and a new owner wrote this): restore
        try:
            excl_write_json(path, cur)
        except OSError:
            pass  # can't restore: absent is still claimable
        tomb_discard(tomb)
        return False
    tomb_discard(tomb)
    return True


class Refresher:
    """The per-slice lease keeper: installed as the heartbeat beat
    listener (health/heartbeat.py) so every unit of tenant progress —
    driver batch, fused launch, wave sub-segment, staging transfer —
    gives the lease a chance to re-extend. Throttled on a MONOTONIC
    cadence of ttl/3 so beats cost a clock read, not a file write.

    On fencing (the lease stopped carrying our token: we were presumed
    dead and taken over) the refresher latches ``fenced`` and calls
    ``on_fenced`` once — the scheduler passes ``shutdown.request`` so
    the zombie slice drains at its next boundary instead of running to
    completion against a tenant it no longer owns. Never raises into
    the beating thread; transient I/O errors are absorbed (the next
    beat retries) because a heartbeat must never kill the sweep it
    reports on."""

    def __init__(
        self,
        path: str,
        lease: dict,
        ttl_s: float,
        on_fenced: Optional[Callable[[], object]] = None,
    ):
        self.path = path
        self.lease = lease
        self.ttl_s = float(ttl_s)
        self.on_fenced = on_fenced
        self.fenced = False
        self._stopped = False
        self._next = time.monotonic() + self.ttl_s / 3.0
        self._lock = threading.Lock()

    def __call__(self, *_args, **_kw) -> None:
        # non-blocking: a beat that loses the lock SKIPS (the winner is
        # already refreshing) instead of stalling the sweep's hot path
        # behind a shared-filesystem fsync round-trip
        if not self._lock.acquire(blocking=False):
            return
        try:
            if self._stopped or self.fenced or time.monotonic() < self._next:
                return
            self._next = time.monotonic() + self.ttl_s / 3.0
            try:
                self.lease = refresh(self.path, self.lease, self.ttl_s)
            except LeaseFenced:
                self.fenced = True
            except OSError:
                # transient shared-fs hiccup: rewind the throttle so the
                # VERY NEXT beat retries — waiting a whole ttl/3 window
                # after a failure burns deadline margin exactly when the
                # filesystem is already being slow
                self._next = 0.0
                return
        finally:
            self._lock.release()
        if self.fenced and self.on_fenced is not None:
            try:
                self.on_fenced()
            except Exception:  # pragma: no cover - defensive: never raise into a beat
                pass

    def stop(self) -> dict:
        """Settle the refresher at slice end: BLOCK until any in-flight
        refresh finishes (refresh opens a momentary absence window on
        the lease file — an end-of-slice ``held``/``release`` racing it
        would falsely read fenced, and the in-flight refresh would then
        re-create a lease nobody ever releases), then disable all
        future refreshes (a staging thread that outlives its join
        timeout may still beat after the listener is cleared). Returns
        the FINAL lease record — the token the end-of-slice fence must
        judge."""
        with self._lock:
            self._stopped = True
            return self.lease

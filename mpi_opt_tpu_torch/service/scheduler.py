"""The resident multi-tenant sweep server (``python -m mpi_opt_tpu_torch
serve``; port of ``mpi_opt_tpu/service/scheduler.py``).

One long-lived process owns the card (or, with ``serve --platform cpu``,
the host) and multiplexes it across many concurrent sweeps. The
scheduler loop:

1. **admission** — queued job files move into tenant dirs, throttled
   by a per-tenant concurrency cap (``--max-active-per-tenant``).
2. **pick** — priority class, then earliest deadline, then fair share
   over runnable tenants: the tenant NAME that has consumed the fewest
   slices goes first, FIFO (submit order) within a name; a starvation
   floor ages waiting jobs upward. A lone tenant keeps getting re-picked.
3. **slice** — the chosen sweep runs IN-PROCESS via ``cli.main`` with
   server-owned ``--ledger``/``--checkpoint-dir``/``--resume`` and the
   server's ``--device``, under a cooperative slice hook
   (health/shutdown.py) that counts natural boundaries — gen_chunk /
   rung / TPE batch / wave / driver batch — and, at the budget, sets
   the SAME drain flag a platform SIGTERM sets. The sweep flushes a
   boundary snapshot and exits 75 through the existing drain path, so
   a time-sliced tenant's ledger is bit-identical to a solo run's.
4. **classify** — the slice's exit code drives the tenant state
   machine (tenants.py, codes from utils/exitcodes.py).

Running tenants in-process is what makes admission cheap: workload
instances (and with them trainers and on-card data) are cached for the
server's lifetime (programs.py), so a shape-matching tenant skips the
data load and reuses cuDNN's choices at its launch width. Nothing else
of a tenant stays on the card between slices: its population lives in
the sweep's frames and is freed when the slice returns (the server's
peak, ``torch.cuda.max_memory_allocated`` over its slices, goes into
its metrics summary).

Shutdown: a real SIGTERM/SIGINT drains the ACTIVE tenant at its next
boundary (the tenant's own guard handles the signal; the server reads
``shutdown.delivered_signal()`` after the slice to tell platform
death from its own slice expiry), parks it, and exits 0 — the spool on
disk IS the queue checkpoint, so a restarted server resumes every
in-flight tenant via the verified-snapshot + journal-prefix machinery.
A SIGKILLed server leaves a tenant marked ``running``; any surviving
fleet peer (or a restart) claims its expired/dead-holder lease and the
same resume path recovers it.

Fleet federation: N servers — one per host or card — share one spool.
Each registers under ``servers/<--server-id>.json`` (a live same-id
collision is refused; the default id keeps one server a spool), and
per-JOB admission is arbitrated by
``tenants/<job>/lease.json`` (service/leases.py): ``_pick_next``
acquires the pick's lease (a peer's live lease just skips the job), a
lease-refresh keeper rides the tenant's heartbeat path during the
slice, and every end-of-slice metadata write is fenced on the lease
token so a taken-over zombie's late writes are refused rather than
racing the new owner. Takeover is not a new recovery path: it is the
ordinary ``--resume`` against whatever the dead server's last boundary
flushed.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import threading
import time
import traceback
from typing import Callable, Optional

from mpi_opt_tpu_torch.obs import memory as obs_memory
from mpi_opt_tpu_torch.service import leases, tenants as tstates
from mpi_opt_tpu_torch.service.programs import ProgramCache
from mpi_opt_tpu_torch.service.spool import Spool, TenantDir
from mpi_opt_tpu_torch.utils.exitcodes import EX_UNAVAILABLE, classify


def _read_summary(log_path: str, start: int) -> Optional[dict]:
    """The last summary-shaped JSON line THIS slice appended to the
    tenant's run.log (same shape rule as launch.py's supervisor relay).

    ``start`` is the log's size when the slice began: run.log is
    append-only across the tenant's whole lifetime, and scanning past
    it would attribute a PREVIOUS slice's summary (and best_score) to
    a slice that crashed before printing its own."""
    from mpi_opt_tpu_torch.launch import _find_summary_line

    try:
        # errors="replace": the seek may land mid-multibyte-character in
        # some library's non-ASCII log line; summary lines themselves
        # are pure-ASCII json.dumps output, so replacement never
        # damages the line we want
        with open(log_path, errors="replace") as f:
            f.seek(max(start, os.path.getsize(log_path) - 100_000))
            line = _find_summary_line(f.read())
    except OSError:
        return None
    return json.loads(line) if line else None


class SweepService:
    #: how long a resource-exhaustion park (slice rc 74: disk full /
    #: device OOM — utils/resources.py) keeps the tenant OUT of the
    #: pick rotation. PARKED is deliberately non-terminal (freeing disk
    #: + the ordinary --resume slice recovers), but re-picking it
    #: immediately would spin the scheduler against a disk that is
    #: still full; the cooldown turns the spin into a bounded re-probe.
    IO_PARK_COOLDOWN_S = 60.0

    def __init__(
        self,
        state_dir: str,
        slice_boundaries: int = 8,
        slice_seconds: Optional[float] = None,
        max_active_per_tenant: int = 2,
        poll_seconds: float = 0.5,
        drain_on_empty: bool = False,
        metrics=None,
        metrics_stream=None,
        on_boundary: Optional[Callable] = None,
        on_slice_end: Optional[Callable] = None,
        trace: bool = False,
        server_id: Optional[str] = None,
        lease_ttl: float = 600.0,
        starvation_floor_s: float = 300.0,
        device: str = "cuda",
    ):
        if slice_boundaries < 1:
            raise ValueError(f"slice_boundaries must be >= 1, got {slice_boundaries}")
        if starvation_floor_s <= 0:
            raise ValueError(
                f"starvation_floor_s must be > 0, got {starvation_floor_s}"
            )
        if max_active_per_tenant < 1:
            raise ValueError(
                f"max_active_per_tenant must be >= 1, got {max_active_per_tenant}"
            )
        if lease_ttl <= 0:
            raise ValueError(f"lease_ttl must be > 0, got {lease_ttl}")
        self.spool = Spool(state_dir)
        # the device every tenant slice runs on (--device is
        # server-owned, spool.RESERVED_FLAGS)
        self.device = device
        # the largest allocator peak of any slice (reset at each slice's
        # start), for the server's metrics summary
        self._peak_bytes: Optional[int] = None
        # fleet identity: the default id COLLIDES on purpose (two
        # default-id servers refuse each other, keeping one server a
        # spool); federation is opted into with
        # distinct --server-id values. pid + /proc start time is the
        # fencing identity every lease this server takes will carry.
        self.server_id = server_id or Spool.DEFAULT_SERVER_ID
        self.lease_ttl = float(lease_ttl)
        self.starvation_floor_s = float(starvation_floor_s)
        self.ident = leases.ServerIdentity.local(self.server_id)
        self._takeovers = 0
        # server-registration heartbeat throttle (monotonic): refreshed
        # from the serve loop between slices AND from the active
        # tenant's beats during one (a long slice must not let the
        # registration go stale — a remote peer judges us by its ts),
        # capped so an enormous TTL still keeps the fleet view usable
        self._server_refresh_every = min(self.lease_ttl / 3.0, 10.0)
        self._server_refresh_next = 0.0
        self._usurped = False
        self._reg_lock = threading.Lock()
        self.slice_boundaries = slice_boundaries
        self.slice_seconds = slice_seconds
        self.max_active_per_tenant = max_active_per_tenant
        self.poll_seconds = poll_seconds
        self.drain_on_empty = drain_on_empty
        self.programs = ProgramCache()
        # serve --trace: every tenant slice runs with span tracing into
        # its own tenant-dir metrics stream (tenant-tagged records), and
        # the server's own scheduling spans go to server-metrics.jsonl —
        # `python -m mpi_opt_tpu_torch trace STATE_DIR` merges the lot
        self.trace = bool(trace)
        # test/drill seams: on_boundary(tenant, stage, n) fires from the
        # slice hook (deterministic injection point for drills that need
        # "mid-slice" timing); on_slice_end(tenant) after classification
        self.on_boundary = on_boundary
        self.on_slice_end = on_slice_end
        if metrics is None:
            from mpi_opt_tpu_torch.utils.metrics import MetricsLogger

            metrics = MetricsLogger(path=self.spool.metrics_path, stream=metrics_stream)
        self.metrics = metrics
        # terminal tenants never change state again, but they stay in
        # the spool as the durable record — cache their status so the
        # loop's cost tracks LIVE tenants, not all-time spool history
        self._terminal_cache: dict = {}
        # per-job incremental idle trackers (serve --trace): each slice
        # end refreshes the tenant's idle_frac from its span stream, and
        # re-parsing the whole file every slice would be O(n^2) over a
        # resident tenant's lifetime — the tracker reads only the bytes
        # appended since its last poll (obs/bubbles.StreamIdleTracker).
        # Dropped when the job goes terminal.
        self._idle_trackers: dict = {}
        # per-loop-iteration memos: the scheduling steps (_admit_pending,
        # _apply_queued_cancels, _pick_next, _all_quiet) each scan the
        # spool, and neither the tenants/ directory listing nor a live
        # tenant's status.json should be re-read three-plus times per
        # 0.1 s poll; cleared at the top of every iteration, invalidated
        # on every scheduler-side write (status) / admission (listing —
        # clients also materialize tenant dirs via cancel-while-queued,
        # which the next iteration's fresh listing picks up)
        self._status_memo: dict = {}
        self._tenants_memo: Optional[list] = None
        # queue files are written ONCE (atomic submit) and only ever
        # removed, so the tenant name — all the admission cap check
        # needs — is cached by path across iterations: a long queue
        # waiting behind a capped tenant must not cost one JSON parse
        # per file per poll tick
        self._queued_name_cache: dict = {}
        # fair-share usage is SESSION-scoped: seeded from live (parked/
        # running) jobs' slice counts so a restart resumes fairness for
        # in-flight work, but a tenant's long-finished history does not
        # starve its next job for as many slices as it ever consumed
        self._usage: dict = {}
        # jobs already terminal at bring-up never entered the tally, so
        # pre-mark them retired — _retire_usage must not subtract their
        # history from a LIVE sibling job's seeded usage
        self._retired: set = set()
        for t in self.spool.tenants():
            s = t.status
            if s.get("state") in tstates.TERMINAL:
                self._retired.add(s.get("id") or t.job_id)
            else:
                name = s.get("tenant", "default")
                self._usage[name] = self._usage.get(name, 0) + int(
                    s.get("slices") or 0
                )

    # -- scheduling --------------------------------------------------

    def _tenant_status(self, t: TenantDir) -> dict:
        s = self._terminal_cache.get(t.job_id)
        if s is not None:
            return s
        s = self._status_memo.get(t.job_id)
        if s is not None:
            return s
        s = t.status
        if s.get("state") in tstates.TERMINAL:
            self._terminal_cache[t.job_id] = s
            # a terminal the scheduler didn't produce (client cancelled a
            # parked job directly) still retires its fair-share usage
            self._retire_usage(s)
        else:
            self._status_memo[t.job_id] = s
        return s

    def _wrote_status(self, t: TenantDir) -> None:
        self._status_memo.pop(t.job_id, None)

    def _tenants(self) -> list:
        if self._tenants_memo is None:
            self._tenants_memo = self.spool.tenants()
        return self._tenants_memo

    def _active_counts(self) -> dict:
        counts: dict = {}
        for t in self._tenants():
            s = self._tenant_status(t)
            if s.get("state") not in tstates.TERMINAL:
                counts[s.get("tenant", "default")] = (
                    counts.get(s.get("tenant", "default"), 0) + 1
                )
        return counts

    def _admit_pending(self) -> None:
        """Queue -> tenant dirs, oldest first, honoring the per-tenant
        concurrency cap (capped jobs stay queued — admission order is
        re-derived every loop, so a cap freed by one tenant finishing
        admits the next job with no bookkeeping)."""
        from mpi_opt_tpu_torch.service.spool import SpoolError, _read_json

        counts = self._active_counts()
        pending = self.spool.pending_jobs()
        cache = self._queued_name_cache
        for stale in set(cache) - set(pending):
            del cache[stale]  # admitted, cancelled, or quarantined
        for qpath in pending:
            name = cache.get(qpath)
            if name is None:
                spec = _read_json(qpath) or {}
                name = spec.get("tenant", "default")
                cache[qpath] = name
            if counts.get(name, 0) >= self.max_active_per_tenant:
                continue
            try:
                t = self.spool.admit(qpath)
            except SpoolError as e:
                self.metrics.log("tenant_reject", error=str(e))
                continue
            except OSError as e:
                # persistent I/O failure mid-admission: the queue file
                # (or a half-built tenant dir) survives on disk, so the
                # next loop iteration retries — one sick write must not
                # kill the server every other tenant is riding on
                self.metrics.log("tenant_reject", error=f"admission I/O: {e}")
                continue
            counts[name] = counts.get(name, 0) + 1
            self._tenants_memo = None  # a new tenant dir exists now
            self.metrics.log("tenant_admit", job=t.job_id, tenant=name)

    def _apply_queued_cancels(self) -> None:
        for t in self._tenants():
            s = self._tenant_status(t)
            # state first: the memo/terminal-cache lookup is a dict hit,
            # cancel_requested() is a stat — keep per-iteration syscalls
            # proportional to LIVE tenants, not all-time spool history
            if s.get("state") in tstates.RUNNABLE and t.cancel_requested():
                # the terminal write is lease-guarded: a peer that just
                # picked this tenant (parked -> about to run) holds the
                # lease, and our CANCELLED write would race its RUNNING
                # one — it will honor the cancel flag at its own first
                # boundary instead
                try:
                    lease = leases.acquire(t.lease, self.ident, self.lease_ttl)
                except OSError:
                    continue  # sick lease I/O: retry next iteration
                if lease is None:
                    continue
                # re-read under OUR lease: a peer may have run (or even
                # finished) a slice between our status snapshot and the
                # acquisition — writing the stale snapshot would erase
                # its slice accounting
                s = t.status
                if s.get("state") in tstates.RUNNABLE:
                    t.write_status(dict(s, state=tstates.CANCELLED))
                    self._wrote_status(t)
                    self._retire_usage(s)  # a parked job may have slices
                    self.metrics.log("tenant_cancelled", job=t.job_id, at="queue")
                leases.release(t.lease, lease)

    def _retire_usage(self, status: dict) -> None:
        """Remove a newly-terminal job's slice count from the in-session
        fair-share tally (every one of its slices was added here +1 at a
        time, or seeded at restart while the job was still live).
        Idempotent per job — a client-cancelled parked job reaches this
        both from _tenant_status's terminal-cache insertion and, for
        scheduler-produced terminals, from the transition site itself."""
        job_id = status.get("id")
        if job_id in self._retired:
            return
        self._retired.add(job_id)
        # the job's incremental idle tracker dies with it — EVERY
        # terminal transition funnels through here (slice end, queue
        # cancel, terminal-cache insertion), so a parked job cancelled
        # at the queue cannot leak its interval lists for the server's
        # lifetime
        self._idle_trackers.pop(job_id, None)
        name = status.get("tenant", "default")
        self._usage[name] = max(
            0, self._usage.get(name, 0) - int(status.get("slices") or 0)
        )

    def _takeover_candidate(self, t: TenantDir, s: dict) -> Optional[dict]:
        """Is this RUNNING tenant orphaned? Orphaned when its lease is
        absent (a pre-lease spool, or a crash in the claim window — the
        durable state is whatever the last boundary flushed) or expired
        / held by a provably dead process (the SIGKILLed-server shape).
        A RUNNING tenant with a live lease belongs to a working peer.
        Returns the dead holder's lease record as evidence (``{}`` for
        a lease-less orphan), or None when not a candidate — the
        record is captured HERE because by acquisition time a racing
        peer's steal may have the file mid-tomb (absent)."""
        if s.get("state") != tstates.RUNNING:
            return None
        lease = leases.read_lease(t.lease)
        if lease is None:
            return {}
        return lease if leases.expired(lease) else None

    def _pick_next(self) -> Optional[tuple]:
        """Priority class first, earliest deadline within it, then fair
        share (fewest-slices tenant name, FIFO within) — then ACQUIRE
        the pick's lease. Returns ``(tenant, lease, takeover_from)`` or
        None.

        The priority key is EFFECTIVE priority: the submitted class
        plus one class per ``starvation_floor_s`` the job has waited
        since submission — the starvation floor. A saturating stream of
        high-priority work therefore delays low-priority tenants by a
        bounded number of floors, never forever (a prio-0 job outranks
        a fresh prio-2 one after 2 floors of waiting). Deadlines order
        WITHIN a class (earliest first, deadline-less last), so urgency
        expressed as "finish by T" and importance expressed as a class
        stay independent axes.

        Acquisition is the fleet arbiter: a candidate whose lease a
        peer wins is skipped (never blocked on), so N servers sharing
        the spool settle every conflict at the lease file, not in
        scheduler logic. ``takeover_from`` is the dead holder's server
        id when the pick was an orphaned RUNNING tenant (the takeover
        shape), else None."""
        candidates = []
        for t in self._tenants():
            s = self._tenant_status(t)
            if s.get("state") in tstates.RUNNABLE:
                # resource-park cooldown: a tenant parked on rc 74
                # (disk full / device OOM) carries retry_after_ts —
                # skip it until the clock passes, so the fleet probes
                # the still-exhausted resource on a bounded cadence
                # instead of spinning slices against it
                try:
                    if float(s.get("retry_after_ts") or 0.0) > time.time():
                        continue
                except (TypeError, ValueError):
                    pass
                candidates.append((t, s, None))
            else:
                prior = self._takeover_candidate(t, s)
                if prior is not None:
                    candidates.append((t, s, prior))
        now = time.time()

        def _rank(tsk):
            t, s, _prior = tsk
            try:
                prio = int(s.get("priority") or 0)
            except (TypeError, ValueError):
                prio = 0
            try:
                waited = max(0.0, now - float(s.get("submitted_ts") or now))
            except (TypeError, ValueError):
                waited = 0.0
            eff_prio = prio + int(waited // self.starvation_floor_s)
            try:
                deadline = float(s["deadline_ts"])
            except (KeyError, TypeError, ValueError):
                deadline = float("inf")
            return (
                -eff_prio,
                deadline,
                self._usage.get(s.get("tenant", "default"), 0),
                t.job_id,
            )

        candidates.sort(key=_rank)
        for t, _s0, prior in candidates:
            try:
                lease = leases.acquire(t.lease, self.ident, self.lease_ttl)
            except OSError:
                # persistently sick I/O on ONE lease file must not kill
                # the server: skip the job this round, the next loop
                # iteration (or a healthier peer) retries
                continue
            if lease is None:
                continue  # a live peer holds (or just won) this job
            # re-read under OUR lease — for EVERY pick, not just the
            # takeover shape: a peer may have run the job to terminal
            # (or applied a cancel) between our candidacy snapshot and
            # the acquisition, and scheduling from the stale snapshot
            # would resurrect a settled tenant
            s = t.status
            state = s.get("state")
            if state in tstates.RUNNABLE:
                return t, lease, None
            if state == tstates.RUNNING:
                # still the orphan shape (we hold its lease: no live
                # peer does) — take it over
                from_server = (
                    (prior or {}).get("server_id")
                    or s.get("server")
                    or "unknown"
                )
                return t, lease, from_server
            leases.release(t.lease, lease)  # settled while we raced
        return None

    # -- the slice ---------------------------------------------------

    def _slice_argv(self, t: TenantDir, status: dict) -> list:
        # --resume UNCONDITIONALLY: empty ledger/checkpoint dirs start
        # fresh under it, and a server killed mid-FIRST-slice leaves
        # slices=0 with durable state already on disk — a fresh (non
        # -resume) retry would trip the CLI's stale-state refusal
        # (exit 2) and terminally fail a perfectly recoverable tenant
        argv = list(t.job["argv"]) + [
            "--ledger",
            t.ledger,
            "--checkpoint-dir",
            t.ckpt,
            "--resume",
            # per-tenant heartbeat (server-owned, like --ledger): beat
            # records carry the rank's active span phase, which is what
            # the status/report clients surface as an ACTIVE tenant's
            # live phase (spool.live_phase)
            "--heartbeat-file",
            t.heartbeat,
            "--device",
            self.device,
        ]
        if self.trace:
            argv += ["--metrics-file", t.metrics, "--trace"]
        return argv

    def _run_slice(
        self, t: TenantDir, lease: dict, takeover_from: Optional[str] = None
    ) -> Optional[str]:
        """One scheduling quantum on the device, under a HELD lease
        (the caller acquired it in ``_pick_next``). Returns the REAL
        signal name if one was delivered mid-slice (the server must
        drain), else None. Every tenant-metadata write below is fenced
        on the lease token, and the lease is released on every exit
        path we still own it on."""
        from mpi_opt_tpu_torch.cli import TRACE_TAG_ENV
        from mpi_opt_tpu_torch.cli import main as cli_main
        from mpi_opt_tpu_torch.health import heartbeat, shutdown
        from mpi_opt_tpu_torch.service.spool import SpoolError

        # a real signal may land between the serve loop's shutdown check
        # and here (spool scans, the argparse probe): the SERVER guard
        # absorbed it, and the clear_delivered() below would erase the
        # evidence — so the tenant would burn a full quantum before the
        # drain. Re-check now, before any tenant state changes.
        if shutdown.requested() or shutdown.delivered_signal():
            leases.release(t.lease, lease)
            return shutdown.delivered_signal() or shutdown.active_signal()

        status = t.status
        try:
            argv = self._slice_argv(t, status)
        except SpoolError as e:
            # one tenant's unreadable job.json must not take down the
            # server (and every other tenant with it): terminal-fail
            # just this tenant and keep scheduling
            t.write_status(dict(status, state=tstates.FAILED, note=str(e)))
            leases.release(t.lease, lease)
            self._wrote_status(t)
            self._retire_usage(status)
            self.metrics.log("tenant_reject", job=t.job_id, error=str(e))
            return None
        from mpi_opt_tpu_torch.obs import trace

        try:
            # acquire builds the shared workload instance on first use
            # (get_workload -> cls(): dataset caches, disk, arbitrary
            # user code) and the log open touches the tenant's own dir —
            # either failing must terminal-fail THIS tenant, same as the
            # unreadable-job.json case above: the tenant is still
            # RUNNABLE at this point, so letting the exception out would
            # crash-loop every restarted server on the same pick
            with trace.span("slice_setup", job=t.job_id):
                key, cache_hit, workload = self.programs.acquire(argv)
                log_start = os.path.getsize(t.log) if os.path.exists(t.log) else 0
                logf = open(t.log, "a")
        except Exception as e:
            t.write_status(
                dict(status, state=tstates.FAILED, note=f"slice setup failed: {e}")
            )
            leases.release(t.lease, lease)
            self._wrote_status(t)
            self._retire_usage(status)
            self.metrics.log("tenant_reject", job=t.job_id, error=str(e))
            return None
        if takeover_from is not None:
            # the takeover IS the existing resume machinery — all that
            # is new is the bookkeeping: the tenant's durable state is
            # whatever the dead server's last boundary flushed, and the
            # --resume in _slice_argv picks it up via verified-snapshot
            # + journal-prefix exactly like a restart would
            self._takeovers += 1
            status = dict(
                status,
                takeovers=int(status.get("takeovers") or 0) + 1,
                note=f"lease takeover from {takeover_from}",
            )
            self.metrics.count_takeovers()
            self.metrics.log(
                "tenant_takeover",
                job=t.job_id,
                from_server=takeover_from,
                to_server=self.server_id,
            )
        # slice_started_ts: the live-phase surface's elapsed anchor
        # (spool.live_phase reads it back while the slice runs);
        # server: which fleet member holds the device for this slice
        t.write_status(
            dict(
                status,
                state=tstates.RUNNING,
                server=self.server_id,
                slice_started_ts=round(time.time(), 4),
            )
        )
        self._wrote_status(t)
        self.metrics.log(
            "slice_start",
            job=t.job_id,
            tenant=status.get("tenant", "default"),
            server=self.server_id,
            slice=int(status.get("slices") or 0) + 1,
            program_cache_hit=cache_hit,
        )
        boundaries = 0
        t0 = time.perf_counter()
        # the lease keeper: rides every heartbeat beat (driver batch,
        # fused launch, wave sub-segment, staging transfer), refreshing
        # the deadline at ttl/3 cadence; on fencing (we were presumed
        # dead and taken over) it requests the SAME drain a slice
        # expiry does, so the zombie slice parks at its next boundary
        # instead of running on against a tenant it no longer owns
        refresher = leases.Refresher(
            t.lease, lease, self.lease_ttl, on_fenced=shutdown.request
        )

        def hook(stage: str) -> None:
            nonlocal boundaries
            boundaries += 1
            refresher()  # boundary-granular refresh floor (beat-less sweeps)
            if self.on_boundary is not None:
                self.on_boundary(t, stage, boundaries)
            # delivered_signal: a real signal that landed in the sliver
            # between the pre-slice check and the tenant guard's install
            # went to the SERVER guard, which the tenant's own handler
            # can't see — treat it like drain so the park still happens
            # at the FIRST boundary, not after a full quantum
            if (
                refresher.fenced
                or t.cancel_requested()
                or self.spool.drain_requested()
                or shutdown.delivered_signal()
            ):
                shutdown.request()
                return
            if boundaries >= self.slice_boundaries or (
                self.slice_seconds is not None
                and time.perf_counter() - t0 >= self.slice_seconds
            ):
                shutdown.request()

        # NO clear_delivered() here: the serve loop clears the window at
        # bring-up and breaks on any truthy delivery, so _DELIVERED is
        # None when a slice starts — a truthy value at any point from
        # here on IS this slice's signal, and erasing it would burn a
        # full quantum before the server notices (the hook above and the
        # post-slice read both depend on it surviving)
        def on_beat(rec) -> None:
            # two refreshes ride every unit of tenant progress: the
            # job's lease (the Refresher) and OUR fleet registration —
            # the serve loop is blocked inside this very slice, and a
            # registration left unrefreshed for a long slice would let
            # a remote peer judge a live server dead
            refresher(rec)
            self._refresh_registration()

        shutdown.set_slice_hook(hook)
        heartbeat.set_beat_listener(on_beat)
        # tenant tag for the slice's span records: cli.main's trace
        # wiring reads it, so a merged state-dir trace attributes phases
        # per tenant. Env (not a flag) because the spool's job argv must
        # stay exactly what the client submitted. Only touched under
        # serve --trace, and the operator's own pre-existing value is
        # restored afterwards — the slice must be env-side-effect-free.
        prev_tag = os.environ.get(TRACE_TAG_ENV)
        if self.trace:
            os.environ[TRACE_TAG_ENV] = status.get("tenant", "default")
        # per-slice watermark window: the allocator's peak resets here, so
        # the post-slice reading below is THIS slice's footprint, not a
        # previous (possibly larger) tenant's
        obs_memory.reset_peak(self.device)
        # the slice span emits AFTER cli.main restores the server's own
        # sink (trace nesting contract), so it lands in the SERVER
        # stream with the tenant's in-slice spans as its children
        _slice_span = trace.span("slice", job=t.job_id)
        try:
            with _slice_span, logf:
                logf.write(f"--- slice {int(status.get('slices') or 0) + 1} ---\n")
                with contextlib.redirect_stdout(logf), contextlib.redirect_stderr(
                    logf
                ):
                    try:
                        rc = cli_main(argv, _workload=workload)
                    except SystemExit as e:
                        # parser.error and friends (in-process argparse).
                        # Match what the same argv would do as a
                        # subprocess: None exits 0, a string message
                        # prints and exits 1 — and the message must land
                        # in run.log (we ARE its stderr right now), not
                        # vanish with the exception
                        if e.code is None:
                            rc = 0
                        elif isinstance(e.code, int):
                            rc = e.code
                        else:
                            logf.write(f"{e.code}\n")
                            rc = 1
                    except KeyboardInterrupt:
                        raise
                    # sweeplint: disable=drain-swallow -- tenant-slice containment: one tenant's escaped error terminal-fails the slice (rc=1 in run.log), it must not kill the resident server; cli.main maps SweepInterrupted to exit 75 before it could reach here
                    except BaseException:
                        logf.write(traceback.format_exc())
                        rc = 1
        finally:
            heartbeat.clear_beat_listener()
            shutdown.clear_slice_hook()
            if self.trace:
                if prev_tag is None:
                    os.environ.pop(TRACE_TAG_ENV, None)
                else:
                    os.environ[TRACE_TAG_ENV] = prev_tag
        wall = time.perf_counter() - t0
        delivered = shutdown.delivered_signal()
        # settle the refresher BEFORE judging the fence: an in-flight
        # refresh (a straggler beat from a staging thread that outlived
        # the listener clear) holds the lease file mid-rename, and
        # judging held()/release() through that absence window would
        # falsely fence a healthy slice — and then strand the refreshed
        # lease unreleased until the TTL
        final_lease = refresher.stop()

        cancel = t.cancel_requested()
        state = tstates.after_slice(rc, cancel)
        if state in (tstates.DONE, tstates.PARKED, tstates.CANCELLED):
            # the sweep completed or drained at a boundary — both are
            # past its set-up, so the key's trainer really exists now
            self.programs.commit(key)
        # the fence: if our lease stopped carrying our token, this job
        # was taken over while we were presumed dead — the new owner's
        # status/ledger records are authoritative and EVERY write we
        # intended for this tenant is abandoned (no status, no usage,
        # no release: the lease is not ours to give up). The program
        # commit above stays — it records set-ups in THIS process.
        if refresher.fenced or not leases.held(t.lease, final_lease):
            self.metrics.log(
                "slice_fenced",
                job=t.job_id,
                rc=rc,
                boundaries=boundaries,
                wall_s=round(wall, 3),
            )
            return delivered
        status = t.status  # re-read: cancel client may have raced a write
        status["state"] = state
        status["slices"] = int(status.get("slices") or 0) + 1
        status["boundaries"] = int(status.get("boundaries") or 0) + boundaries
        # capped tail: state classification uses rc directly and the
        # full per-slice record lives in the metrics stream — an
        # unbounded array would make every slice end rewrite (and every
        # status call re-parse) O(total slices) on a long-lived server
        status["rc_history"] = ((status.get("rc_history") or []) + [rc])[-32:]
        # resource-exhaustion park (rc 74): stamp the cooldown + reason
        # so _pick_next holds the tenant out of rotation until the
        # resource had a chance to be freed; any OTHER slice outcome
        # clears the stamp (the resource answer is stale once a slice
        # ran again)
        if state == tstates.PARKED and classify(rc) == "io_error":
            status["park_reason"] = "io_error"
            status["retry_after_ts"] = round(
                time.time() + self.IO_PARK_COOLDOWN_S, 4
            )
        else:
            status.pop("park_reason", None)
            status.pop("retry_after_ts", None)
        if state == tstates.PARKED and not delivered and classify(rc) != "io_error":
            # resource parks are not slice preemptions: the tenant did
            # not drain at its budget, the RESOURCE refused the write
            status["preemptions"] = int(status.get("preemptions") or 0) + 1
        pc = status.setdefault("program_cache", {"hits": 0, "misses": 0})
        pc["hits" if cache_hit else "misses"] += 1
        if status.get("first_slice_wall_s") is None:
            # time-to-first-trial proxy: the first slice carries all of
            # the tenant's set-up (data load and cuDNN's first launches
            # on a miss, none of it on a hit)
            status["first_slice_wall_s"] = round(wall, 3)
            status["first_slice_program_cache_hit"] = cache_hit
        summary = _read_summary(t.log, log_start)
        if summary is not None:
            status["summary"] = summary
            if summary.get("best_score") is not None:
                status["best_score"] = summary["best_score"]
        # post-slice device-memory watermark (obs/memory.py): what this
        # tenant's residency costs the shared card, surfaced by
        # `status`/`report DIR`. The allocator's peak was reset at slice
        # start, so `peak_bytes` is THIS slice's (scope "slice");
        # `bytes_in_use`, read after the slice's frames are collected, is
        # what the server keeps between slices: the program cache's
        # trainers and on-card data, nothing of a parked or finished
        # tenant. None on the CPU (the allocator is the card's)
        mem = None
        if obs_memory.sample(self.device) is not None:
            gc.collect()  # reference cycles of the slice's frames
            mem = obs_memory.watermark(self.device)
            status["device_memory"] = dict(mem, scope="slice")
            self._peak_bytes = max(self._peak_bytes or 0, mem["peak_bytes"])
        # per-tenant device-idle fraction: how much of the
        # tenant's traced wall the device sat in bubbles — computed
        # from the tenant's own span stream, cumulative across its
        # slices so far, so it exists only under serve --trace. The
        # admission/packing layer's other half beside device_memory:
        # a high-idle tenant is the co-residency candidate. The
        # tracker is incremental (only bytes appended since its last
        # poll are parsed) so a resident tenant's status refresh stays
        # O(slice), not O(stream); dropped when the job goes terminal.
        if self.trace:
            from mpi_opt_tpu_torch.obs.bubbles import StreamIdleTracker

            tracker = self._idle_trackers.get(t.job_id)
            if tracker is None:
                tracker = self._idle_trackers[t.job_id] = StreamIdleTracker(t.metrics)
            idle = tracker.poll()
            if idle is not None:
                status["idle_frac"] = idle
            # terminal cleanup happens in _retire_usage (the one funnel
            # every terminal transition passes through, including the
            # queue-cancel path that never reaches this slice-end code)
        t.write_status(status)
        # the lease outlived every write it fenced; give it up so any
        # fleet peer can pick the tenant for its next slice (fair share
        # stays per-server, the lease only arbitrates "who, right now")
        leases.release(t.lease, final_lease)
        self._wrote_status(t)
        name = status.get("tenant", "default")
        self._usage[name] = self._usage.get(name, 0) + 1
        if state in tstates.TERMINAL:
            # retire the finished job's whole slice history from the
            # fair-share ledger: usage is meant to balance LIVE work,
            # and on a long-lived server a tenant whose 50-slice job
            # just completed must not have its NEXT submission starved
            # for 50 slices (the restart seeding skips terminal jobs
            # for the same reason)
            self._retire_usage(status)
        self.metrics.count_slices()
        if cache_hit:
            self.metrics.count_program_cache(hits=1)
        else:
            self.metrics.count_program_cache(misses=1)
        if state == tstates.DONE:
            self.metrics.count_tenants_done()
        self.metrics.log(
            "slice_end",
            job=t.job_id,
            rc=rc,
            server=self.server_id,
            state=state,
            boundaries=boundaries,
            wall_s=round(wall, 3),
            signal=delivered,
            mem_peak_bytes=None if mem is None else mem.get("peak_bytes"),
        )
        if self.on_slice_end is not None:
            self.on_slice_end(t)
        return delivered

    # -- the loop ----------------------------------------------------

    def _all_quiet(self) -> bool:
        if self.spool.pending_jobs():
            return False
        return all(
            self._tenant_status(t).get("state") in tstates.TERMINAL
            for t in self._tenants()
        )

    def serve(self) -> int:
        from mpi_opt_tpu_torch.health import shutdown

        if not self.spool.register_server(
            self.server_id,
            slice_boundaries=self.slice_boundaries,
            lease_ttl=self.lease_ttl,
            takeovers=0,
        ):
            from mpi_opt_tpu_torch.service.spool import ServerClaimError, _read_json

            info = _read_json(self.spool.server_file(self.server_id)) or {}
            raise ServerClaimError(
                f"a live server (pid {info.get('pid')}) already owns "
                f"server-id {self.server_id!r} on {self.spool.state_dir}; "
                "one identity, one process — federate with a distinct "
                "--server-id"
            )
        self.spool.clear_drain()
        # open THIS server's signal-observation window: a signal a
        # previous in-process server (or sweep) absorbed is not ours
        shutdown.clear_delivered()
        trace_prior = None
        if self.trace:
            # server-side spans (slice/slice_setup) go to the server's
            # own stream; each tenant slice re-configures to its tenant
            # stream and cli.main restores this sink on the way out
            from mpi_opt_tpu_torch.obs import trace

            trace_prior = trace.configure(self.metrics)
        self.metrics.log(
            "serve_start",
            state_dir=self.spool.state_dir,
            server_id=self.server_id,
            lease_ttl=self.lease_ttl,
            slice_boundaries=self.slice_boundaries,
            max_active_per_tenant=self.max_active_per_tenant,
        )
        reason = "drain"
        rc = 0
        try:
            with shutdown.ShutdownGuard() as guard:
                while True:
                    self._status_memo.clear()
                    self._tenants_memo = None
                    if not self._heartbeat_server():
                        # zombie fencing, server edition: another
                        # process registered OUR id while we were
                        # presumed dead. Its leases fence our tenant
                        # writes; stepping down (not fighting) is the
                        # only move that cannot split-brain the spool.
                        reason = "usurped"
                        rc = EX_UNAVAILABLE
                        self.metrics.log(
                            "server_usurped", server_id=self.server_id
                        )
                        break
                    self._admit_pending()
                    self._apply_queued_cancels()
                    if guard.requested or shutdown.delivered_signal():
                        reason = f"signal {guard.signal_name or shutdown.delivered_signal()}"
                        break
                    if self.spool.drain_requested():
                        break
                    pick = self._pick_next()
                    if pick is None:
                        if self.drain_on_empty and self._all_quiet():
                            reason = "empty"
                            break
                        time.sleep(self.poll_seconds)
                        continue
                    t, lease, takeover_from = pick
                    delivered = self._run_slice(t, lease, takeover_from)
                    if delivered:
                        # the platform told the PROCESS to die; the
                        # active tenant already drained + parked through
                        # its own guard — park the server too
                        reason = f"signal {delivered}"
                        break
        finally:
            if self.trace:
                from mpi_opt_tpu_torch.obs import trace

                trace.deconfigure(trace_prior)
            # deregister ONLY if the file still records us: a stepped-
            # down zombie unlinking the usurper's live registration
            # would re-orphan the spool it just conceded
            self.spool.clear_server_if_mine(self.server_id)
            # the largest allocator peak of any slice on the card (None
            # on the CPU)
            self.metrics.summary(final=True, reason=reason,
                                 device_memory_peak_bytes=self._peak_bytes)
            self.metrics.close()
        return rc

    def _refresh_registration(self) -> None:
        """Refresh our fleet registration (throttled, monotonic): the
        ``ts`` stamp is what remote-host peers and the status client
        judge liveness by, and the takeover counter rides along.
        Called from the serve loop between slices and from the beat
        listener DURING one, so the longest unrefreshed gap is a beat
        gap, not a slice. Usurpation latches ``_usurped``; transient
        I/O failure rewinds the throttle so the next call retries —
        neither ever raises into a beating thread."""
        # non-blocking: beats arrive from more than one thread (main
        # loop, staging transfer) — the loser skips, it must not stall
        # the sweep behind the winner's registration write
        if not self._reg_lock.acquire(blocking=False):
            return
        try:
            now = time.monotonic()
            if self._usurped or now < self._server_refresh_next:
                return
            self._server_refresh_next = now + self._server_refresh_every
            try:
                mine = self.spool.refresh_server(
                    self.server_id,
                    takeovers=self._takeovers,
                    slices=self.metrics.slices,
                )
            except OSError:
                self._server_refresh_next = 0.0  # sick fs: retry next call
                return
            if mine is None:
                # unreadable != usurped: one torn read must not make a
                # healthy server abandon its fleet slot — retry soon
                self._server_refresh_next = 0.0
            elif mine is False:
                self._usurped = True
        finally:
            self._reg_lock.release()

    def _heartbeat_server(self) -> bool:
        """The serve loop's registration check: refresh, then report
        whether we still own our identity (False = step down)."""
        self._refresh_registration()
        return not self._usurped

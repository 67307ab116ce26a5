"""Thin spool clients + the ``serve`` entrypoint (CLI subcommands; port
of ``mpi_opt_tpu/service/client.py``).

Everything here talks to the service through the filesystem spool —
``submit``/``status``/``cancel``/``drain`` do no CUDA work (they start
in the time of an import) and work whether or not a server is
currently alive (a dead server's spool is still a readable queue; jobs
submitted to it run when one starts).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from mpi_opt_tpu_torch.service import tenants as tstates
from mpi_opt_tpu_torch.service.spool import ServerClaimError, Spool, SpoolError
from mpi_opt_tpu_torch.utils.exitcodes import EX_IOERR, EX_UNAVAILABLE, EX_USAGE


def _nonempty_dir(value: str) -> str:
    # `--state-dir ""` (a classic unset-shell-var slip) would otherwise
    # build the spool tree relative to the caller's cwd
    if not value:
        raise argparse.ArgumentTypeError("must be a non-empty path")
    return value


def _state_dir_parser(prog: str, description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"mpi_opt_tpu_torch {prog}", description=description)
    p.add_argument(
        "--state-dir",
        required=True,
        type=_nonempty_dir,
        metavar="DIR",
        help="the service spool directory (shared by server and clients)",
    )
    return p


def serve_main(argv) -> int:
    p = _state_dir_parser(
        "serve",
        "resident multi-tenant sweep server: owns the device, multiplexes "
        "it across submitted sweeps by time-slicing at natural boundaries; "
        "its tenants run on the card unless --platform cpu",
    )
    p.add_argument(
        "--slice-boundaries",
        type=int,
        default=8,
        metavar="N",
        help="scheduling quantum: preempt the running tenant after N "
        "natural boundaries (gen_chunk/rung/TPE-batch/wave/driver-batch); "
        "the drain flushes a boundary snapshot so the park is free",
    )
    p.add_argument(
        "--slice-seconds",
        type=float,
        default=None,
        metavar="S",
        help="additional wall-clock quantum: preempt at the FIRST boundary "
        "past S seconds (whichever of the two budgets trips first)",
    )
    p.add_argument(
        "--max-active-per-tenant",
        type=int,
        default=2,
        metavar="N",
        help="admission cap: at most N non-terminal jobs per tenant name; "
        "excess jobs wait in the queue",
    )
    p.add_argument(
        "--server-id",
        default=None,
        metavar="ID",
        help="this server's fleet identity (registered under "
        "servers/<ID>.json; a live same-id collision is refused). Give "
        "each server of a multi-server spool a distinct id; the default "
        "id deliberately collides, preserving one-server-per-spool",
    )
    p.add_argument(
        "--lease-ttl",
        type=float,
        default=600.0,
        metavar="S",
        help="per-job lease deadline: a job whose lease went this long "
        "without a refresh may be taken over by any live server (a "
        "provably dead same-host holder is taken over immediately, so "
        "a generous TTL costs only cross-host takeover latency). Size "
        "it above the longest gap between heartbeat beats: one launch, "
        "or a tenant's cold set-up (data upload, cuDNN's first launches)",
    )
    p.add_argument(
        "--starvation-floor",
        type=float,
        default=300.0,
        metavar="S",
        help="priority aging interval: every S seconds a queued job "
        "waits promotes it one effective priority class, so a "
        "saturating high-priority stream delays low-priority tenants "
        "by a bounded number of floors, never forever",
    )
    p.add_argument(
        "--poll-seconds", type=float, default=0.5, help="idle spool poll interval"
    )
    p.add_argument(
        "--drain-on-empty",
        action="store_true",
        help="exit once the queue is empty and every tenant is terminal "
        "(batch/drill mode; without it the server stays resident)",
    )
    p.add_argument(
        "--trace",
        action="store_true",
        help="span-trace every tenant slice into the tenant's own "
        "metrics.jsonl (tenant-tagged records) and the server's "
        "scheduling into server-metrics.jsonl; render the whole "
        "multi-tenant picture with `python -m mpi_opt_tpu_torch trace "
        "STATE_DIR`",
    )
    p.add_argument(
        "--platform",
        default=None,
        choices=["cpu", "gpu"],
        help="the device every tenant runs on, chosen ONCE at server "
        "bring-up (tenants may not: the server owns the device): gpu, the "
        "card (the default; the server fails without one), or cpu",
    )
    p.add_argument(
        "--local-devices",
        type=int,
        default=None,
        help="the JAX CLI's virtual CPU devices; a port server owns one "
        "device, so it is a usage error",
    )
    args = p.parse_args(argv)
    if args.slice_boundaries < 1:
        p.error(f"--slice-boundaries must be >= 1, got {args.slice_boundaries}")
    if args.slice_seconds is not None and args.slice_seconds <= 0:
        p.error(f"--slice-seconds must be > 0, got {args.slice_seconds}")
    if args.max_active_per_tenant < 1:
        p.error(
            f"--max-active-per-tenant must be >= 1, got {args.max_active_per_tenant}"
        )
    if args.lease_ttl <= 0:
        p.error(f"--lease-ttl must be > 0, got {args.lease_ttl}")
    if args.starvation_floor <= 0:
        p.error(f"--starvation-floor must be > 0, got {args.starvation_floor}")
    if args.server_id is not None and (
        not args.server_id
        or not all(c.isalnum() or c in "._-" for c in args.server_id)
    ):
        # the id becomes a filename under servers/ — a separator or
        # shell glob in it would scatter registrations around the tree
        p.error(
            f"--server-id {args.server_id!r} must be non-empty "
            "letters/digits/._- only"
        )
    # device bring-up happens HERE, once, before any tenant runs: every
    # slice gets the server's --device. No card and no --platform cpu
    # is a failure, never a quiet run on the host
    if args.local_devices is not None:
        p.error("--local-devices makes the JAX package's virtual CPU devices; a port "
                "server owns one device")
    device = "cpu" if args.platform == "cpu" else "cuda"
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("serve: CUDA is not available; pass --platform cpu to serve on the "
                  "CPU", file=sys.stderr)
            return EX_UNAVAILABLE
    from mpi_opt_tpu_torch.service.scheduler import SweepService

    service = SweepService(
        args.state_dir,
        slice_boundaries=args.slice_boundaries,
        slice_seconds=args.slice_seconds,
        max_active_per_tenant=args.max_active_per_tenant,
        poll_seconds=args.poll_seconds,
        drain_on_empty=args.drain_on_empty,
        metrics_stream=sys.stdout,
        trace=args.trace,
        server_id=args.server_id,
        lease_ttl=args.lease_ttl,
        starvation_floor_s=args.starvation_floor,
        device=device,
    )
    try:
        return service.serve()
    except ServerClaimError as e:
        # ONLY the one-server-per-spool refusal is usage-shaped; any
        # other exception is a server crash and must keep its traceback
        print(str(e), file=sys.stderr)
        return EX_USAGE
    except OSError as e:
        from mpi_opt_tpu_torch.utils.resources import is_storage_full

        if not is_storage_full(e):
            raise
        # the SPOOL's disk filled (a tenant-status write, a queue
        # admission): retry_io answered immediately instead of
        # spinning, and the spool on disk IS the queue checkpoint —
        # nothing is lost. Park the whole server with the classified
        # code: free disk, restart, and every in-flight tenant resumes
        # through the ordinary recovery.
        print(
            f"{e}\nspool disk full: server parked (exit {EX_IOERR}); "
            "free disk space and restart `serve` — the spool state on "
            "disk is the queue checkpoint, in-flight tenants resume",
            file=sys.stderr,
        )
        return EX_IOERR


def submit_main(argv) -> int:
    p = _state_dir_parser(
        "submit",
        "queue a sweep on a service spool; everything after `--` is the "
        "sweep's own CLI arguments (the flat mpi_opt_tpu_torch surface, minus "
        "the server-owned flags)",
    )
    p.add_argument(
        "--tenant",
        default="default",
        help="tenant name for fair-share scheduling and concurrency caps",
    )
    p.add_argument(
        "--priority",
        type=int,
        default=0,
        metavar="N",
        help="priority class (higher admits first, default 0; the "
        "server's starvation floor ages waiting jobs upward so no "
        "class starves the rest)",
    )
    p.add_argument(
        "--deadline",
        type=float,
        default=None,
        metavar="S",
        help="soft deadline S seconds from now: orders admission "
        "WITHIN a priority class (earliest deadline first); surfaced "
        "in status/report",
    )
    p.add_argument(
        "sweep_args",
        nargs=argparse.REMAINDER,
        metavar="-- ARGS",
        help="sweep CLI arguments (prefix with `--`)",
    )
    args = p.parse_args(argv)
    if args.deadline is not None and args.deadline <= 0:
        p.error(f"--deadline must be > 0 seconds from now, got {args.deadline}")
    sweep = list(args.sweep_args)
    if sweep and sweep[0] == "--":
        sweep = sweep[1:]
    if not sweep:
        p.error("no sweep arguments given (append `-- --workload ... [flags]`)")
    spool = Spool(args.state_dir)
    deadline_ts = None if args.deadline is None else time.time() + args.deadline
    try:
        job_id = spool.submit(
            sweep,
            tenant=args.tenant,
            priority=args.priority,
            deadline_ts=deadline_ts,
        )
    except SpoolError as e:
        p.error(str(e))
    print(
        json.dumps(
            {
                "job": job_id,
                "tenant": args.tenant,
                "state": "queued",
                "priority": args.priority,
                "deadline_ts": deadline_ts,
            }
        )
    )
    return 0


def _collect_servers(records: list, spool: Spool, owners: dict) -> list:
    """The fleet table: one row per registration (``records`` is ONE
    ``read_servers()`` scan, shared with the aggregate header — status
    runs against the contended shared filesystems fleets live on, so
    the directory is listed once, not per consumer), live or dead (a
    dead row is evidence — its jobs are the takeover candidates).
    ``owners`` maps server_id -> list of job ids whose LIVE lease
    names it (computed by the caller from the lease scan, so the
    tenant walk happens once too)."""
    out = []
    now = time.time()
    for rec in records:
        sid = rec.get("server_id")
        row = {
            "server_id": sid,
            "pid": rec.get("pid"),
            "pid_start": rec.get("pid_start"),
            "host": rec.get("host"),
            "alive": spool.server_alive(rec),
            "lease_ttl": rec.get("lease_ttl"),
            "takeovers": rec.get("takeovers"),
            "slices": rec.get("slices"),
            "tenants": owners.get(sid, []),
        }
        try:
            row["refreshed_age_s"] = round(max(0.0, now - float(rec["ts"])), 3)
        except (KeyError, TypeError, ValueError):
            row["refreshed_age_s"] = None
        out.append(row)
    return out


def _collect_status(spool: Spool) -> dict:
    from mpi_opt_tpu_torch.service import leases

    server_records = spool.read_servers()
    server = (
        max(server_records, key=lambda r: float(r.get("ts") or 0.0))
        if server_records
        else None
    )
    jobs = []
    for qpath in spool.pending_jobs():
        from mpi_opt_tpu_torch.service.spool import _read_json

        spec = _read_json(qpath) or {}
        jobs.append(
            {
                "job": spec.get("id", os.path.basename(qpath)[:-5]),
                "tenant": spec.get("tenant", "default"),
                # same label submit printed and admission will write:
                # "queued" means "not yet running" on every surface —
                # a script polling right after submit must not see a
                # third state the lifecycle diagram doesn't have
                "state": tstates.QUEUED,
                "priority": int(spec.get("priority") or 0),
                "deadline_ts": spec.get("deadline_ts"),
            }
        )
    from mpi_opt_tpu_torch.service.spool import live_phase

    owners: dict = {}
    for t in spool.tenants():
        s = t.status
        # the job's lease, surfaced raw-ish: who holds it and whether
        # the hold is still live — `status` is the operator's first
        # stop when deciding if a "running" job is real work or an
        # orphan a surviving server is about to take over
        lease = leases.read_lease(t.lease)
        lease_view = None
        if lease is not None:
            live = not leases.expired(lease)
            lease_view = {
                "server_id": lease.get("server_id"),
                "live": live,
                "expires_ts": lease.get("expires_ts"),
            }
            if live:
                owners.setdefault(lease.get("server_id"), []).append(t.job_id)
        job = {
            "job": t.job_id,
            "tenant": s.get("tenant", "default"),
            "state": s.get("state"),
            "priority": int(s.get("priority") or 0),
            "deadline_ts": s.get("deadline_ts"),
            "slices": s.get("slices"),
            "preemptions": s.get("preemptions"),
            "boundaries": s.get("boundaries"),
            "best_score": s.get("best_score"),
            "program_cache": s.get("program_cache"),
            "first_slice_wall_s": s.get("first_slice_wall_s"),
            # post-slice device-memory watermark (obs/memory.py via the
            # scheduler): what this tenant's residency costs the device
            "device_memory": s.get("device_memory"),
            # cumulative device-idle fraction from the tenant's span
            # stream (obs/bubbles.py; written per slice end under
            # serve --trace) — the co-residency signal beside memory
            "idle_frac": s.get("idle_frac"),
            # fleet fields: which server ran the last slice, how many
            # times the job changed hands, and the current lease hold
            "server": s.get("server"),
            "takeovers": s.get("takeovers"),
            "lease": lease_view,
        }
        # an ACTIVE tenant surfaces what it is doing right now: the
        # phase from its heartbeat (fed by the active trace span) and
        # how long the current slice has been on the device
        live = live_phase(t.dir, s)
        if live is not None:
            job.update(live)
        jobs.append(job)
    servers = _collect_servers(server_records, spool, owners)
    return {
        "state_dir": spool.state_dir,
        # aggregate single-server view kept for scripts that predate
        # the fleet: alive = ANY live registration, fields from the
        # most recently refreshed one
        "server": {
            "alive": any(s["alive"] for s in servers),
            **({} if server is None else server),
        },
        "servers": servers,
        "draining": spool.drain_requested(),
        "jobs": jobs,
    }


def status_main(argv) -> int:
    p = _state_dir_parser("status", "one view of a service spool's jobs")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    args = p.parse_args(argv)
    try:
        spool = Spool(args.state_dir, create=False)
    except SpoolError as e:
        p.error(str(e))
    info = _collect_status(spool)
    if args.json:
        print(json.dumps(info))
        return 0
    servers = info["servers"]
    n_up = sum(1 for s in servers if s["alive"])
    if len(servers) > 1 or (servers and not servers[0]["alive"]):
        head = f"{n_up}/{len(servers)} servers up"
    else:
        head = "server up" if n_up else "server down"
    print(
        f"service {info['state_dir']}: {head}"
        + (" [draining]" if info["draining"] else "")
    )
    # the fleet table: per-server liveness (registration freshness +
    # pid/proc-start identity), owned jobs, and takeover counts — the
    # operator's answer to "which host is doing what, and is the dead
    # one's work safe" without grepping server logs
    for s in servers:
        state = "up" if s["alive"] else "DEAD"
        age = s.get("refreshed_age_s")
        owned = s.get("tenants") or []
        line = (
            f"  server {s['server_id']}  {state}  "
            f"pid={s.get('pid')}@{s.get('host')}"
            f" start={s.get('pid_start')}"
        )
        if age is not None:
            line += f" refreshed={age}s ago"
        if s.get("takeovers"):
            line += f" takeovers={s['takeovers']}"
        if owned:
            line += f" owns={','.join(owned)}"
        print(line)
    if not info["jobs"]:
        print("  no jobs")
    now = time.time()
    for j in info["jobs"]:
        extra = ""
        if j.get("priority"):
            extra += f"  prio={j['priority']}"
        if j.get("deadline_ts"):
            try:
                left = float(j["deadline_ts"]) - now
                extra += (
                    f" deadline={left:+.0f}s" if left >= 0
                    else f" deadline=OVERDUE {-left:.0f}s"
                )
            except (TypeError, ValueError):
                pass
        if j.get("slices") is not None:
            extra = (
                f"  slices={j['slices']} preemptions={j.get('preemptions')}"
                f" best={j.get('best_score')}"
            )
            pc = j.get("program_cache") or {}
            if pc.get("hits") or pc.get("misses"):
                extra += f" cache={pc.get('hits', 0)}h/{pc.get('misses', 0)}m"
            mem = j.get("device_memory") or {}
            if mem.get("peak_bytes"):
                extra += f" mem={mem['peak_bytes'] / (1 << 20):.0f}MiB"
            if j.get("idle_frac") is not None:
                extra += f" idle={j['idle_frac']:.0%}"
            if j.get("server"):
                extra += f" on={j['server']}"
            if j.get("takeovers"):
                extra += f" takeovers={j['takeovers']}"
        lease = j.get("lease")
        if j.get("state") == "running" and lease is not None and not lease["live"]:
            # the fleet's load-bearing warning: "running" with a dead
            # hold is an orphan awaiting takeover, not live work
            extra += f" lease=EXPIRED (was {lease.get('server_id')})"
        if j.get("state") == "running" and (
            j.get("phase") or j.get("slice_elapsed_s") is not None
        ):
            extra += (
                f" phase={j.get('phase')}"
                f" slice_elapsed={j.get('slice_elapsed_s')}s"
            )
        print(f"  {j['job']}  tenant={j['tenant']}  {j['state']}{extra}")
    return 0


def cancel_main(argv) -> int:
    p = _state_dir_parser(
        "cancel",
        "cancel a job: queued jobs cancel immediately; a running job "
        "drains at its next natural boundary (snapshot + ledger intact — "
        "nothing is killed, nothing quarantined) and frees the device",
    )
    p.add_argument("job", help="job id (see `python -m mpi_opt_tpu_torch status`)")
    args = p.parse_args(argv)
    try:
        state = Spool(args.state_dir, create=False).cancel(args.job)
    except SpoolError as e:
        p.error(str(e))
    print(json.dumps({"job": args.job, "state": state, "cancel": True}))
    return 0


def drain_main(argv) -> int:
    p = _state_dir_parser(
        "drain",
        "ask the server to stop: it finishes the active slice (parking "
        "the tenant at a boundary) and exits; the spool keeps the queue, "
        "so a restarted server continues where this one left off",
    )
    p.add_argument(
        "--wait",
        type=float,
        default=None,
        metavar="S",
        help="block up to S seconds for the server to exit",
    )
    args = p.parse_args(argv)
    try:
        spool = Spool(args.state_dir, create=False)
    except SpoolError as e:
        p.error(str(e))
    spool.request_drain()
    if args.wait is not None:
        deadline = time.monotonic() + args.wait
        while spool.server_alive():
            if time.monotonic() >= deadline:
                print(
                    f"server still alive after {args.wait}s", file=sys.stderr
                )
                return 1
            time.sleep(0.2)
    print(json.dumps({"drain": True, "server_alive": spool.server_alive()}))
    return 0

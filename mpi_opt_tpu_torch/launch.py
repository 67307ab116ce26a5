"""Coordinated multi-process launch + recovery supervisor (port of
``mpi_opt_tpu/launch.py``: the same flags, events and exit-code
classes, spawning ``python -m mpi_opt_tpu_torch`` ranks).

For the one topology where per-process ``--retries`` is unsound:
multi-process SPMD. One rank restoring a snapshot while its peers sit in a collective
issues mismatched programs and hangs the job — so recovery there must
be a COORDINATED job restart. This module is that coordination, and the
``mpirun``-equivalent front door (the reference's launcher role):

    python -m mpi_opt_tpu_torch.launch --n-proc 4 --retries 2 -- \
        --workload cifar100_resnet18 --algorithm pbt --fused \
        --checkpoint-dir /ckpt/sweep --population 1024 ...

It spawns ``--n-proc`` ranks of ``python -m mpi_opt_tpu_torch`` (appending
``--coordinator/--num-processes/--process-id`` for each, plus
``--coord-dir/--coord-epoch`` wiring the boundary-agreement control
plane — parallel/coord.py — with a fresh epoch per attempt so a
restarted job can never read a killed attempt's stale votes), watches
them, and on ANY rank death kills the survivors and relaunches ALL ranks —
with ``--resume`` appended when the job has durable state
(``--checkpoint-dir`` or ``--ledger``), so the restarted job continues
from the last shared snapshot / journal and (because fused-sweep resume
is bit-identical, tested) finishes with the result the unkilled job
would have produced. Without durable state a restart re-runs the
(deterministic) sweep from scratch.

Three failure classes, three treatments (README: failure-handling
matrix):

- RANK DEATH (nonzero exit, not 75): coordinated restart, consuming one
  unit of the ``--retries`` budget. Transient-vs-program classification
  is deliberately NOT attempted (a supervisor sees exit codes, not
  exception types); a program bug burns its retries in seconds and
  surfaces the rank's stderr, a platform death resumes and completes.
- PREEMPTION (exit 75 = EX_TEMPFAIL, the graceful-shutdown protocol's
  code; or SIGTERM delivered to the supervisor itself): not a failure.
  A rank exiting 75 has drained and flushed; the supervisor restarts
  with ``--resume`` WITHOUT consuming ``--retries`` (bounded by
  ``--max-preemptions`` so a deterministic self-preempting bug cannot
  restart forever). The supervisor being SIGTERMed forwards the signal
  to all ranks, drains them for ``--term-grace`` seconds, then exits 75
  itself — so nested supervision composes.
- HANG (``--stall-timeout``): ranks are alive but their heartbeat files
  (health/heartbeat.py, auto-wired via ``--heartbeat-file``) have
  stopped advancing — a wedged collective or dead I/O that exit-code
  polling can never see. The job is killed and coordinate-restarted,
  consuming one retry.
- COLLECTIVE WEDGE (rank death under SPMD): when a rank dies hard, its
  survivors don't crash — they freeze inside the collective (or the
  coord plane's boundary barrier) waiting for the dead peer, heartbeats
  stuck in a ``train``/``boundary``/staging phase. The exit path
  classifies that shape (dead rank + survivors frozen mid-collective),
  emits ``rank_wedge``, TERM-drains the survivors with the usual
  ``--term-grace`` escalation, and funds ONE coordinated ``--resume``
  restart from the rank-death retry budget — the restarted ledger is
  record-identical to an unkilled run (fused resume is bit-identical).

Two non-retryable classifications cut restart storms short:

- DATA ERROR (exit 65 = EX_DATAERR): the rank's resume found snapshots
  but NONE verified (utils/integrity.py quarantined every retained
  step). Restarting re-reads the same poisoned state — abort with
  diagnostics immediately instead of burning the whole retries/
  preemption budget on a crash loop. (Exit 2, a usage error, is
  refused for the analogous reason — see below.)
- CRASH LOOP (``--crash-loop-threshold``/``--crash-loop-window``): N
  consecutive failure restarts where each attempt died within the
  window are a deterministic bug regardless of exit code — abort even
  while ``--retries`` budget remains, so a large budget sized for rare
  platform deaths can't be burned in seconds.

Escalation is always graceful-first: survivors/stragglers get SIGTERM
(their own drain handlers flush state) and only after ``--term-grace``
seconds SIGKILL.

Per-rank stdout/stderr go to ``--log-dir`` (default: a temp dir,
printed) as ``rank{i}.out``/``rank{i}.err``, truncated per attempt;
rank 0's final summary line is re-printed on the supervisor's stdout so
scripted callers keep the single-JSON-line contract.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import socket
import subprocess
import sys
import tempfile
import time

from mpi_opt_tpu_torch.health.shutdown import ShutdownGuard
from mpi_opt_tpu_torch.health.watchdog import StallDetector
from mpi_opt_tpu_torch.utils.exitcodes import EX_DATAERR, EX_IOERR, EX_TEMPFAIL, EX_USAGE


def _backoff_s(attempt: int, base: float, jitter: float, rng: random.Random) -> float:
    """Seconds to wait before coordinated restart ``attempt`` (1-based):
    jittered exponential, ``base * 2**(attempt-1)`` scaled by up to
    ``jitter`` extra. An immediate relaunch hammers a flapping platform
    (a worker mid-restart rejects the reconnect, burning a retry for
    nothing), and the jitter keeps N supervisors that died together from
    reconnecting in lockstep."""
    if base <= 0:
        return 0.0
    return base * (2 ** (attempt - 1)) * (1.0 + jitter * rng.random())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _hb_path(log_dir: str, rank: int) -> str:
    return os.path.join(log_dir, f"rank{rank}.hb")


def _stall_phases(log_dir: str, ranks) -> dict:
    """``{rank: phase}`` for stalled ranks, from each rank's LAST beat
    record: the ``phase`` field (the rank's active trace span at beat
    time — obs/trace.py) with the beat's ``stage`` progress label as
    fallback. Turns a bare "ranks [1] stalled" kill into "rank 1
    stalled during stage_in". Unknown phases report None — the beat
    predates the span layer or carried no phase."""
    from mpi_opt_tpu_torch.health.heartbeat import read_beat

    phases = {}
    for i in ranks:
        rec = read_beat(_hb_path(log_dir, i)) or {}
        phases[str(i)] = rec.get("phase") or (rec.get("progress") or {}).get(
            "stage"
        )
    return phases


def _is_collective_phase(phase) -> bool:
    """Is this last-beat phase one a rank holds while inside (or
    waiting to enter) a collective — the shape a survivor freezes in
    when a peer dies mid-job? ``train`` covers fused launches,
    ``boundary*`` the boundary ops AND the coord plane's agreement
    barrier (whose waits deliberately stop advancing beats), the
    staging phases the transfer engine's barriers. The port's stage
    labels too (a beat without a trace phase reports its stage):
    ``boundary {op}`` (``train/engine.py::boundary_span``), ``pbt train
    sub-launch i/n`` (fused PBT's ``--step-chunk`` beats, between
    training collectives), ``staging transfer`` (the stage-out worker)
    and ``... dispatched`` (a wave, whose state gather follows)."""
    return bool(phase) and (
        phase == "train"
        or phase.startswith("boundary")
        or phase.startswith("stage")
        or phase.startswith("staging")
        or phase.startswith("pbt train sub-launch")
        or phase.endswith(" dispatched")
    )


def _spawn_ranks(
    n: int, rest: list[str], log_dir: str, heartbeat: bool = False, coord=None
):
    """One attempt's rank processes; a fresh coordinator port each time
    (the previous attempt's port may linger in TIME_WAIT). With
    ``heartbeat`` each rank gets ``--heartbeat-file`` pointed at its
    per-rank file under ``log_dir`` (the stall watchdog's input).
    ``coord`` is ``(dir, epoch)`` wiring each rank's boundary-agreement
    plane — the epoch is the supervisor's relaunch counter, so every
    attempt votes in a namespace no dead attempt ever touched."""
    port = _free_port()
    # rank env is INHERITED (Popen env=None): the kernel build
    # directory and CUDA settings reach every attempt of every rank
    procs = []
    # incremental build + cleanup-on-failure: if Popen dies mid-loop
    # (fork EAGAIN, interpreter gone), the already-spawned ranks would
    # otherwise leak as orphans wedged in process-group bring-up
    # waiting for peers that will never start — and their log handles
    # with them. Kill and close everything spawned so far, then re-raise.
    try:
        for i in range(n):
            argv = [
                sys.executable,
                "-m",
                "mpi_opt_tpu_torch",
                *rest,
                "--coordinator",
                f"127.0.0.1:{port}",
                "--num-processes",
                str(n),
                "--process-id",
                str(i),
            ]
            if heartbeat:
                argv += ["--heartbeat-file", _hb_path(log_dir, i)]
            if coord is not None:
                argv += ["--coord-dir", coord[0], "--coord-epoch", str(coord[1])]
            out = open(os.path.join(log_dir, f"rank{i}.out"), "w")
            err = open(os.path.join(log_dir, f"rank{i}.err"), "w")
            try:
                procs.append(
                    (subprocess.Popen(argv, stdout=out, stderr=err, text=True), out, err)
                )
            except BaseException:
                # this rank's handles are not in procs yet
                out.close()
                err.close()
                raise
    except BaseException:
        for p, out, err in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            out.close()
            err.close()
        raise
    return procs


def _find_summary_line(text: str):
    """The LAST line of a rank's stdout that has the summary-JSON shape:
    a JSON object that is not a metrics event (``stdout_logger`` also
    prints ``{"event": ...}`` records to stdout). Blindly re-printing
    the last line broke the single-JSON-line contract whenever trailing
    non-summary output followed the summary (a stray library print, a
    late metrics flush); scanning for the shape keeps the relay correct
    regardless of what lands after it. Returns None when no line
    qualifies (the caller then falls back to the raw last line so a
    rank whose output format drifted still surfaces SOMETHING)."""
    for line in reversed(text.splitlines()):
        line = line.strip()
        if not (line.startswith("{") and line.endswith("}")):
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict) and "event" not in obj:
            return line
    return None


def _stop_all(procs, grace: float) -> None:
    """Stop every live rank: SIGTERM first (a draining rank flushes its
    checkpoint/ledger and exits 75 on its own), escalate to SIGKILL only
    after ``grace`` seconds — a rank wedged mid-collective never answers
    the TERM, and waiting on it forever recreates the hang this
    supervisor exists to bound."""
    for p, _, _ in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + max(0.0, grace)
    for p, _, _ in procs:
        while p.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
    for p, _, _ in procs:
        if p.poll() is None:
            p.kill()
    for p, out, err in procs:
        p.wait()
        out.close()
        err.close()


def _watch(procs, poll_s: float, grace: float, detector=None, guard=None):
    """Block until the job resolves; returns one of
    ``("done", None)`` — every rank exited 0;
    ``("exit", i)`` — rank i exited nonzero (survivors are stopped: they
    are mid-collective with a dead peer and will never finish alone);
    ``("stall", ranks)`` — ``detector`` saw those ranks' heartbeats
    frozen past the stall timeout while the processes live;
    ``("shutdown", signame)`` — the supervisor itself was asked to die
    (``guard``), so the ranks are drained and the caller exits 75."""
    try:
        while True:
            if guard is not None and guard.requested:
                return ("shutdown", guard.signal_name)
            running = False
            for i, (p, _, _) in enumerate(procs):
                rc = p.poll()
                if rc is None:
                    running = True
                elif rc != 0:
                    return ("exit", i)
            if not running:
                return ("done", None)
            if detector is not None:
                # liveness filter: a rank that EXITED 0 leaves its last
                # heartbeat frozen forever — that is teardown, not a
                # stall, and must not get healthy survivors killed
                stale = [
                    i for i in detector.poll() if procs[i][0].poll() is None
                ]
                if stale:
                    return ("stall", stale)
            time.sleep(poll_s)
    finally:
        _stop_all(procs, grace)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi_opt_tpu_torch.launch",
        description="spawn + supervise an N-process SPMD job with "
        "coordinated restart-on-failure recovery",
    )
    parser.add_argument("--n-proc", type=int, required=True)
    parser.add_argument(
        "--retries",
        type=int,
        default=0,
        help="coordinated full-job restarts after any rank death or "
        "stall (resumes from the last snapshot when the job "
        "checkpoints). Preemptions (rank exit 75) do NOT consume this "
        "budget — see --max-preemptions",
    )
    parser.add_argument("--log-dir", default=None, help="per-rank stdout/stderr")
    parser.add_argument(
        "--poll-interval", type=float, default=0.2, help="rank liveness poll (s)"
    )
    parser.add_argument(
        "--restart-backoff",
        type=float,
        default=1.0,
        metavar="SECONDS",
        help="base delay before a coordinated restart; doubles per "
        "attempt with up to 50%% random jitter (0 disables). Preemption "
        "restarts wait only the (jittered) base — they are not failures "
        "and must not back off exponentially",
    )
    parser.add_argument(
        "--stall-timeout",
        type=float,
        default=None,
        metavar="SECONDS",
        help="hang watchdog: kill + coordinated-restart the job when "
        "any rank's heartbeat stops advancing for this long while the "
        "process lives (wedged collective, dead I/O). Ranks are only "
        "watched from their FIRST beat (first completed batch/launch), "
        "so cold start (kernel builds, cuDNN autotuning) is never timed; size the timeout "
        "above the longest legitimate gap between launches. Wires "
        "--heartbeat-file into every rank automatically",
    )
    parser.add_argument(
        "--term-grace",
        type=float,
        default=15.0,
        metavar="SECONDS",
        help="how long stopped ranks get to drain after SIGTERM before "
        "SIGKILL (graceful ranks flush checkpoint+ledger and exit 75 "
        "within this window)",
    )
    parser.add_argument(
        "--max-preemptions",
        type=int,
        default=16,
        metavar="N",
        help="bound on free preemption restarts (rank exit 75): a "
        "deterministically self-preempting program must not restart "
        "forever just because preemptions don't bill --retries",
    )
    parser.add_argument(
        "--crash-loop-threshold",
        type=int,
        default=3,
        metavar="N",
        help="abort after N CONSECUTIVE failure restarts whose attempts "
        "each died within --crash-loop-window seconds (0 disables): a "
        "job failing that fast is a deterministic bug, not platform "
        "weather, and must not grind through a large --retries budget",
    )
    parser.add_argument(
        "--crash-loop-window",
        type=float,
        default=30.0,
        metavar="SECONDS",
        help="an attempt shorter than this counts toward the crash-loop "
        "threshold; attempts that lived longer reset the streak",
    )
    parser.add_argument(
        "rest",
        nargs=argparse.REMAINDER,
        help="-- followed by the mpi_opt_tpu_torch CLI arguments for every rank",
    )
    args = parser.parse_args(argv)
    rest = args.rest
    if rest and rest[0] == "--":
        rest = rest[1:]
    if not rest:
        parser.error("pass the per-rank CLI arguments after '--'")
    if args.n_proc < 1:
        parser.error(f"--n-proc must be >= 1, got {args.n_proc}")
    # bad values are usage errors (rc=2 + message), not ValueError
    # tracebacks from the watchdog constructor deep in the launch loop
    if args.stall_timeout is not None and args.stall_timeout <= 0:
        parser.error(f"--stall-timeout must be > 0, got {args.stall_timeout}")
    if args.max_preemptions < 0:
        parser.error(
            f"--max-preemptions must be >= 0, got {args.max_preemptions}"
        )
    if args.term_grace < 0:
        parser.error(f"--term-grace must be >= 0, got {args.term_grace}")
    if args.crash_loop_threshold < 0:
        parser.error(
            f"--crash-loop-threshold must be >= 0, got {args.crash_loop_threshold}"
        )
    if args.crash_loop_window <= 0:
        parser.error(
            f"--crash-loop-window must be > 0, got {args.crash_loop_window}"
        )
    # argparse accepts both '--flag value' and '--flag=value'; match
    # flags by token prefix so the '=' spelling can't slip through the
    # ownership guard (or, below, defeat the --resume recovery append)
    def _has_flag(tokens, flag):
        return any(t == flag or t.startswith(flag + "=") for t in tokens)

    for banned in (
        "--coordinator",
        "--num-processes",
        "--process-id",
        "--retries",
        "--heartbeat-file",
        "--coord-dir",
        "--coord-epoch",
    ):
        if _has_flag(rest, banned):
            parser.error(
                f"{banned} is owned by the supervisor; don't pass it in "
                "the per-rank arguments"
            )
    log_dir = args.log_dir or tempfile.mkdtemp(prefix="mpi_opt_tpu_torch_launch_")
    os.makedirs(log_dir, exist_ok=True)
    coord_root = None
    if args.n_proc > 1:
        # the boundary-agreement control plane (parallel/coord.py)
        # lives under the supervisor's log dir; wipe it via the coord
        # module's own reset (the agreement surface has one writer) so
        # a reused --log-dir cannot leak a previous JOB's epochs —
        # between this job's own attempts the advancing --coord-epoch
        # is the isolation, no wipe needed while ranks may be reading
        coord_root = os.path.join(log_dir, "coord")
        from mpi_opt_tpu_torch.parallel.coord import reset_dir

        reset_dir(coord_root)

    # --resume on restart is valid whenever the job has durable state to
    # continue from: verified snapshots (--checkpoint-dir) or the trial
    # journal (--ledger); --resume on empty state starts fresh, which is
    # also correct
    has_resumable = _has_flag(rest, "--checkpoint-dir") or _has_flag(rest, "--ledger")
    watch_stalls = args.stall_timeout is not None
    backoff_rng = random.Random(os.getpid())
    attempt = 0  # failure restarts consumed (vs --retries)
    preemptions = 0  # free restarts consumed (vs --max-preemptions)
    stalls = 0
    relaunches = 0
    fast_fails = 0  # consecutive failures quicker than --crash-loop-window

    def _event(name, **fields):
        print(json.dumps({"event": name, **fields}), flush=True)

    def _crash_looping(attempt_wall: float) -> bool:
        """Account one failure outcome; True when the consecutive
        fast-failure streak hits the breaker threshold."""
        nonlocal fast_fails
        if attempt_wall < args.crash_loop_window:
            fast_fails += 1
        else:
            fast_fails = 0
        return 0 < args.crash_loop_threshold <= fast_fails

    def _crash_loop_abort(detail: str, **event_fields) -> int:
        """The breaker's one abort surface (shared by the stall and
        rank-exit paths): failed event + diagnostics, rc 1."""
        _event(
            "failed",
            crash_loop=True,
            consecutive_fast_failures=fast_fails,
            window_s=args.crash_loop_window,
            **event_fields,
        )
        sys.stderr.write(
            f"crash loop: {fast_fails} consecutive failures, each within "
            f"{args.crash_loop_window}s of launch ({detail}); aborting "
            "instead of burning the restart budget.\n"
        )
        return 1

    with ShutdownGuard() as guard:
        while True:
            if guard.requested:
                # preempted between attempts (e.g. during backoff sleep)
                _event("preempted", signal=guard.signal_name)
                return EX_TEMPFAIL
            rank_args = list(rest)
            if relaunches > 0 and has_resumable and "--resume" not in rank_args:
                # the restarted job continues from the last shared
                # snapshot / journal
                rank_args.append("--resume")
            _event(
                "launch",
                attempt=attempt,
                n_proc=args.n_proc,
                log_dir=log_dir,
                resume="--resume" in rank_args,
            )
            detector = None
            if watch_stalls:
                # fresh detector AND fresh heartbeat files per attempt: a
                # stale file from the previous attempt would put the new
                # rank under watch while it is still starting up
                for i in range(args.n_proc):
                    try:
                        os.unlink(_hb_path(log_dir, i))
                    except FileNotFoundError:
                        pass
                detector = StallDetector(
                    [_hb_path(log_dir, i) for i in range(args.n_proc)],
                    args.stall_timeout,
                )
            t_attempt = time.monotonic()
            procs = _spawn_ranks(
                args.n_proc,
                rank_args,
                log_dir,
                heartbeat=watch_stalls,
                coord=None if coord_root is None else (coord_root, relaunches),
            )
            kind, info = _watch(
                procs, args.poll_interval, args.term_grace, detector, guard
            )
            attempt_wall = time.monotonic() - t_attempt
            if kind == "done":
                # success: re-surface rank 0's summary line as our own
                # (scan for the summary-JSON shape — trailing
                # non-summary output must not break the relay)
                with open(os.path.join(log_dir, "rank0.out")) as f:
                    text = f.read()
                line = _find_summary_line(text)
                if line is None:
                    lines = [l for l in text.splitlines() if l.strip()]
                    line = lines[-1] if lines else None
                if line is not None:
                    print(line, flush=True)
                _event(
                    "done",
                    attempts=attempt + 1,
                    preemptions=preemptions,
                    stalls_detected=stalls,
                )
                return 0
            if kind == "shutdown":
                # the supervisor itself was preempted: ranks were
                # TERM-drained by _watch's finally; exit 75 so an OUTER
                # supervisor (or the platform) treats this whole job as
                # gracefully preempted too
                _event("preempted", signal=info, preemptions=preemptions)
                return EX_TEMPFAIL
            if kind == "stall":
                stalls += 1
                # phase-tagged stall diagnostics: what each wedged rank
                # was DOING when its beats froze ("stalled during
                # stage_in"), from the last beat's active-span phase
                phases = _stall_phases(log_dir, info)
                phase_note = ", ".join(
                    f"rank {r} during {p}" for r, p in phases.items() if p
                )
                _event(
                    "stall",
                    ranks=info,
                    phases=phases,
                    stall_timeout=args.stall_timeout,
                    stalls_detected=stalls,
                )
                if attempt >= args.retries:
                    _event(
                        "failed",
                        stalled_ranks=info,
                        phases=phases,
                        attempts=attempt + 1,
                        stalls_detected=stalls,
                    )
                    sys.stderr.write(
                        f"ranks {info} stalled (no heartbeat progress in "
                        f"{args.stall_timeout}s"
                        + (f"; {phase_note}" if phase_note else "")
                        + "); retries exhausted.\n"
                    )
                    return 1
                if _crash_looping(attempt_wall):
                    return _crash_loop_abort(
                        f"last: ranks {info} stalled", stalled_ranks=info
                    )
                attempt += 1
                delay = _backoff_s(attempt, args.restart_backoff, 0.5, backoff_rng)
                relaunches += 1
                _event(
                    "stall_restart",
                    ranks=info,
                    phases=phases,
                    attempt=attempt,
                    of=args.retries,
                    backoff_s=round(delay, 3),
                )
                if delay > 0:
                    time.sleep(delay)
                continue
            # kind == "exit": rank `info` left with a nonzero code
            failed = info
            rc = procs[failed][0].returncode
            with open(os.path.join(log_dir, f"rank{failed}.err")) as f:
                tail = f.read()[-2000:]
            # every rank's LAST heartbeat phase (the files survive
            # _stop_all): the failed rank's phase says WHERE it died;
            # survivors frozen in a collective-holding phase are the
            # wedge signature classified below. Empty without
            # --stall-timeout (no heartbeats wired).
            phases = (
                _stall_phases(log_dir, range(args.n_proc)) if watch_stalls else {}
            )
            failed_phase = phases.get(str(failed))
            at_note = f" during {failed_phase}" if failed_phase else ""
            wedged = [
                i
                for i in range(args.n_proc)
                if i != failed and _is_collective_phase(phases.get(str(i)))
            ]
            if wedged and rc not in (EX_TEMPFAIL, EX_DATAERR, EX_USAGE):
                # collective wedge: the dead rank left its survivors
                # frozen mid-collective (they were TERM-drained, then
                # killed after --term-grace, by _watch's _stop_all).
                # The generic restart below IS the coordinated
                # recovery — this event names the shape so operators
                # (and the SPMD drill) see the classification, not
                # just a bare rank death
                _event(
                    "rank_wedge",
                    rank=failed,
                    returncode=rc,
                    survivors=wedged,
                    phases=phases,
                )
            if rc == EX_TEMPFAIL:
                # the graceful-shutdown protocol: the rank drained and
                # flushed before exiting. A coordinated resume costs the
                # platform nothing it hadn't already decided to spend —
                # so it does NOT consume the failure --retries budget.
                fast_fails = 0  # a drain is progress, not a crash loop
                preemptions += 1
                if preemptions > args.max_preemptions:
                    _event(
                        "failed",
                        rank=failed,
                        returncode=rc,
                        preemptions=preemptions,
                        preemption_budget_exhausted=True,
                    )
                    sys.stderr.write(
                        f"rank {failed} exited 75 (preempted) "
                        f"{preemptions} times, over --max-preemptions "
                        f"{args.max_preemptions}; a program that preempts "
                        "itself deterministically is a bug, not a "
                        f"platform event. Stderr:\n{tail}\n"
                    )
                    return 1
                # flat (jittered) base backoff: this is not a failure
                # and must not walk up the exponential schedule
                delay = _backoff_s(1, args.restart_backoff, 0.5, backoff_rng)
                relaunches += 1
                _event(
                    "preempt_restart",
                    rank=failed,
                    preemptions=preemptions,
                    of=args.max_preemptions,
                    backoff_s=round(delay, 3),
                )
                if delay > 0:
                    time.sleep(delay)
                continue
            if rc == EX_DATAERR:
                # snapshot-corruption dead end (utils/integrity.py): the
                # rank's resume found steps but every one failed
                # verification and was quarantined. A restart's --resume
                # re-reads the same poisoned directory — the exact
                # restart storm this supervisor must NOT fund. Abort
                # with diagnostics, budget untouched.
                _event(
                    "failed",
                    rank=failed,
                    returncode=rc,
                    attempts=attempt + 1,
                    data_error=True,
                )
                sys.stderr.write(
                    f"rank {failed} exited {EX_DATAERR} (EX_DATAERR): no "
                    "verified snapshot remains in its checkpoint "
                    "directory; not retrying a data error — run "
                    "`python -m mpi_opt_tpu_torch fsck` on the checkpoint dir, then "
                    "restart without --resume or point at fresh state. "
                    f"Stderr:\n{tail}\n"
                )
                return 1
            if rc == EX_IOERR:
                # resource exhaustion, classified (utils/resources.py):
                # device OOM with no wave left to halve, or a disk
                # still full after the retention-prune retry. The
                # state is intact — but a restart changes NOTHING
                # until an operator frees the resource, so retrying
                # burns the whole budget re-failing identically.
                # Abort with diagnostics, budget untouched.
                _event(
                    "failed",
                    rank=failed,
                    returncode=rc,
                    attempts=attempt + 1,
                    resource_exhausted=True,
                )
                sys.stderr.write(
                    f"rank {failed} exited {EX_IOERR} (EX_IOERR): device "
                    "or storage exhaustion — not retrying a resource "
                    "error. Free the resource (disk space; or reduce "
                    "residency via --wave-size auto / --population), "
                    "then relaunch with --resume to continue from the "
                    f"intact durable state. Stderr:\n{tail}\n"
                )
                return 1
            if rc == EX_USAGE:
                # argparse usage error: deterministic, and retrying would be
                # actively wrong — e.g. the CLI's stale-checkpoint-dir
                # refusal (exit 2) would be "recovered" by the retry's
                # --resume into silently replaying the old sweep, the exact
                # accident that refusal exists to stop. Surface it instead.
                _event(
                    "failed",
                    rank=failed,
                    returncode=rc,
                    attempts=attempt + 1,
                    usage_error=True,
                )
                sys.stderr.write(
                    f"rank {failed} rejected its arguments (rc=2); not "
                    f"retrying a usage error. Stderr:\n{tail}\n"
                )
                return 1
            if attempt >= args.retries:
                _event(
                    "failed",
                    rank=failed,
                    returncode=rc,
                    phase=failed_phase,
                    attempts=attempt + 1,
                    preemptions=preemptions,
                    stalls_detected=stalls,
                )
                sys.stderr.write(
                    f"rank {failed} died (rc={rc}){at_note}; retries "
                    f"exhausted. Last stderr:\n{tail}\n"
                )
                return 1
            if _crash_looping(attempt_wall):
                sys.stderr.write(f"last rank stderr:\n{tail}\n")
                return _crash_loop_abort(
                    f"last: rank {failed} rc={rc}{at_note}",
                    rank=failed,
                    returncode=rc,
                    phase=failed_phase,
                )
            attempt += 1
            delay = _backoff_s(attempt, args.restart_backoff, 0.5, backoff_rng)
            relaunches += 1
            _event(
                "restart",
                rank=failed,
                returncode=rc,
                phase=failed_phase,
                wedge=bool(wedged),
                attempt=attempt,
                of=args.retries,
                backoff_s=round(delay, 3),
            )
            if delay > 0:
                time.sleep(delay)


if __name__ == "__main__":
    sys.exit(main())

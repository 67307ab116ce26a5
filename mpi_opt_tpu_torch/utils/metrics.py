"""Sweep metrics (port of the pure-Python ``mpi_opt_tpu/utils/metrics.py``,
copied so that the port imports nothing of the JAX package):
``MetricsLogger`` (JSONL events and the counters the CLI's fused and
driver paths read), ``null_logger``, and the wall-clock-to-target helpers ``wall_to_target``,
``wall_to_target_launchwise``, ``sweep_wall_to_target``."""

from __future__ import annotations

import collections
import json
import sys
import threading
import time
from typing import IO, Optional


#: past this many held records ``MetricsLogger.hold`` writes them out:
#: a sweep with no launch boundary for a long time keeps bounded memory
MAX_HELD = 1 << 16


class MetricsLogger:
    """One JSON object per event to a file and/or a stream, plus the
    run's counters, reported by ``summary``.

    ``log`` writes its record at once. ``hold`` keeps a record in
    memory (the tracer's spans, ``obs/trace.py``: no JSON work and no
    write inside a training step) until ``flush`` writes every held
    record in one write: ``log`` flushes before its own record and
    ``close`` before closing, so the stream keeps the order in which
    things were recorded; the tracer flushes at every launch boundary."""

    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None, n_chips: int = 1):
        self._file = open(path, "a") if path else None
        self._stream = stream
        self._sink_lock = threading.Lock()  # whole lines, never interleaved
        # records ``hold`` keeps for ``flush``. A deque's append and
        # popleft are atomic: any thread holds, any thread flushes
        self._held: collections.deque = collections.deque()
        self.n_chips = max(1, n_chips)
        self.t_start = time.perf_counter()
        self.trials_done = 0
        # the driver's failure counters: FINAL non-ok results after
        # retries (disjoint by status), and retry ATTEMPTS
        self.trials_failed = 0
        self.trials_timeout = 0
        self.trials_retried = 0
        # evaluations the driver skipped: served from the exact-match
        # cache or replayed from the journal on resume (disjoint from
        # trials_done, so throughput never counts un-run work)
        self.cache_hits = 0
        self.replayed = 0
        # graceful-shutdown drains honoured (0 or 1 a run)
        self.preempted = 0
        # evaluations reaped at a deadline (no port backend has one yet)
        self.stalls_detected = 0
        # snapshot steps that failed verification on restore and were
        # quarantined before the walk-back
        self.snapshots_quarantined = 0
        # member records this process appended to the fused journal
        # (records verified on resume are not counted)
        self.members_journaled = 0
        # superseded snapshot steps deleted by the ENOSPC prune retry
        self.snapshots_pruned = 0
        # host-staging traffic of a wave-scheduled sweep
        self.staged_bytes = 0
        self.stage_overlap_s = 0.0
        # device-OOM wave halvings absorbed, and pre-launch wave clamps
        self.oom_backoffs = 0
        self.wave_resized = 0
        # the sweep service's server: slices run, tenants finished, the
        # program cache's hits and misses (a slice whose program key was
        # already built in this server is a hit), lease takeovers
        self.slices = 0
        self.tenants_done = 0
        self.program_cache_hits = 0
        self.program_cache_misses = 0
        self.takeovers = 0

    def log(self, event: str, **fields) -> dict:
        if self._held:
            self.flush()
        rec = self._record(time.perf_counter(), time.time(), event, fields)
        if self._file or self._stream:
            self._write(json.dumps(rec))
        return rec

    def hold(self, event: str, **fields) -> None:
        """Keep a record, stamped as ``log`` would stamp it now, for the
        next ``flush``."""
        self._held.append((time.perf_counter(), time.time(), event, fields))
        if len(self._held) >= MAX_HELD:
            self.flush()

    def flush(self) -> None:
        """Write every held record, in the order held, in one write."""
        held = []
        try:
            while True:
                held.append(self._held.popleft())
        except IndexError:
            pass
        if held and (self._file or self._stream):
            self._write("\n".join(json.dumps(self._record(*h)) for h in held))

    def _record(self, t: float, ts: float, event: str, fields: dict) -> dict:
        # ``t`` is this process's clock; ``ts`` the absolute epoch (a
        # field of the same name wins: a span brings its own end)
        return {
            "event": event,
            "t": round(t - self.t_start, 4),
            "ts": round(ts, 4),
            **fields,
        }

    def _write(self, lines: str) -> None:
        with self._sink_lock:
            if self._file:
                self._file.write(lines + "\n")
                self._file.flush()
            if self._stream:
                print(lines, file=self._stream, flush=True)

    def count_trials(self, n: int):
        self.trials_done += n

    def count_failure(self, status: str = "failed"):
        """One FINAL non-ok trial result (post-retry)."""
        if status == "timeout":
            self.trials_timeout += 1
        else:
            self.trials_failed += 1

    def count_retries(self, n: int = 1):
        self.trials_retried += n

    def count_cache_hits(self, n: int = 1):
        """Evaluations skipped by the exact-match ledger cache."""
        self.cache_hits += n

    def count_replayed(self, n: int = 1):
        """FINAL results served from the journal on a resume."""
        self.replayed += n

    def count_stalls(self, n: int = 1):
        self.stalls_detected += n

    def count_preempted(self, n: int = 1):
        self.preempted += n

    def count_quarantined(self, n: int = 1):
        self.snapshots_quarantined += n

    def count_journaled(self, n: int = 1):
        self.members_journaled += int(n)

    def count_pruned(self, n: int = 1):
        self.snapshots_pruned += int(n)

    def count_staging(self, staged_bytes: int = 0, overlap_s: float = 0.0):
        """Host-staging traffic from a wave-scheduled fused sweep."""
        self.staged_bytes += int(staged_bytes)
        self.stage_overlap_s += float(overlap_s)

    def count_oom_backoffs(self, n: int = 1):
        """Device-OOM wave halvings absorbed by the wave engine."""
        self.oom_backoffs += int(n)

    def count_wave_resized(self, n: int = 1):
        """Pre-launch wave-size clamps (estimate against budget)."""
        self.wave_resized += int(n)

    def count_slices(self, n: int = 1):
        """Service scheduling quanta (tenant slices) run."""
        self.slices += int(n)

    def count_tenants_done(self, n: int = 1):
        """Service tenants that finished (state done)."""
        self.tenants_done += int(n)

    def count_program_cache(self, hits: int = 0, misses: int = 0):
        """Service slices by whether their program key was already built."""
        self.program_cache_hits += int(hits)
        self.program_cache_misses += int(misses)

    def count_takeovers(self, n: int = 1):
        """Expired-lease tenant takeovers this server performed."""
        self.takeovers += int(n)

    @property
    def wall(self) -> float:
        return time.perf_counter() - self.t_start

    def trials_per_sec_per_chip(self) -> float:
        return self.trials_done / max(self.wall, 1e-9) / self.n_chips

    def summary(self, **extra) -> dict:
        return self.log(
            "summary",
            trials=self.trials_done,
            trials_failed=self.trials_failed,
            trials_retried=self.trials_retried,
            trials_timeout=self.trials_timeout,
            cache_hits=self.cache_hits,
            replayed=self.replayed,
            preempted=self.preempted,
            stalls_detected=self.stalls_detected,
            snapshots_quarantined=self.snapshots_quarantined,
            staged_bytes=self.staged_bytes,
            stage_overlap_s=round(self.stage_overlap_s, 3),
            members_journaled=self.members_journaled,
            slices=self.slices,
            tenants_done=self.tenants_done,
            program_cache_hits=self.program_cache_hits,
            program_cache_misses=self.program_cache_misses,
            takeovers=self.takeovers,
            oom_backoffs=self.oom_backoffs,
            wave_resized=self.wave_resized,
            snapshots_pruned=self.snapshots_pruned,
            wall_s=round(self.wall, 3),
            trials_per_sec_per_chip=round(self.trials_per_sec_per_chip(), 4),
            **extra,
        )

    def close(self):
        self.flush()
        if self._file:
            self._file.close()
            self._file = None


def null_logger() -> MetricsLogger:
    return MetricsLogger()


def stdout_logger(path: Optional[str] = None, n_chips: int = 1) -> MetricsLogger:
    return MetricsLogger(path=path, stream=sys.stdout, n_chips=n_chips)


def wall_to_target(curve, wall_s: float, target: float):
    """Prorated wall-clock (seconds) until a per-generation best-score
    curve first reaches ``target``; None if it never does.

    The metric-of-record definition (BASELINE.json: "wall-clock to
    target validation accuracy"): generations are uniform work, so
    reaching the target at generation g costs (g+1)/G of the sweep's
    wall. Single-sourced here so every bench compares raw float curve
    values against the target identically.
    """
    curve = [float(v) for v in curve]
    for g, v in enumerate(curve):
        if v >= target:
            return wall_s * (g + 1) / len(curve)
    return None


def wall_to_target_launchwise(curve, launch_gens, launch_walls, target: float):
    """``wall_to_target`` with MEASURED per-launch wall times.

    A gen-chunked fused sweep runs as N launches of ``launch_gens[i]``
    generations taking ``launch_walls[i]`` seconds each (fused_pbt
    returns both). Whole-sweep prorating assumes every generation costs
    the same; here only generations *within* one launch are prorated
    (the scan's iterations really are identical programs), and launch
    boundaries use their measured times — tightening the granularity
    error from one sweep-fraction to at most one launch's interior.
    None if the curve never reaches target.
    """
    if len(launch_gens) != len(launch_walls):
        raise ValueError(
            f"launch_gens ({len(launch_gens)}) and launch_walls "
            f"({len(launch_walls)}) must align"
        )
    if sum(launch_gens) != len(curve):
        raise ValueError(
            f"launch_gens sums to {sum(launch_gens)} but curve has "
            f"{len(curve)} generations"
        )
    curve = [float(v) for v in curve]
    g0 = 0  # first generation index of the current launch
    done = 0.0  # wall of all completed launches before it
    for n_g, w in zip(launch_gens, launch_walls):
        for j in range(n_g):
            if curve[g0 + j] >= target:
                return done + w * (j + 1) / n_g
        g0 += n_g
        done += w
    return None


def sweep_wall_to_target(result: dict, wall_s: float, target: float):
    """Launch-granular when the sweep result carries measured launch
    durations (fused_pbt always does for fresh sweeps), whole-sweep
    prorating otherwise (``launch_walls`` is None when a resume from a
    pre-upgrade snapshot left early durations unknown).

    Semantics note: ``launch_walls`` deliberately excludes checkpoint-
    save time (the metric measures the sweep's compute-to-target),
    while the fallback's ``wall_s`` is the caller's clock and usually
    includes it. Records should carry the total wall
    alongside (benches record both) so the difference is visible."""
    if result.get("launch_walls") is not None:
        return wall_to_target_launchwise(
            result["best_curve"], result["launch_gens"], result["launch_walls"], target
        )
    return wall_to_target(result["best_curve"], wall_s, target)

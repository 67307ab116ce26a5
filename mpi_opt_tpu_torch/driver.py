"""The search driver, suggest -> evaluate -> report (port of
``mpi_opt_tpu/driver.py``).

The batch size is pulled from the backend (``capacity``), so the
slot-pool backend receives device-shaped batches, and a generational
algorithm (PBT) holds the loop between generations by handing out an
empty batch only once everything it dispatched has been reported.

A batch that dispatches trials is one launch of ``--profile-launches``
(``utils/profiling.launch_tick``, counted as the JAX driver counts it).
Not here: the sweep service's slice hook (the port has no service).
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Optional, Sequence

from mpi_opt_tpu_torch.algorithms.base import Algorithm
from mpi_opt_tpu_torch.backends.base import Backend
from mpi_opt_tpu_torch.health import heartbeat, shutdown
from mpi_opt_tpu_torch.health.shutdown import SweepInterrupted
from mpi_opt_tpu_torch.ledger.store import result_from_record
from mpi_opt_tpu_torch.obs import trace
from mpi_opt_tpu_torch.trial import Trial, TrialResult
from mpi_opt_tpu_torch.utils import profiling
from mpi_opt_tpu_torch.utils.metrics import MetricsLogger, null_logger


@dataclasses.dataclass
class SearchResult:
    best: Optional[Trial]
    n_trials: int
    wall_s: float
    trials_per_sec_per_chip: float
    # evaluations this call ran: >= n_trials for multi-rung algorithms
    # (each ASHA promotion re-enters the backend), the numerator of
    # trials_per_sec_per_chip
    n_evals: int = 0
    # final failure tallies of this call (post-retry)
    n_failed: int = 0
    n_timeout: int = 0
    n_retried: int = 0
    # results served without the backend (journal replay, exact-match
    # cache), disjoint from n_evals
    n_replayed: int = 0
    n_cache_hits: int = 0


@dataclasses.dataclass(frozen=True)
class FailurePolicy:
    """How the driver treats non-ok trial results.

    Retries re-enter ``backend.evaluate`` for just the failed trials, up
    to ``max_retries`` times a trial, sleeping a jittered exponential
    backoff between rounds (attempt k waits ``backoff_s * 2**(k-1)``,
    scaled by up to ``backoff_jitter`` of random extra). Trials still
    failing are reported to the algorithm as FINAL failures.

    ``max_failure_rate`` is the circuit breaker: once
    ``min_evals_for_abort`` evaluations exist and the fraction of final
    failures exceeds it, the sweep raises ``SweepAborted``. 1.0
    disables it.
    """

    max_retries: int = 0
    backoff_s: float = 0.1
    backoff_jitter: float = 0.5
    max_failure_rate: float = 1.0
    min_evals_for_abort: int = 20
    seed: int = 0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if not 0.0 < self.max_failure_rate <= 1.0:
            raise ValueError(f"max_failure_rate must be in (0, 1], got {self.max_failure_rate}")

    def backoff(self, attempt: int, rng: random.Random) -> float:
        """Seconds to sleep before retry ``attempt`` (1-based)."""
        return self.backoff_s * (2 ** (attempt - 1)) * (1.0 + self.backoff_jitter * rng.random())


class SweepAborted(RuntimeError):
    """The failure fraction crossed ``FailurePolicy.max_failure_rate``."""


class _FailureTracker:
    """Retry and abort bookkeeping of one ``run_search`` call."""

    def __init__(self, policy: FailurePolicy, metrics: MetricsLogger):
        self.policy = policy
        self.metrics = metrics
        self.rng = random.Random(policy.seed)
        self.evaluated = 0  # final results seen (ok + failed)
        self.failed = 0  # final non-ok results
        self.timeout = 0
        self.retried = 0

    def evaluate(self, backend: Backend, batch: Sequence[Trial], on_final=None) -> list[TrialResult]:
        """``backend.evaluate`` with retries a trial; returns the FINAL
        results in ``batch`` order. ``on_final(trial, result, attempts)``
        fires once a trial, BEFORE the abort check can raise: the
        ledger's journaling hook, so an aborting batch's evaluations
        are durable."""
        results = backend.evaluate(batch)
        final = {r.trial_id: r for r in results}
        attempts = {t.trial_id: 1 for t in batch}
        if self.policy.max_retries > 0:
            by_id = {t.trial_id: t for t in batch}
            for attempt in range(1, self.policy.max_retries + 1):
                retry = [by_id[tid] for tid, r in final.items() if not r.ok]
                if not retry:
                    break
                delay = self.policy.backoff(attempt, self.rng)
                if delay > 0:
                    time.sleep(delay)
                self.retried += len(retry)
                self.metrics.count_retries(len(retry))
                self.metrics.log("trial_retry", attempt=attempt, of=self.policy.max_retries,
                                 trials=[t.trial_id for t in retry], backoff_s=round(delay, 3))
                for t in retry:
                    attempts[t.trial_id] += 1
                for r in backend.evaluate(retry):
                    final[r.trial_id] = r
        out = [final[t.trial_id] for t in batch]
        if on_final is not None:
            for t, r in zip(batch, out):
                on_final(t, r, attempts[t.trial_id])
        self._account(out)
        return out

    def _account(self, results: Sequence[TrialResult]) -> None:
        self.evaluated += len(results)
        # counted before the abort check can raise, so the summary's
        # failure counters never lack their evaluations
        self.metrics.count_trials(len(results))
        for r in results:
            if r.ok:
                continue
            self.failed += 1
            if r.status == "timeout":
                self.timeout += 1
                self.metrics.count_stalls()
            self.metrics.log("trial_failed", trial_id=r.trial_id, status=r.status, error=r.error,
                             step=r.step, phase=trace.current_phase())
            self.metrics.count_failure(r.status)
        if (self.policy.max_failure_rate < 1.0
                and self.evaluated >= self.policy.min_evals_for_abort
                and self.failed / self.evaluated > self.policy.max_failure_rate):
            msg = (
                f"sweep aborted: {self.failed}/{self.evaluated} trial evaluations failed "
                f"({self.failed / self.evaluated:.0%} > max_failure_rate "
                f"{self.policy.max_failure_rate:.0%}): a systemic failure, not unlucky "
                "hyperparameters"
            )
            self.metrics.log("sweep_aborted", error=msg)
            raise SweepAborted(msg)


def run_search(
    algorithm: Algorithm,
    backend: Backend,
    metrics: Optional[MetricsLogger] = None,
    max_batches: Optional[int] = None,
    checkpointer=None,
    policy: Optional[FailurePolicy] = None,
    ledger=None,
    cache=None,
) -> SearchResult:
    """Drive the suggest -> evaluate -> report loop to completion.

    ``checkpointer`` (``utils.checkpoint.SearchCheckpointer``) snapshots
    the algorithm and backend after ``report_batch`` on its cadence.
    ``policy`` (``FailurePolicy``) governs non-ok results: retries first,
    then the FINAL result is reported, and the circuit breaker raises
    ``SweepAborted``; the default is no retries and no breaker.

    ``ledger`` (``ledger.store.SweepLedger``, header ensured) journals
    every FINAL result durably before it is reported, and REPLAYS the
    journal on a resume: a suggested trial whose id holds a record at
    the trial's budget is served from it (params verified) without
    touching the backend. The JAX package keys the replay by trial id
    alone, so a resumed ASHA there is served a promoted trial's last
    journaled rung for its first rung (its rung-0 score and history
    change); the budget in the key keeps each rung's own result.
    ``cache`` (``ledger.cache.EvalCache``) is the exact-match memo
    consulted before ``backend.evaluate``; with a ledger and no cache,
    one is built from the ledger's ok records. Replay beats cache: the
    cache only ever serves ok results to NEW points.
    """
    metrics = metrics or null_logger()
    tracker = _FailureTracker(policy or FailurePolicy(), metrics)
    # keyed by (trial id, budget): an ASHA trial journals one record a
    # rung under one id, and only the record at the budget asked for is
    # that evaluation's result
    replay: dict[tuple[int, int], dict] = {} if ledger is None else {
        (int(r["trial_id"]), int(r["step"])): r for r in ledger.records}
    if cache is None and ledger is not None:
        from mpi_opt_tpu_torch.ledger.cache import EvalCache

        cache = EvalCache(algorithm.space)
        cache.seed_from(ledger.ok_records())
    if replay:
        metrics.log("ledger_replay", completed=len(replay))

    def on_final(trial: Trial, result: TrialResult, attempts: int) -> None:
        # journal BEFORE report/abort: the record never lags the search
        # state it will be replayed into
        if ledger is not None:
            ledger.record_trial(result, algorithm.space.canonical_params(trial.params),
                                attempts=attempts)
        if cache is not None:
            cache.put(trial.params, result)

    t0 = time.perf_counter()
    batches = 0
    n_run = 0  # trials evaluated by THIS call
    n_replayed = 0
    n_cache_hits = 0
    while not algorithm.finished():
        batch = algorithm.next_batch(backend.capacity)
        if not batch:
            if algorithm.finished():
                break
            raise RuntimeError(
                f"{algorithm.name}: no trials to run but search not finished "
                "(algorithm is waiting on results that were never reported)"
            )
        served: dict[int, TrialResult] = {}
        pending: list[Trial] = []
        for t in batch:
            rec = replay.pop((t.trial_id, t.budget), None)
            if rec is not None:
                _verify_replay(algorithm.space, t, rec, ledger)
                served[t.trial_id] = result_from_record(rec)
                n_replayed += 1
                metrics.count_replayed()
                continue
            if cache is not None:
                hit = cache.get(t.params, t.budget, t.trial_id)
                if hit is not None:
                    served[t.trial_id] = hit
                    n_cache_hits += 1
                    metrics.count_cache_hits()
                    # a hit is a FINAL ok result of this sweep too:
                    # journaled, so a later resume replays it
                    if ledger is not None:
                        ledger.record_trial(hit, algorithm.space.canonical_params(t.params),
                                            attempts=0, cached=True)
                    continue
            pending.append(t)
        if pending:
            profiling.launch_tick()
            # the driver path's launch: backend.evaluate blocks until the
            # batch's scores exist, so the span is the batch's real wall
            # (retries included); journal spans nest inside it
            with trace.span("train", batch=batches + 1, members=len(pending)):
                for r in tracker.evaluate(backend, pending, on_final=on_final):
                    served[r.trial_id] = r
        algorithm.report_batch([served[t.trial_id] for t in batch])
        n_run += len(pending)
        best = algorithm.best()
        metrics.log("batch", algo=algorithm.name, backend=backend.name, size=len(batch),
                    evaluated=len(pending),
                    best_score=None if best is None else round(best.score, 6))
        batches += 1
        saved = False
        if checkpointer is not None:
            saved = checkpointer.maybe_save(batches, algorithm, backend)
        heartbeat.beat(stage="driver", batches=batches, trials=algorithm.n_trials)
        # the batch boundary's slice-hook point, where the coord plane's
        # drain agreement votes under multi-process SPMD; only batches
        # that evaluated something tick it (a replayed batch costs no
        # device time), the same on every rank
        if pending and not algorithm.finished():
            shutdown.poll_slice(f"batch {batches}")
        if shutdown.requested() and not algorithm.finished():
            # the drain point: the batch is done and journaled; force an
            # off-cadence snapshot so --resume loses nothing. A batch that
            # finished the sweep exits normally instead
            if checkpointer is not None and not saved:
                checkpointer.save(batches, algorithm, backend)
            metrics.log("preempt_drain", signal=shutdown.active_signal(), batches=batches,
                        trials=algorithm.n_trials)
            raise SweepInterrupted(shutdown.active_signal(), at=f"batch {batches}")
        if max_batches is not None and batches >= max_batches:
            break
    if replay and algorithm.finished():
        # journal records the resumed algorithm never re-suggested
        metrics.log("ledger_replay_unconsumed", trials=sorted({tid for tid, _ in replay}))
    wall = time.perf_counter() - t0
    return SearchResult(
        best=algorithm.best(),
        n_trials=algorithm.n_trials,
        wall_s=wall,
        trials_per_sec_per_chip=n_run / max(wall, 1e-9) / metrics.n_chips,
        n_evals=n_run,
        n_failed=tracker.failed - tracker.timeout,
        n_timeout=tracker.timeout,
        n_retried=tracker.retried,
        n_replayed=n_replayed,
        n_cache_hits=n_cache_hits,
    )


def _verify_replay(space, trial: Trial, rec: dict, ledger) -> None:
    """A replayed record must describe the point the resumed algorithm
    re-suggested under that id: the algorithms re-derive their streams
    from (seed, reports), so a mismatch means the ledger belongs to
    another configuration than the header could see."""
    if space.params_key(trial.params) != space.params_key(rec["params"]):
        from mpi_opt_tpu_torch.ledger.store import LedgerError

        raise LedgerError(
            f"ledger replay diverged at trial {trial.trial_id}: journal records params "
            f"{rec['params']} but the resumed search suggested "
            f"{space.canonical_params(trial.params)}; the ledger"
            f"{'' if ledger is None else ' ' + ledger.path} was written by a different "
            "suggestion stream: resume with the original configuration or start a fresh ledger"
        )

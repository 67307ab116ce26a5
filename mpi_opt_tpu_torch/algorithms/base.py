"""The host-side algorithm interface, the suggest -> evaluate -> report
contract (port of ``mpi_opt_tpu/algorithms/base.py``).

The driver asks an algorithm for the next batch of trials sized to the
backend's capacity (``next_batch(n)``), evaluates them, and reports the
results (``report_batch``). The decision math of ASHA, PBT and TPE is in
``ops/``; these classes own the bookkeeping.

Random numbers. The JAX package draws through ``fold_in(key(seed), n)``
chains on the host CPU. Here every draw is one of the ``_draw_*``
methods below, each on a fresh CPU ``torch.Generator`` seeded from a
*path* of integers: the seed, then what JAX folds in (``path_generator``).
A path names the same draw in both packages, so the parity tests
replace these methods with ones that make JAX's draws for the path and
hand them to the port's apply functions. A draw never advances a
generator that another draw reads.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from mpi_opt_tpu_torch.space import SearchSpace
from mpi_opt_tpu_torch.trial import Trial, TrialResult, TrialStatus


@dataclasses.dataclass(frozen=True)
class Observation:
    """One prior (point, score) fact offered to an algorithm as warm
    start, not a trial of the current search. ``unit`` is the canonical
    unit-cube row; ``budget`` the step count the score was measured at
    (BOHB files it per budget)."""

    unit: np.ndarray
    score: float
    budget: int = 0
    #: the raw objective vector, when the prior record journaled
    #: multi-objective ``scores``; ``score`` stays the scalarized value
    #: every scalar consumer ranks by
    scores: tuple = None


def best_finite(items, key):
    """The item with the highest FINITE key, else the first item.

    A diverged trial's score (NaN, or +/-inf from an exploded loss)
    never wins: Python's ``max`` never displaces a NaN front-runner and
    +inf would beat every real score. Only an all-diverged item set
    returns a diverged item (the first), so callers still see that
    something ran, with the non-finite key as the flag. None for no
    items."""
    items = list(items)
    finite = [it for it in items if np.isfinite(key(it))]
    if finite:
        return max(finite, key=key)
    return items[0] if items else None


def path_generator(path: Sequence[int], device="cpu") -> torch.Generator:
    """A generator on ``device`` (the CPU by default) seeded from an
    integer path (the seed, then what the JAX package folds into its
    key): one generator a draw."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([int(p) for p in path]).generate_state(1)[0]))
    return gen


class Algorithm(abc.ABC):
    """Base class for search algorithms. Scores: HIGHER IS BETTER."""

    name: str = "base"

    def __init__(self, space: SearchSpace, seed: int = 0, id_base: int = 0):
        self.space = space
        self.seed = seed
        self.trials: dict[int, Trial] = {}
        # id_base partitions the trial-id space when several instances
        # share one search and backend (Hyperband/BOHB brackets): a
        # stateful backend keys its slots on trial_id, so two brackets
        # both starting at 0 would alias each other's trained state
        self._next_id = id_base
        self._requeue: list[int] = []  # in-flight trials recovered from a checkpoint
        self._seed_units: list[np.ndarray] = []  # warm-start points to try first

    # -- core contract ----------------------------------------------------

    @abc.abstractmethod
    def next_batch(self, n: int) -> list[Trial]:
        """Up to ``n`` trials to evaluate next (new or continuing). An
        empty list while ``not finished()`` means "waiting on results"."""

    @abc.abstractmethod
    def report_batch(self, results: Sequence[TrialResult]) -> None:
        """Record completed evaluations and update the search state."""

    @abc.abstractmethod
    def finished(self) -> bool:
        """True when the search has no more work to hand out."""

    # -- draws (replaced by the parity tests; see the module docstring) ---

    def _draw_unit(self, path: Sequence[int], n: int) -> np.ndarray:
        """``float32[n, d]`` uniform rows (JAX: ``space.sample_unit``)."""
        return self.space.sample_unit(path_generator(path), n).numpy()

    def _draw_uniform(self, path: Sequence[int]) -> float:
        """One uniform in [0, 1) (JAX: ``jax.random.uniform(key)``)."""
        return float(torch.rand((), generator=path_generator(path)))

    # -- warm start: the ingestion contract ------------------------------

    def ingest_observations(self, observations: Sequence[Observation]) -> int:
        """Absorb prior-sweep observations before the search starts (at
        most once, before the first ``next_batch``). They are facts about
        THIS space but not trials of this search: they consume no trial
        ids or budget and never appear in ``best()``. Returns how many
        informed the search; the base accepts none."""
        return 0

    def _ingest_seed_points(self, observations: Sequence[Observation], k: int = 1) -> int:
        """Queue the top-``k`` finite-scored prior points to be suggested
        before any fresh sampling; a diverged prior point never seeds."""
        finite = [o for o in observations if np.isfinite(o.score)]
        finite.sort(key=lambda o: o.score, reverse=True)
        self._seed_units = [np.asarray(o.unit, dtype=np.float32) for o in finite[:k]]
        return len(self._seed_units)

    def _next_seed_unit(self) -> Optional[np.ndarray]:
        """Pop the next queued warm-start point (None when drained)."""
        return self._seed_units.pop(0) if self._seed_units else None

    # -- shared bookkeeping ----------------------------------------------

    def _new_trial(self, unit_row: np.ndarray, budget: int = 0) -> Trial:
        t = Trial(
            trial_id=self._next_id,
            params=self.space.materialize_row(np.asarray(unit_row)),
            unit=np.asarray(unit_row, dtype=np.float32),
            budget=budget,
        )
        self._next_id += 1
        self.trials[t.trial_id] = t
        return t

    def _drain_requeue(self, out: list, n: int) -> None:
        """Re-dispatch checkpoint-recovered in-flight trials before any
        new work (their results died with the old process)."""
        while self._requeue and len(out) < n:
            t = self.trials[self._requeue.pop(0)]
            t.status = TrialStatus.RUNNING
            out.append(t)

    def _requeue_running(self) -> None:
        """Recover trials left RUNNING by a checkpoint/restore cycle:
        without this a state captured between ``next_batch`` and
        ``report_batch`` resumes waiting on results that never come."""
        self._requeue = [t.trial_id for t in self.trials.values() if t.status == TrialStatus.RUNNING]

    def _mark_failed(self, r: TrialResult) -> Trial:
        """Flag the trial FAILED with its error; its score is not
        recorded, so ``best()`` never surfaces it."""
        t = self.trials[r.trial_id]
        t.status = TrialStatus.FAILED
        t.error = r.error
        return t

    def best(self) -> Optional[Trial]:
        # a trial whose latest evaluation failed is excluded even when an
        # earlier rung left a finite score behind
        scored = [t for t in self.trials.values()
                  if t.score is not None and t.status != TrialStatus.FAILED]
        return best_finite(scored, key=lambda t: t.score)

    @property
    def n_trials(self) -> int:
        return len(self.trials)

    # -- checkpoint/resume --------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "next_id": self._next_id,
            "seed": self.seed,
            "trials": [
                {
                    "trial_id": t.trial_id,
                    "unit": t.unit.tolist(),
                    "budget": t.budget,
                    "rung": t.rung,
                    "status": t.status.value,
                    "score": t.score,
                    "history": t.history,
                    "error": t.error,
                }
                for t in self.trials.values()
            ],
        }

    def load_state_dict(self, state: dict) -> None:
        self._next_id = state["next_id"]
        self.seed = state["seed"]
        self.trials = {}
        for rec in state["trials"]:
            unit = np.asarray(rec["unit"], dtype=np.float32)
            t = Trial(
                trial_id=rec["trial_id"],
                params=self.space.materialize_row(unit),
                unit=unit,
                budget=rec["budget"],
                rung=rec["rung"],
                status=TrialStatus(rec["status"]),
            )
            t.score = rec["score"]
            t.history = [tuple(h) for h in rec["history"]]
            t.error = rec.get("error")
            self.trials[t.trial_id] = t

"""Random search (port of ``mpi_opt_tpu/algorithms/random_search.py``):
i.i.d. uniform sampling over the space."""

from __future__ import annotations

from typing import Sequence

from mpi_opt_tpu_torch.algorithms.base import Algorithm
from mpi_opt_tpu_torch.space import SearchSpace
from mpi_opt_tpu_torch.trial import TrialResult, TrialStatus


class RandomSearch(Algorithm):
    name = "random"

    def __init__(self, space: SearchSpace, seed: int = 0, max_trials: int = 16, budget: int = 1):
        super().__init__(space, seed)
        self.max_trials = max_trials
        self.budget = budget  # steps per trial, passed to the backend
        self._suggested = 0
        self._done = 0

    def ingest_observations(self, observations):
        # warm start: the prior's best point replaces the first draw; the
        # draw stream is unchanged (its path advances per suggestion)
        return self._ingest_seed_points(observations)

    def next_batch(self, n):
        out = []
        self._drain_requeue(out, n)
        take = min(n - len(out), self.max_trials - self._suggested)
        if take <= 0:
            return out
        unit = self._draw_unit((self.seed, self._suggested), take)
        for i in range(take):
            seed_u = self._next_seed_unit()
            t = self._new_trial(seed_u if seed_u is not None else unit[i], budget=self.budget)
            t.status = TrialStatus.RUNNING
            out.append(t)
        self._suggested += take
        return out

    def report_batch(self, results: Sequence[TrialResult]):
        for r in results:
            if not r.ok:
                # a failed trial still used its suggestion: it counts
                # toward completion, it just never scores
                self._mark_failed(r)
                self._done += 1
                continue
            t = self.trials[r.trial_id]
            t.record(r.score, r.step)
            t.status = TrialStatus.DONE
            self._done += 1

    def finished(self):
        return self._done >= self.max_trials

    def state_dict(self):
        d = super().state_dict()
        d["random"] = {"suggested": self._suggested, "done": self._done}
        return d

    def load_state_dict(self, state):
        super().load_state_dict(state)
        self._suggested = state["random"]["suggested"]
        self._done = state["random"]["done"]
        self._requeue_running()

"""Asynchronous Successive Halving, host-side bookkeeping (port of
``mpi_opt_tpu/algorithms/asha.py``).

Trials start at the lowest rung; a trial that finishes a rung is
promoted to the next if it ranks in the top 1/eta of the scores recorded
at that rung so far, else stopped, without waiting for the rung to
fill. Budgets are cumulative: a promoted trial's ``budget`` is the next
rung's total step count, and a stateful backend resumes it from its
saved state. The synchronous, on-device variant is
``train/fused_asha.py::fused_sha``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from mpi_opt_tpu_torch.algorithms.base import Algorithm
from mpi_opt_tpu_torch.ops.asha import asha_rungs
from mpi_opt_tpu_torch.space import SearchSpace
from mpi_opt_tpu_torch.trial import TrialResult, TrialStatus


class ASHA(Algorithm):
    name = "asha"

    def __init__(
        self,
        space: SearchSpace,
        seed: int = 0,
        max_trials: int = 64,
        min_budget: int = 1,
        max_budget: int = 27,
        eta: int = 3,
        id_base: int = 0,
    ):
        super().__init__(space, seed, id_base=id_base)
        self.max_trials = max_trials
        self.eta = eta
        self.rungs = asha_rungs(min_budget, max_budget, eta)
        # scores recorded per rung: rung index -> {trial_id: score}
        self.rung_scores: list[dict[int, float]] = [dict() for _ in self.rungs]
        self._suggested = 0
        self._promotable: list[int] = []  # trial ids awaiting their next rung
        self._outstanding: set[int] = set()

    # -- contract ---------------------------------------------------------

    def next_batch(self, n):
        out = []
        # trials whose results died with a restored process go first
        self._drain_requeue(out, n)
        # then continuing trials: they free slots sooner and drive the
        # search deeper
        while self._promotable and len(out) < n:
            t = self.trials[self._promotable.pop(0)]
            t.status = TrialStatus.RUNNING
            out.append(t)
        while len(out) < n and self._suggested < self.max_trials:
            # warm-start points take the first fresh slots, as ordinary
            # lowest-rung trials that must earn their promotions
            seed_u = self._next_seed_unit()
            unit = seed_u if seed_u is not None else self._sample_fresh((self.seed, self._suggested))
            t = self._new_trial(unit, budget=self.rungs[0])
            t.status = TrialStatus.RUNNING
            out.append(t)
            self._suggested += 1
        self._outstanding.update(t.trial_id for t in out)
        return out

    def report_batch(self, results: Sequence[TrialResult]):
        for r in results:
            if not r.ok:
                # the failed trial leaves the rung race: out of
                # _outstanding (so finished() can close), never in
                # rung_scores (a NaN compares false against everything and
                # would always look top-k), never promotable
                self._outstanding.discard(r.trial_id)
                self._mark_failed(r)
                continue
            t = self.trials[r.trial_id]
            self._outstanding.discard(r.trial_id)
            t.record(r.score, r.step)
            rung = t.rung
            self.rung_scores[rung][t.trial_id] = float(r.score)
            if rung == len(self.rungs) - 1:
                t.status = TrialStatus.DONE
                continue
            if self._promotes(rung, r.score):
                t.rung = rung + 1
                t.budget = self.rungs[t.rung]
                t.status = TrialStatus.PAUSED
                self._promotable.append(t.trial_id)
            else:
                t.status = TrialStatus.STOPPED

    def finished(self):
        no_new = self._suggested >= self.max_trials
        return no_new and not self._promotable and not self._outstanding and not self._requeue

    def ingest_observations(self, observations):
        # the prior's best point joins the first cohort at the lowest rung
        return self._ingest_seed_points(observations)

    # -- fresh-trial sampling (BOHB swaps in a model) ---------------------

    def _sample_fresh(self, path) -> np.ndarray:
        """Unit-cube row for a brand-new trial, from the draw at
        ``path`` (the bracket's seed, the suggestion count). ASHA samples
        uniformly; BOHB overrides this one point."""
        return self._draw_unit(path, 1)[0]

    # -- promotion rule ---------------------------------------------------

    def _promotes(self, rung: int, score: float) -> bool:
        """Async rule: in the top 1/eta of the scores recorded at this rung."""
        scores = np.array(list(self.rung_scores[rung].values()))
        k = max(1, int(np.ceil(len(scores) / self.eta)))
        # fewer than k strictly better scores => within the top k
        return int((scores > score).sum()) < k

    # -- checkpoint -------------------------------------------------------

    def state_dict(self):
        d = super().state_dict()
        d["asha"] = {
            "suggested": self._suggested,
            "promotable": list(self._promotable),
            "rung_scores": [dict(r) for r in self.rung_scores],
        }
        return d

    def load_state_dict(self, state):
        super().load_state_dict(state)
        a = state["asha"]
        self._suggested = a["suggested"]
        self._promotable = list(a["promotable"])
        self.rung_scores = [{int(k): v for k, v in r.items()} for r in a["rung_scores"]]
        self._outstanding = set()
        # in-flight trials lost their results with the old process
        self._requeue_running()

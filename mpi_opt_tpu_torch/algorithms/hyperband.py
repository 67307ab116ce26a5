"""Hyperband (port of ``mpi_opt_tpu/algorithms/hyperband.py``; Li et al.
2018): ``s_max + 1`` brackets of successive halving that trade the
number of configurations against the starting budget. Bracket s starts
``ceil((s_max+1)/(s+1) * eta^s)`` trials at budget ``R * eta^-s``; with
R=81, eta=3 that is the paper's Table 1: (81@1, 34@3, 15@9, 8@27, 5@81).
The host algorithm runs each bracket as an ``ASHA``; the fused sweep is
``train.fused_asha.fused_hyperband``."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from mpi_opt_tpu_torch.algorithms.asha import ASHA
from mpi_opt_tpu_torch.algorithms.base import Algorithm, best_finite
from mpi_opt_tpu_torch.space import SearchSpace
from mpi_opt_tpu_torch.trial import TrialResult


def bracket_plan(max_budget: int, eta: int) -> list[tuple[int, int]]:
    """[(n_trials, start_budget)] per bracket, most-exploratory first."""
    # s_max = floor(log_eta(R)) by integer division: a float log loses a
    # whole bracket when R is an exact power of eta (log3(243) computes
    # as 4.999...)
    s_max, b = 0, max_budget
    while b >= eta:
        b //= eta
        s_max += 1
    plan = []
    for s in range(s_max, -1, -1):
        n = int(np.ceil((s_max + 1) / (s + 1) * eta**s))
        r = max(1, round(max_budget / eta**s))
        plan.append((n, r))
    return plan


class Hyperband(Algorithm):
    """Brackets of successive halving, run one after another; each
    bracket IS an ``ASHA`` (the same promotion rule, requeue and
    checkpoint), so the halving logic has one source."""

    name = "hyperband"

    def __init__(self, space: SearchSpace, seed: int = 0, max_budget: int = 81, eta: int = 3):
        super().__init__(space, seed)
        self.eta = eta
        self.max_budget = max_budget
        self.brackets = [self._make_bracket(b, n, r)
                         for b, (n, r) in enumerate(bracket_plan(max_budget, eta))]
        self._cur = 0

    def _make_bracket(self, b: int, n: int, r: int) -> ASHA:
        """The per-bracket scheme for every subclass: seeds decorrelated
        per bracket, and ``id_base`` partitions the trial ids so brackets
        sharing one stateful backend never alias each other's slots.
        Subclasses override ``_bracket`` (the construction point)."""
        return self._bracket(
            seed=self.seed + 7919 * b,
            max_trials=n,
            min_budget=r,
            max_budget=self.max_budget,
            eta=self.eta,
            id_base=b * 1_000_000,
        )

    def _bracket(self, **kw) -> ASHA:
        return ASHA(self.space, **kw)

    # -- contract ---------------------------------------------------------

    def _current(self) -> ASHA | None:
        while self._cur < len(self.brackets) and self.brackets[self._cur].finished():
            self._cur += 1
        return self.brackets[self._cur] if self._cur < len(self.brackets) else None

    def next_batch(self, n):
        b = self._current()
        return [] if b is None else b.next_batch(n)

    def report_batch(self, results: Sequence[TrialResult]):
        # brackets run one after another: outstanding results belong to
        # the current bracket
        self.brackets[self._cur].report_batch(results)

    def finished(self):
        return self._current() is None

    # -- aggregation across brackets --------------------------------------

    def best(self):
        bests = [b.best() for b in self.brackets]
        return best_finite([t for t in bests if t is not None], key=lambda t: t.score)

    @property
    def n_trials(self) -> int:
        return sum(b.n_trials for b in self.brackets)

    # -- checkpoint -------------------------------------------------------

    def state_dict(self):
        return {
            "hyperband": {
                "cur": self._cur,
                "max_budget": self.max_budget,
                "eta": self.eta,
                "brackets": [b.state_dict() for b in self.brackets],
            }
        }

    def load_state_dict(self, state):
        h = state["hyperband"]
        if h["max_budget"] != self.max_budget or h["eta"] != self.eta:
            raise ValueError(
                f"checkpoint is for hyperband(R={h['max_budget']}, eta={h['eta']}), "
                f"not (R={self.max_budget}, eta={self.eta})"
            )
        self._cur = h["cur"]
        for b, s in zip(self.brackets, h["brackets"]):
            b.load_state_dict(s)

"""BOHB's model bookkeeping (port of the jax-free part of
``mpi_opt_tpu/algorithms/bohb.py``): the model-fit gate
``default_n_min`` and ``ObsStore``, the per-budget ring buffers of
(unit, score) observations with the highest-qualified-budget rule.
Fused BOHB (``train/fused_bohb.py``) feeds every rung's scores in and
fits its TPE model on the ring ``model_budget`` names. The host BOHB
algorithm is not ported yet, nor the store's JSON (de)serialisation for
its checkpoints.
"""

from __future__ import annotations

import numpy as np


def default_n_min(dim: int) -> int:
    """The paper's model-fit gate (Falkner et al. 2018 §3.1): N_min =
    d+1, and a KDE is fit once N_min + 2 = d + 3 observations exist at
    a budget (both the good and bad KDEs need points). Single-sourced:
    the host algorithm and the fused sweep both call this, so the
    qualification rule cannot drift between them."""
    return dim + 3


class ObsStore:
    """Per-budget ring buffers of (unit, score) observations plus the
    highest-qualified-budget rule — BOHB's model bookkeeping, shared by
    the host algorithm and the fused sweeps so the qualification and
    ring-wrap arithmetic cannot drift between them."""

    def __init__(self, dim: int, buffer_size: int, n_min: int):
        self.dim = dim
        self.buffer_size = buffer_size
        self.n_min = n_min
        self.budgets: dict[int, dict] = {}

    def ring(self, budget: int) -> dict:
        if budget not in self.budgets:
            self.budgets[budget] = {
                "unit": np.zeros((self.buffer_size, self.dim), np.float32),
                "score": np.zeros(self.buffer_size, np.float32),
                "valid": np.zeros(self.buffer_size, bool),
                "n": 0,
            }
        return self.budgets[budget]

    def add(self, budget: int, unit: np.ndarray, score: float) -> None:
        # Non-finite scores (diverged trials: NaN, or +/-inf from an
        # exploded loss) never enter the model: they would count toward
        # n_min qualification and poison the KDE moments/bandwidths.
        # Filtered HERE so the host and fused paths cannot disagree.
        if not np.isfinite(score):
            return
        s = self.ring(int(budget))
        slot = s["n"] % self.buffer_size
        s["unit"][slot] = unit
        s["score"][slot] = score
        s["valid"][slot] = True
        s["n"] += 1

    def model_budget(self):
        """Highest budget whose live observation count reaches n_min."""
        good = [
            b
            for b, s in self.budgets.items()
            if min(s["n"], self.buffer_size) >= self.n_min
        ]
        return max(good) if good else None

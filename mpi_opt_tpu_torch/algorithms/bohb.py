"""BOHB (port of ``mpi_opt_tpu/algorithms/bohb.py``): the model-fit gate
``default_n_min``, ``ObsStore`` (per-budget ring buffers of (unit,
score) observations with the highest-qualified-budget rule) and the
host algorithm ``BOHB``. Fused BOHB (``train/fused_bohb.py``) feeds
every rung's scores into an ``ObsStore`` too and fits its TPE model on
the ring ``model_budget`` names.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from mpi_opt_tpu_torch.algorithms.asha import ASHA
from mpi_opt_tpu_torch.algorithms.hyperband import Hyperband
from mpi_opt_tpu_torch.algorithms.tpe import TPE, suggest_from_ring
from mpi_opt_tpu_torch.device import resolve_device
from mpi_opt_tpu_torch.ops.tpe import TPEConfig
from mpi_opt_tpu_torch.space import SearchSpace
from mpi_opt_tpu_torch.trial import TrialResult


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

    # -- (de)serialisation for algorithm checkpoints ----------------------

    def to_jsonable(self) -> dict:
        return {
            str(b): {
                "unit": s["unit"].tolist(),
                "score": s["score"].tolist(),
                "valid": s["valid"].tolist(),
                "n": s["n"],
            }
            for b, s in self.budgets.items()
        }

    def load_jsonable(self, d: dict) -> None:
        self.budgets = {
            int(k): {
                "unit": np.asarray(s["unit"], np.float32),
                "score": np.asarray(s["score"], np.float32),
                "valid": np.asarray(s["valid"], bool),
                "n": int(s["n"]),
            }
            for k, s in d.items()
        }


class _ModelBracket(ASHA):
    """An ASHA bracket whose fresh trials come from the owning BOHB's
    model (uniform until a budget qualifies, and for the random
    fraction)."""

    def __init__(self, owner: "BOHB", **kw):
        super().__init__(owner.space, **kw)
        self._owner = owner

    def _sample_fresh(self, path) -> np.ndarray:
        return self._owner._model_sample(path)


class BOHB(Hyperband):
    """Model-based Hyperband (Falkner, Klein & Hutter, 2018): Hyperband's
    brackets decide when to stop trials, a TPE model fit on the highest
    budget with ``n_min`` observations decides where to sample new ones;
    a ``random_fraction`` of fresh trials stays uniform. The brackets
    are ASHA with only ``_sample_fresh`` overridden, and the surrogate is
    ``ops/tpe.py``'s acquisition, on ``device``."""

    name = "bohb"

    def __init__(
        self,
        space: SearchSpace,
        seed: int = 0,
        max_budget: int = 81,
        eta: int = 3,
        random_fraction: float = 1 / 3,
        n_min: int | None = None,
        buffer_size: int = 512,
        config: TPEConfig = TPEConfig(),
        device=None,
    ):
        # the model state exists before Hyperband.__init__ builds the
        # brackets (their construction calls back into _bracket)
        self.random_fraction = random_fraction
        self.config = config
        self.buffer_size = buffer_size
        self.device = resolve_device(device)
        self.n_min = n_min if n_min is not None else default_n_min(space.dim)
        self.obs = ObsStore(space.dim, buffer_size, self.n_min)
        self._samples = 0  # the draw counter of model/uniform samples
        super().__init__(space, seed=seed, max_budget=max_budget, eta=eta)

    def _bracket(self, **kw) -> ASHA:
        return _ModelBracket(self, **kw)

    _draw_tpe = TPE._draw_tpe  # one acquisition's draws, as TPE's

    # -- warm start --------------------------------------------------------

    def ingest_observations(self, observations):
        """Prior observations file into the per-budget stores at their
        recorded budgets (non-finite ones dropped): a budget that reaches
        ``n_min`` priors puts the model in charge from bracket 0."""
        n = 0
        for o in observations:
            if not np.isfinite(o.score):
                continue
            self.obs.add(int(o.budget), np.asarray(o.unit, np.float32), float(o.score))
            n += 1
        return n

    # -- model ------------------------------------------------------------

    def _model_sample(self, path) -> np.ndarray:
        """One fresh row for the bracket draw at ``path``. The JAX package
        folds the sample count into the bracket's key and splits it in
        two; here the two halves are the paths ending 0 (the model-or-
        uniform choice) and 1 (the draw)."""
        self._samples += 1
        path = (*path, self._samples)
        budget = self.obs.model_budget()
        if budget is None or self._draw_uniform((*path, 0)) < self.random_fraction:
            return self._draw_unit((*path, 1), 1)[0]
        s = self.obs.budgets[budget]
        draws = self._draw_tpe((*path, 1), self.buffer_size, self.space.dim)
        return suggest_from_ring(draws, (s["unit"], s["score"], s["valid"]), 1,
                                 self.config, self.device)[0]

    # -- result flow -------------------------------------------------------

    def report_batch(self, results: Sequence[TrialResult]):
        # the per-budget stores take the results BEFORE the bracket's
        # halving rule; r.step is the cumulative budget the trial reached
        bracket = self.brackets[self._cur]
        for r in results:
            t = bracket.trials[r.trial_id]
            self.obs.add(int(r.step), t.unit, float(r.score))
        super().report_batch(results)

    # -- checkpoint -------------------------------------------------------

    def state_dict(self):
        d = super().state_dict()
        d["bohb"] = {
            "samples": self._samples,
            "buffer_size": self.buffer_size,
            "n_min": self.n_min,
            "obs": self.obs.to_jsonable(),
        }
        return d

    def load_state_dict(self, state):
        # a plain hyperband checkpoint has no model state
        if "bohb" not in state:
            raise ValueError("checkpoint is for hyperband, not bohb")
        b = state["bohb"]
        # checked before any mutation: ring arithmetic (n % buffer_size)
        # corrupts under another buffer size, and n_min changes when the
        # model engages
        saved = int(b.get("buffer_size", self.buffer_size))
        if saved != self.buffer_size:
            raise ValueError(f"checkpoint is for bohb(buffer_size={saved}), "
                             f"not buffer_size={self.buffer_size}")
        saved_n_min = int(b.get("n_min", self.n_min))
        if saved_n_min != self.n_min:
            raise ValueError(f"checkpoint is for bohb(n_min={saved_n_min}), not n_min={self.n_min}")
        super().load_state_dict(state)
        self._samples = int(b["samples"])
        self.obs.load_jsonable(b["obs"])

"""The exact-match params -> result memo over ledger history (port of
``EvalCache`` in ``mpi_opt_tpu/ledger/cache.py``).

An evaluation whose params match a journaled ok record to the canonical
byte, at the same budget, is the same deterministic computation: skip it
and serve the recorded result. Only ``ok`` results are cached: a failure
may be transient, and serving it would make one unlucky evaluation
permanent for those params.

``CorpusCache`` (port of the JAX class of the same name) keeps the exact
hit of ``EvalCache`` to the byte and adds a second, separate lookup for
near matches: the same params at another budget, or a fuzzy-matched
record from a ledger of another space. A near match is low-fidelity
evidence (``extra={"fidelity": "prior"}``), never a substitute result.
"""

from __future__ import annotations

from typing import Optional, Sequence

from mpi_opt_tpu_torch.space import SearchSpace
from mpi_opt_tpu_torch.trial import TrialResult


class EvalCache:
    """(canonical params key, budget) -> (score, step, wall_s). The budget
    is part of the key: the same params run to step 10 and to step 270
    are different computations."""

    def __init__(self, space: SearchSpace):
        self.space = space
        self._memo: dict[tuple[str, int], dict] = {}
        self.hits = 0

    def _key(self, params: dict, budget: int) -> tuple[str, int]:
        return (self.space.params_key(params), int(budget))

    def seed_from(self, records: Sequence[dict]) -> int:
        """Load ok trial records (ledger JSON shape); returns the count."""
        n = 0
        for rec in records:
            if rec.get("status") != "ok" or rec.get("score") is None:
                continue
            self._memo[self._key(rec["params"], rec["step"])] = {
                "score": float(rec["score"]),
                "step": int(rec["step"]),
                "wall_s": float(rec.get("wall_s") or 0.0),
            }
            n += 1
        return n

    def put(self, params: dict, result: TrialResult) -> None:
        if not result.ok:
            return  # never cache a non-ok result
        self._memo[self._key(params, result.step)] = {
            "score": float(result.score),
            "step": int(result.step),
            "wall_s": float(result.wall_time),
        }

    def get(self, params: dict, budget: int, trial_id: int) -> Optional[TrialResult]:
        """A hit, rebuilt as an ok result under the asking trial's id."""
        found = self._memo.get(self._key(params, budget))
        if found is None:
            return None
        self.hits += 1
        return TrialResult(
            trial_id=trial_id,
            score=found["score"],
            step=found["step"],
            wall_time=0.0,  # the recorded wall was paid by the original
            extra={"cache_hit": True, "cached_wall_s": found["wall_s"]},
        )

    def __len__(self) -> int:
        return len(self._memo)


class CorpusCache(EvalCache):
    """EvalCache plus a near-match prior view over corpus history.

    Two stores, two truths: the inherited exact memo answers "this
    exact computation already ran" (``get``, unchanged to the byte);
    the prior store answers "this POINT has been seen at some budget"
    (``get_prior``) — same-space/different-budget records, and
    fuzzy-matched records another space's ledger contributed, keyed by
    canonical params alone. A prior is evidence, not a result: it
    carries ``extra={"fidelity": "prior"}`` and the budget it was
    actually measured at, and callers (the suggestion service's
    ``lookup`` op, acquisition warm starts) must treat it as a
    low-fidelity hint, never journal it as this sweep's evaluation.
    Highest-budget evidence wins when one point was seen at several
    budgets — the closest thing the corpus holds to the truth.
    """

    def __init__(self, space: SearchSpace):
        super().__init__(space)
        self._prior: dict[str, dict] = {}
        self.prior_hits = 0

    def seed_prior(self, records: Sequence[dict], fuzzy: bool = False) -> int:
        """Load ok records as near-match evidence; returns count added.

        ``fuzzy=True`` marks records contributed by a different-hash
        (fingerprint-matched) ledger — they never displace same-space
        evidence for the same point, and the served extra says which
        kind of prior the caller is leaning on."""
        n = 0
        for rec in records:
            if rec.get("status") != "ok" or rec.get("score") is None:
                continue
            try:
                key = self.space.params_key(rec["params"])
            except KeyError:
                continue  # fuzzy record missing a live dim: not evidence here
            cur = self._prior.get(key)
            if cur is not None and (
                (cur["fuzzy"] is False and fuzzy)
                or (cur["fuzzy"] == fuzzy and cur["step"] >= int(rec["step"]))
            ):
                continue
            self._prior[key] = {
                "score": float(rec["score"]),
                "step": int(rec["step"]),
                "fuzzy": bool(fuzzy),
            }
            n += 1
        return n

    def get_prior(self, params: dict, trial_id: int) -> Optional[TrialResult]:
        """Near-match evidence for ``params`` at ANY budget, or None.

        The result is deliberately NOT ok-shaped-for-substitution: the
        score/step are the prior evaluation's, ``extra`` declares the
        fidelity, and the caller decides what a low-fidelity fact is
        worth. Exact hits are the exclusive business of ``get``."""
        try:
            found = self._prior.get(self.space.params_key(params))
        except KeyError:
            return None
        if found is None:
            return None
        self.prior_hits += 1
        return TrialResult(
            trial_id=trial_id,
            score=found["score"],
            step=found["step"],
            wall_time=0.0,
            extra={
                "fidelity": "prior",
                "prior_kind": "fuzzy" if found["fuzzy"] else "budget",
            },
        )

    def put(self, params: dict, result: TrialResult) -> None:
        super().put(params, result)
        if result.ok:
            # a live ok result is same-space evidence for the prior
            # view too (newer and never fuzzy, so it wins per the
            # seed_prior rule applied directly)
            key = self.space.params_key(params)
            cur = self._prior.get(key)
            if cur is None or cur["fuzzy"] or cur["step"] <= int(result.step):
                self._prior[key] = {
                    "score": float(result.score),
                    "step": int(result.step),
                    "fuzzy": False,
                }

    @property
    def n_prior(self) -> int:
        return len(self._prior)

"""The exact-match params -> result memo over ledger history (port of
``EvalCache`` in ``mpi_opt_tpu/ledger/cache.py``).

An evaluation whose params match a journaled ok record to the canonical
byte, at the same budget, is the same deterministic computation: skip it
and serve the recorded result. Only ``ok`` results are cached: a failure
may be transient, and serving it would make one unlucky evaluation
permanent for those params. The corpus-backed ``CorpusCache`` comes with
the suggestion service, the next slice of the port (ROADMAP.md, Queue 1);
``corpus/``'s index and resolution are ported already.
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

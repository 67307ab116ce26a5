"""Trial bookkeeping (port of ``mpi_opt_tpu/trial.py``, which imports
no JAX; copied so that the port imports nothing of the JAX package).

A Trial is a host-side record; in a fused sweep a whole population of
trials lives on the device as one unit-cube matrix and these records
are only the host-visible ledger.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Optional

import numpy as np


class TrialStatus(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    PAUSED = "paused"  # ASHA: waiting at a rung for promotion decision
    STOPPED = "stopped"  # early-stopped (ASHA cut / PBT replaced)
    DONE = "done"
    FAILED = "failed"  # evaluation raised/hung/diverged; never a best() pick


@dataclasses.dataclass
class Trial:
    trial_id: int
    params: dict[str, Any]  # typed values (host view)
    unit: np.ndarray  # unit-cube row, the canonical representation
    budget: int = 0  # steps/epochs granted so far (ASHA rung budget)
    rung: int = 0  # current ASHA rung
    status: TrialStatus = TrialStatus.PENDING
    score: Optional[float] = None  # best/latest objective value
    history: list = dataclasses.field(default_factory=list)
    created_at: float = dataclasses.field(default_factory=time.time)
    error: Optional[str] = None  # last failure message (status FAILED)

    def record(self, score: float, step: int) -> None:
        self.score = float(score)
        self.history.append((int(step), float(score)))


@dataclasses.dataclass
class TrialResult:
    """One evaluation outcome.

    ``status`` is the per-trial failure contract shared by every
    backend: ``"ok"`` (score is meaningful), ``"failed"`` (evaluation
    raised, or the score came back non-finite), or ``"timeout"`` (the
    evaluation exceeded the backend's per-trial deadline and was
    reaped). Non-ok results carry a NaN/non-finite ``score`` plus a
    human-readable ``error``, so every existing isfinite gate
    (``best_finite``, BOHB's ObsStore) also holds without consulting
    ``status``.
    """

    trial_id: int
    score: float
    step: int
    wall_time: float = 0.0
    extra: dict = dataclasses.field(default_factory=dict)
    status: str = "ok"  # "ok" | "failed" | "timeout"
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"


def failed_result(
    trial_id: int,
    step: int,
    error: str,
    status: str = "failed",
    score: float = float("nan"),
    wall_time: float = 0.0,
) -> TrialResult:
    """The one construction point for non-ok results, so every backend
    reports failures with the same shape (NaN-family score + status +
    error) and the driver/algorithm handling cannot drift per backend."""
    if status not in ("failed", "timeout"):
        raise ValueError(f"failure status must be failed|timeout, got {status!r}")
    # a non-finite score (the diverged value itself) is kept as the flag;
    # a finite one is forced to NaN so no failed result can ever win an
    # isfinite-gated comparison
    score = float(score)
    if np.isfinite(score):
        score = float("nan")
    return TrialResult(
        trial_id=trial_id,
        score=score,
        step=step,
        wall_time=wall_time,
        status=status,
        error=str(error)[:500],
    )

"""Pieces shared by the fused sweeps (port of parts of ``mpi_opt_tpu/train/common.py``)."""

from __future__ import annotations

import numpy as np


def finite_winner(scores, ok=None):
    """(best_i, diverged) for a host score vector: the argmax over finite
    (and ``ok``-masked) entries. An all-diverged set returns (0, True)."""
    scores = np.asarray(scores)
    mask = np.isfinite(scores) if ok is None else (np.asarray(ok) & np.isfinite(scores))
    diverged = not bool(mask.any())
    best_i = 0 if diverged else int(np.where(mask, scores, -np.inf).argmax())
    return best_i, diverged


def hparams_fn(space, workload):
    """unit matrix [P, d] -> the workload's ``OptHParams``."""
    return lambda unit: workload.make_hparams(space.from_unit(unit))

"""Hyperband's bracket plan (port of ``bracket_plan`` in
``mpi_opt_tpu/algorithms/hyperband.py``; Li et al. 2018): ``s_max + 1``
brackets of successive halving that trade the number of configurations
against the starting budget. Bracket s starts
``ceil((s_max+1)/(s+1) * eta^s)`` trials at budget ``R * eta^-s``; with
R=81, eta=3 that is the paper's Table 1: (81@1, 34@3, 15@9, 8@27, 5@81).
The fused sweep is ``train.fused_asha.fused_hyperband``."""

from __future__ import annotations

import numpy as np


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

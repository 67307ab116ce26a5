"""ASHA's rung reduction (port of ``mpi_opt_tpu/ops/asha.py``).

The synchronous variant: the whole rung cohort is one population axis,
so a rung's cut is one stable descending rank on the device;
``asha_cut_mo`` ranks a multi-objective cohort by its Pareto score.
"""

from __future__ import annotations

import torch

from mpi_opt_tpu_torch.objectives.pareto import pareto_score
from mpi_opt_tpu_torch.ops.common import rank_descending


def asha_rungs(min_budget: int, max_budget: int, eta: int) -> list[int]:
    """Budget ladder [min_budget, min_budget*eta, ...] up to max_budget."""
    if min_budget < 1 or eta < 2 or max_budget < min_budget:
        raise ValueError("need min_budget>=1, eta>=2, max_budget>=min_budget")
    rungs = []
    b = min_budget
    while b < max_budget:
        rungs.append(b)
        b *= eta
    rungs.append(max_budget)
    return rungs


def asha_cut(scores: torch.Tensor, eta: int, valid: torch.Tensor | None = None):
    """Select the top ceil(n_valid/eta) of a rung cohort.

    ``scores`` float32[n], higher is better; ``valid`` optional bool[n]
    (invalid members never promote). Ties keep the lower index first and
    NaNs rank last (``rank_descending``). Returns (promote bool[n],
    order int64[n]): ``order`` sorts the scores descending.
    """
    if valid is None:
        valid = torch.ones(scores.shape[0], dtype=torch.bool, device=scores.device)
    rank, order = rank_descending(scores, valid)
    k = torch.ceil(valid.sum() / eta).to(torch.int64)
    return (rank < k) & valid, order


def asha_cut_mo(norm_scores: torch.Tensor, eta: int, valid: torch.Tensor | None = None,
                norm_bounds=None):
    """Multi-objective rung cut: promote by Pareto rank, not a scalar.

    The cohort's maximize-form ``[n, m]`` matrix is ranked by
    ``objectives.pareto.pareto_score`` (front, then crowding, infeasible
    members below by violation) and ``asha_cut``'s top
    ``ceil(n_valid/eta)`` rule applies to that effective score. Returns
    (promote bool[n], order int64[n], eff f32[n]).
    """
    eff = pareto_score(norm_scores, valid=valid, norm_bounds=norm_bounds)
    promote, order = asha_cut(eff, eta, valid)
    return promote, order, eff

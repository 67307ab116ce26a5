"""Multi-objective and constrained search (port of ``mpi_opt_tpu/objectives``).

- ``spec``: ``ObjectiveSpec``, named objectives with directions and
  optional constraint bounds, parsed from the CLI (``--objectives
  "accuracy:max,params:min<=2e4"``) and carried in the ledger header
  and the snapshot config.
- ``pareto``: the non-dominated sort on the device (``pareto_rank``,
  ``crowding_distance``, ``pareto_score``) that the fused boundary ops
  rank by, and the host-side front, ``hypervolume`` and ``select_best``
  helpers the results report.

Every selection site reduces to one rule: ``pareto_score`` folds
feasibility, Pareto rank and crowding into one effective scalar whose
descending order is the multi-objective preference order, so PBT's
truncation exploit and SHA's rung cut rank it as they rank a score.
"""

from mpi_opt_tpu_torch.objectives.pareto import (
    crowding_distance,
    hypervolume,
    pareto_front_mask,
    pareto_rank,
    pareto_score,
    select_best,
)
from mpi_opt_tpu_torch.objectives.spec import Objective, ObjectiveSpec, parse_constraint

__all__ = [
    "Objective",
    "ObjectiveSpec",
    "parse_constraint",
    "pareto_rank",
    "crowding_distance",
    "pareto_score",
    "pareto_front_mask",
    "hypervolume",
    "select_best",
]

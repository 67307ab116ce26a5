"""Search algorithms of the port (``mpi_opt_tpu/algorithms/``): the host
algorithms the driver runs (``driver.py::run_search``), selected by name,
and the pieces the fused sweeps share (Hyperband's bracket plan, the
best-pick rule, BOHB's observation store)."""

from mpi_opt_tpu_torch.algorithms.asha import ASHA
from mpi_opt_tpu_torch.algorithms.base import Algorithm, Observation
from mpi_opt_tpu_torch.algorithms.bohb import BOHB
from mpi_opt_tpu_torch.algorithms.hyperband import Hyperband
from mpi_opt_tpu_torch.algorithms.pbt import PBT
from mpi_opt_tpu_torch.algorithms.random_search import RandomSearch
from mpi_opt_tpu_torch.algorithms.tpe import TPE

ALGORITHMS: dict[str, type[Algorithm]] = {
    RandomSearch.name: RandomSearch,
    ASHA.name: ASHA,
    PBT.name: PBT,
    TPE.name: TPE,
    Hyperband.name: Hyperband,
    BOHB.name: BOHB,
}


def get_algorithm(name: str) -> type[Algorithm]:
    try:
        return ALGORITHMS[name]
    except KeyError:
        raise ValueError(f"unknown algorithm {name!r}; available: {sorted(ALGORITHMS)}") from None


__all__ = ["Algorithm", "Observation", "RandomSearch", "ASHA", "Hyperband", "BOHB", "PBT", "TPE",
           "ALGORITHMS", "get_algorithm"]

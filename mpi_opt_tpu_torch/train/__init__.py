"""Population training and the fused sweeps of the port."""

from mpi_opt_tpu_torch.train.population import OptHParams, PopState, PopulationTrainer

__all__ = ["OptHParams", "PopState", "PopulationTrainer"]

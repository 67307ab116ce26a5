"""The port's dataset registry, byte-equal to the JAX package's: the
synthetic image sets and the tabular sets read from ``data/uci/``."""

from mpi_opt_tpu_torch.data.loaders import DATASETS, load_dataset

__all__ = ["load_dataset", "DATASETS"]

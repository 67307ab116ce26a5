"""Synthetic stand-ins for the image sets, byte-equal to the JAX package's."""

from mpi_opt_tpu_torch.data.loaders import DATASETS, load_dataset

__all__ = ["load_dataset", "DATASETS"]

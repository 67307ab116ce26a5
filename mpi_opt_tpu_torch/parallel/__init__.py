"""Multi-process SPMD: the ``('pop', 'data')`` mesh on
``torch.distributed`` and the boundary-agreement control plane (port of
``mpi_opt_tpu/parallel/``)."""

from mpi_opt_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    initialize_multihost,
    make_mesh,
)

__all__ = ["Mesh", "make_mesh", "initialize_multihost"]

"""Backend registry of the port, the ``backend=`` plugin hook: ``gpu``,
the device-resident slot pool (``backends/gpu.py``), and ``cpu``, a
process pool over per-trial workloads on the host (``backends/cpu.py``)."""

from mpi_opt_tpu_torch.backends import cpu, gpu  # noqa: F401  (registers)
from mpi_opt_tpu_torch.backends.base import (
    Backend,
    available_backends,
    get_backend,
    register_backend,
)

__all__ = ["Backend", "get_backend", "register_backend", "available_backends"]

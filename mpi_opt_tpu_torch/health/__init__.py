"""Process health: graceful shutdown, progress heartbeats and the
supervisor's stall watchdog (port of ``mpi_opt_tpu/health/``)."""

from mpi_opt_tpu_torch.health.heartbeat import (  # noqa: F401
    Heartbeat,
    beat,
    configure,
    deconfigure,
    read_beat,
)
from mpi_opt_tpu_torch.health.shutdown import (  # noqa: F401
    EX_TEMPFAIL,
    ShutdownGuard,
    SweepInterrupted,
)
from mpi_opt_tpu_torch.health.watchdog import StallDetector  # noqa: F401

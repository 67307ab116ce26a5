"""Process health: graceful shutdown and progress heartbeats (port of
``mpi_opt_tpu/health/``; the stall watchdog is not ported yet)."""

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

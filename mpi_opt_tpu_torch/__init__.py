"""mpi_opt_tpu_torch: the PyTorch/CUDA port of mpi_opt_tpu.

Fused PBT, fused successive halving and fused Hyperband over a
population of networks, trained as one program on an NVIDIA GPU (or in
waves through host memory when the population exceeds the card), and
the driver path (``driver.run_search`` over the host algorithms and the
``gpu`` slot-pool backend, or the ``cpu`` backend's process pool over
per-trial workloads, with seeded fault injection), with
span tracing (``obs/``), the JAX package's
TPU kernels rewritten as CUDA kernels (``csrc/``), made
crash-recoverable by verified snapshots and a member-granular ledger
journal. ``python -m mpi_opt_tpu_torch`` is the
command line (``cli.py``). Entry points run on CUDA unless the caller
passes ``device="cpu"`` (or ``--backend cpu``); nothing falls back to
the CPU on its own.
"""

from mpi_opt_tpu_torch.device import resolve_device
from mpi_opt_tpu_torch.ops.pbt import PBTConfig
from mpi_opt_tpu_torch.train.fused_asha import fused_sha
from mpi_opt_tpu_torch.train.fused_pbt import fused_pbt
from mpi_opt_tpu_torch.workloads import get_workload

__all__ = ["resolve_device", "PBTConfig", "fused_pbt", "fused_sha", "get_workload"]

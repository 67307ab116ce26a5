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

import importlib

# the exports load on first use: the sweep service's spool clients
# (`submit`, `status`, `cancel`, `drain`) import the package without
# torch and start in a fraction of a second
_EXPORTS = {
    "resolve_device": "mpi_opt_tpu_torch.device",
    "PBTConfig": "mpi_opt_tpu_torch.ops.pbt",
    "fused_pbt": "mpi_opt_tpu_torch.train.fused_pbt",
    "fused_sha": "mpi_opt_tpu_torch.train.fused_asha",
    "get_workload": "mpi_opt_tpu_torch.workloads",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module 'mpi_opt_tpu_torch' has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name]), name)

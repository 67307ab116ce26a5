"""Resource-exhaustion classification (port of
``mpi_opt_tpu/utils/resources.py``): one funnel for device OOM and
storage exhaustion, the two failures that no retry heals.

- :class:`DeviceOOM`: the CUDA caching allocator (or a kernel launch)
  ran out of device memory. Deterministic for a given program and
  population, so supervisors must not fund restarts: the CLI exits
  ``EX_IOERR`` (74).
- :class:`StorageFull`: ENOSPC/EDQUOT from a durable-state write. The
  snapshot layer gets one retention-prune retry (``utils/checkpoint.py``),
  then the run parks with ``EX_IOERR`` so freeing disk and ``--resume``
  recover.

Everything else asks :func:`is_device_oom` / :func:`is_storage_full`.
The observer and the fault-injection seams mirror the JAX package's:
drills install schedules on the module-level seams, and lifecycle
events flow through a process-wide observer the CLI wires to its
metrics stream.
"""

from __future__ import annotations

import errno
from typing import Callable, Optional

#: "no space" and "quota exceeded" are the same operational event
_STORAGE_ERRNOS = (errno.ENOSPC, errno.EDQUOT)

#: the allocation-failure text CUDA errors carry ("CUDA out of memory.
#: Tried to allocate ...", "CUDA error: out of memory"); checked only
#: after the type gate, and never with XLA's RESOURCE_EXHAUSTED, which
#: is not this runtime's error
_CUDA_OOM_MARKERS = ("cuda out of memory", "cuda error: out of memory")


class DeviceOOM(RuntimeError):
    """Typed device-memory exhaustion: the population and its
    activations exceeded the device budget. Carries the original error
    text; ``wave_size`` is the wave cap in force when the launch died
    (None for a resident sweep), so diagnostics can say what to halve."""

    def __init__(self, message: str, wave_size: Optional[int] = None):
        super().__init__(message)
        self.wave_size = wave_size


class StorageFull(OSError):
    """Typed storage exhaustion: an OSError with the original errno, so
    ``is_storage_full`` classifies it and errno-aware callers keep
    working."""

    def __init__(self, message: str, path: Optional[str] = None, err: int = errno.ENOSPC):
        super().__init__(err, message, path)


def is_storage_full(e: BaseException) -> bool:
    """Is this exception a storage-exhaustion answer (ENOSPC/EDQUOT)?
    Walks the explicit cause chain (``raise X from e``), so a wrapper
    classifies like its root cause."""
    depth = 0
    while isinstance(e, BaseException) and depth < 8:
        if isinstance(e, OSError) and e.errno in _STORAGE_ERRNOS:
            return True
        e = e.__cause__
        depth += 1
    return False


def storage_full_error(path: str, op: str = "write") -> StorageFull:
    """A classified ``StorageFull`` naming the operation and path."""
    return StorageFull(f"no space left on device during {op}", path=path)


def is_device_oom(e: BaseException) -> bool:
    """Is this exception a CUDA device-memory exhaustion? Type first:
    ``torch.cuda.OutOfMemoryError`` (the caching allocator's), or a
    ``RuntimeError`` whose message is CUDA's out-of-memory error (a
    kernel launch or cuDNN/cuBLAS workspace failure). A user exception
    that merely quotes the words, or any other runtime's error, does
    not classify."""
    import torch

    if isinstance(e, (DeviceOOM, torch.cuda.OutOfMemoryError)):
        return True
    if not isinstance(e, RuntimeError):
        return False
    msg = str(e).lower()
    return "resource_exhausted" not in msg and any(m in msg for m in _CUDA_OOM_MARKERS)


def as_device_oom(e: BaseException, wave_size: Optional[int] = None) -> Optional[DeviceOOM]:
    """``DeviceOOM`` wrapping ``e`` when it classifies, else None."""
    if isinstance(e, DeviceOOM):
        return e
    if not is_device_oom(e):
        return None
    return DeviceOOM(f"{type(e).__name__}: {e}"[:2000], wave_size=wave_size)


def synthetic_resource_exhausted(detail: str = "chaos-injected"):
    """A constructed ``torch.cuda.OutOfMemoryError`` with the caching
    allocator's message, so drills exercise the real classification
    path (type gate included), not a stand-in."""
    import torch

    return torch.cuda.OutOfMemoryError(f"CUDA out of memory. ({detail})")


class oom_funnel:
    """Context manager: a CUDA out-of-memory error escaping the guarded
    region re-raises as typed :class:`DeviceOOM` carrying ``wave_size``;
    everything else propagates raw. The funnel retries nothing: the wave
    engine (``train/engine.py``) catches the typed error to halve its
    cap."""

    def __init__(self, wave_size: Optional[int] = None):
        self.wave_size = wave_size

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is None:
            return False
        oom = None if isinstance(exc, DeviceOOM) else as_device_oom(exc, self.wave_size)
        if oom is not None:
            raise oom from exc
        return False


# -- observer --------------------------------------------------------------

_OBSERVER: Optional[Callable] = None


def set_observer(cb: Optional[Callable]) -> None:
    global _OBSERVER
    _OBSERVER = cb


def clear_observer() -> None:
    set_observer(None)


def notify(event: str, **fields) -> None:
    """Report a resource-lifecycle event (``snapshot_pruned``,
    ``oom_backoff``, ``wave_resized``); falls
    back to a warning so library callers still see it."""
    if _OBSERVER is not None:
        _OBSERVER(event, **fields)
        return
    import warnings

    warnings.warn(f"{event}: {fields}", RuntimeWarning, stacklevel=2)


# -- fault-injection seams ----------------------------------------------------
#
# ``disk_fault(op, path)`` sits inside the snapshot save and the ledger
# fsync and may raise a classified StorageFull; ``launch_fault(kind)``
# sits at the top of every guarded launch (a resident launch, one wave)
# and may raise a synthetic CUDA OOM; ``boundary_fault(stage)`` sits at the top of every launch
# boundary (``train.common.launch_boundary``).

_DISK_FAULTS: Optional[Callable[[str, str], None]] = None
_LAUNCH_FAULTS: Optional[Callable[[str], None]] = None
_BOUNDARY_FAULTS: Optional[Callable[[str], None]] = None


def set_disk_fault_injector(fn: Optional[Callable[[str, str], None]]) -> None:
    global _DISK_FAULTS
    _DISK_FAULTS = fn


def disk_fault(op: str, path: str) -> None:
    if _DISK_FAULTS is not None:
        _DISK_FAULTS(op, path)


def set_launch_fault_injector(fn: Optional[Callable[[str], None]]) -> None:
    global _LAUNCH_FAULTS
    _LAUNCH_FAULTS = fn


def launch_fault(kind: str) -> None:
    if _LAUNCH_FAULTS is not None:
        _LAUNCH_FAULTS(kind)


def set_boundary_fault_injector(fn: Optional[Callable[[str], None]]) -> None:
    global _BOUNDARY_FAULTS
    _BOUNDARY_FAULTS = fn


def boundary_fault(stage: str) -> None:
    if _BOUNDARY_FAULTS is not None:
        _BOUNDARY_FAULTS(stage)

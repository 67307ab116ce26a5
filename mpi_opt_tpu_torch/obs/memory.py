"""Device-memory readings (port of ``mpi_opt_tpu/obs/memory.py``).

The JAX package reads its device's ``memory_stats()``; here the CUDA
caching allocator and the driver answer:

- ``sample()``: one reading, ``{"bytes_in_use", "peak_bytes",
  "bytes_limit", "source"}``: the allocator's allocated bytes
  (``torch.cuda.memory_allocated``), its high-water mark since the last
  ``reset_peak`` (``max_memory_allocated``), and the card's total
  memory (``mem_get_info``). None on the CPU, where the JAX package's
  live-array fallback has no counterpart in PyTorch;
- ``note(sp)``: attach the reading to a traced span's attrs;
- ``measured_budget()``: the card's total memory, the budget
  ``train/staging.py::estimate_wave_size`` sizes ``auto`` waves from
  when no explicit budget is given (None on the CPU);
- ``watermark()``: ``sample()`` by the name benches record it under;
- ``reset_peak()``: start a new high-water window.

A cap set with ``torch.cuda.set_per_process_memory_fraction`` is the
allocator's own limit and is not read here: the budget is the card.
"""

from __future__ import annotations

from typing import Optional

import torch


def _cuda_device(device=None) -> Optional[torch.device]:
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return dev


def reset_peak(device=None) -> None:
    """Start a new high-water window (no-op on the CPU)."""
    dev = _cuda_device(device)
    if dev is not None:
        torch.cuda.reset_peak_memory_stats(dev)


def sample(device=None) -> Optional[dict]:
    """One reading of ``device`` (default: the current CUDA device), or
    None when it is not a CUDA device."""
    dev = _cuda_device(device)
    if dev is None:
        return None
    _free, total = torch.cuda.mem_get_info(dev)
    return {
        "bytes_in_use": int(torch.cuda.memory_allocated(dev)),
        "peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
        "bytes_limit": int(total),
        "source": "cuda_allocator",
    }


def note(attrs: dict, device=None) -> None:
    """Attach the current reading to an active span's attrs as
    ``mem_bytes`` / ``mem_peak_bytes`` / ``mem_src``. No-op untraced
    (``obs/trace.py``) and on the CPU; the readings are the caching
    allocator's host-side counters, which wait for no kernel."""
    from mpi_opt_tpu_torch.obs import trace

    dev = _cuda_device(device)
    if dev is None or not trace.enabled():
        return
    attrs["mem_bytes"] = int(torch.cuda.memory_allocated(dev))
    attrs["mem_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    attrs["mem_src"] = "cuda_allocator"


def measured_budget(device=None) -> Optional[int]:
    """The card's total memory in bytes, or None on the CPU."""
    m = sample(device)
    return None if m is None else (m["bytes_limit"] or None)


def watermark(device=None) -> Optional[dict]:
    """``sample()`` under the name benches record it by."""
    return sample(device)

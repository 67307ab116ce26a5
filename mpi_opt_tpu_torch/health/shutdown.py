"""Graceful-shutdown signal protocol (port of
``mpi_opt_tpu/health/shutdown.py``).

1. ``ShutdownGuard`` installs SIGTERM/SIGINT handlers that only set a
   flag: nothing is interrupted, and nothing in the handler touches
   CUDA, the ledger or the filesystem.
2. Drain points (the fused sweep's launch boundary,
   ``train.common.launch_boundary``) poll ``requested()``; when set,
   they flush the snapshot (the launch's results were already fetched
   and journaled) and raise ``SweepInterrupted``.
3. The CLI catches it and exits ``EX_TEMPFAIL`` (75): restart with
   ``--resume``, without billing a retry budget.

A second SIGINT after a real signal escalates to ``KeyboardInterrupt``
(first Ctrl-C drains, second aborts). Repeated SIGTERM stays graceful.

The JAX package's programmatic drain (``request`` and the slice hook a
sweep service installs) is not here: the port has no service to call it.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional

from mpi_opt_tpu_torch.utils.exitcodes import EX_TEMPFAIL  # noqa: F401


class SweepInterrupted(RuntimeError):
    """Raised at a drain point after a graceful-shutdown request. The
    in-flight launch has completed and durable state (snapshot, ledger
    journal) is flushed; the catcher summarises and exits
    ``EX_TEMPFAIL``."""

    def __init__(self, signal_name: Optional[str] = None, at: str = ""):
        self.signal = signal_name or "SIGTERM"
        self.at = at
        super().__init__(f"graceful shutdown ({self.signal})" + (f" at {at}" if at else ""))


_ACTIVE: Optional["ShutdownGuard"] = None


class ShutdownGuard:
    """Context manager owning the process's graceful-shutdown flag.
    Installs the flag-setting handlers on enter (main thread only) and
    restores the previous handlers on exit, so in-process callers never
    leak a changed SIGINT disposition."""

    def __init__(self):
        self.requested = False
        self.signal_name: Optional[str] = None
        self.installed = False
        self._prev: dict = {}
        self._outer: Optional[ShutdownGuard] = None
        self._signal_seen = False

    def _handle(self, signum, frame):
        name = signal.Signals(signum).name
        if self._signal_seen and signum == signal.SIGINT:
            raise KeyboardInterrupt
        self._signal_seen = True
        self.requested = True
        if self.signal_name is None:
            self.signal_name = name

    def __enter__(self) -> "ShutdownGuard":
        global _ACTIVE
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev[sig] = signal.signal(sig, self._handle)
            self.installed = True
        self._outer = _ACTIVE
        _ACTIVE = self
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        if self.installed:
            for sig, prev in self._prev.items():
                signal.signal(sig, prev)
            self.installed = False
        _ACTIVE = self._outer
        return False


def requested() -> bool:
    """Is a graceful shutdown pending? (False when no guard is active.)"""
    return _ACTIVE is not None and _ACTIVE.requested


def active_signal() -> Optional[str]:
    return None if _ACTIVE is None else _ACTIVE.signal_name

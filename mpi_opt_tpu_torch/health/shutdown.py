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

``request`` and the per-boundary slice hook are the programmatic drain.
The sweep service (``service/scheduler.py``) preempts a tenant with
them: its hook counts boundaries and, at the slice budget, raises the
same flag a SIGTERM raises, labelled ``SLICE``, so a time-sliced sweep
leaves exactly the durable state a preempted one does. The request is
scoped to the active guard and dies with it. The multi-process coord
plane (``parallel/coord.py``) chains its drain agreement onto the same
hook. ``delivered_signal`` survives guard exit, so the server can tell
its own slice expiry from a real signal after a slice returns.
"""

from __future__ import annotations

import signal
import threading
from typing import Callable, Optional

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
        global _DELIVERED
        name = signal.Signals(signum).name
        # every real delivery is recorded at module level: a tenant
        # slice's guard consumes the flag, and the server reads this
        # after the slice returns
        _DELIVERED = name
        if self._signal_seen and signum == signal.SIGINT:
            raise KeyboardInterrupt
        self._signal_seen = True
        self.requested = True
        # a real signal outranks a slice request's label
        if self.signal_name is None or self.signal_name == SLICE:
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


#: the pseudo-signal name a cooperative time-slice drain reports
SLICE = "SLICE"

#: the most recent real signal a guard's handler received in this
#: process (None until one arrives). Written from the signal handler, so
#: it stays a bare store: a lock taken in a handler can deadlock against
#: its interrupted holder on the same thread
# sweeplint: disable=guarded-by -- signal handlers may only flag-set; a lock in a handler can self-deadlock against its interrupted holder
_DELIVERED: Optional[str] = None

#: per-boundary callback (``set_slice_hook``); None without one
_SLICE_HOOK: Optional[Callable[[str], None]] = None


def request(source: str = SLICE) -> bool:
    """Raise the active guard's drain flag without a signal; False (a
    no-op) when no guard is active. A real signal name already recorded
    is never overwritten."""
    if _ACTIVE is None:
        return False
    if _ACTIVE.signal_name is None:
        _ACTIVE.signal_name = source
    _ACTIVE.requested = True
    return True


def delivered_signal() -> Optional[str]:
    """The most recent real signal a guard's handler received in this
    process, or None. It survives guard exit; ``clear_delivered`` opens
    a new observation window."""
    return _DELIVERED


def clear_delivered() -> None:
    global _DELIVERED
    _DELIVERED = None


def set_slice_hook(fn: Optional[Callable[[str], None]]) -> None:
    """Install ``fn(stage)``, called from every non-final drain point
    (``train.common.launch_boundary``) BEFORE the drain flag is checked,
    so a hook that calls ``request()`` has the same boundary honour it.
    It must be cheap and must not raise, with one sanctioned exception:
    the coord plane's ``CoordWedged`` when a peer never reaches the
    boundary (a process-fatal verdict)."""
    global _SLICE_HOOK
    _SLICE_HOOK = fn


def get_slice_hook() -> Optional[Callable[[str], None]]:
    """The installed hook (None without one), for wrappers that chain
    onto it."""
    return _SLICE_HOOK


def clear_slice_hook() -> None:
    set_slice_hook(None)


def poll_slice(stage: str) -> None:
    """A drain point's call into the installed hook (no-op without one)."""
    if _SLICE_HOOK is not None:
        _SLICE_HOOK(stage)

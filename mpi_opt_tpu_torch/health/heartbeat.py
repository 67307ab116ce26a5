"""Per-process progress heartbeat (port of
``mpi_opt_tpu/health/heartbeat.py``): the liveness signal exit codes
cannot give.

A process wedged in a collective or in dead I/O is alive to
``waitpid``. The heartbeat is the missing observable: the process
rewrites one small JSON file at every unit of real progress (each
fused launch boundary) with a monotonic beat counter, a wall timestamp
and progress fields; a supervisor that sees the counter frozen while
the process lives has found a hang.

Writes are write-tmp-then-rename, so a reader never sees a torn record,
and deliberately not fsync'd: the file signals liveness, not history.
A heartbeat that cannot be written warns once and goes quiet; it never
kills the sweep it reports on.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from mpi_opt_tpu_torch.obs import trace


class Heartbeat:
    """Beats come from the sweep's thread and from the wave engine's
    staging thread (``train/staging.py``): the counter is taken under a
    lock, and each thread writes its own temporary file."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self.beats = 0
        self._warned = False
        self._lock = threading.Lock()

    def beat(self, **progress) -> Optional[dict]:
        """Record one unit of progress; returns the record (None if the
        write failed: warned once, never raised). ``phase`` is the active
        trace span (``obs/trace.current_phase``): a stall report can say
        "stalled during stage_in"."""
        # sweeplint: disable=beat-path-nonblocking -- counter-only critical section (no I/O under the lock); skipping would break beat monotonicity
        with self._lock:
            self.beats += 1
            n = self.beats
        rec = {
            "pid": os.getpid(),
            "beats": n,
            "ts": round(time.time(), 4),
            "phase": trace.current_phase(),
            "progress": progress,
        }
        tmp = f"{self.path}.tmp{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "w") as f:
                f.write(json.dumps(rec))
            os.replace(tmp, self.path)
        except OSError as e:
            if not self._warned:
                self._warned = True
                import warnings

                warnings.warn(
                    f"heartbeat write to {self.path} failed ({e}); liveness "
                    "reporting disabled for this process",
                    stacklevel=2,
                )
            _notify_listener(rec)
            return None
        _notify_listener(rec)
        return rec


_ACTIVE: Optional[Heartbeat] = None

#: process-wide beat listener (``set_beat_listener``)
_LISTENER = None


def set_beat_listener(fn) -> None:
    """Install ``fn(rec)``, called after every beat of every heartbeat in
    this process, whichever thread beat (``rec`` is None when the write
    failed: progress still happened). The sweep service refreshes a
    tenant's lease and its own registration from it. It must be cheap;
    an exception from it is contained, never raised into the sweep."""
    global _LISTENER
    _LISTENER = fn


def clear_beat_listener() -> None:
    set_beat_listener(None)


def _notify_listener(rec) -> None:
    if _LISTENER is None:
        return
    try:
        _LISTENER(rec)
    except Exception:
        pass  # contained: a listener bug must not kill the sweep


def configure(path: str) -> Heartbeat:
    """Install the process-wide heartbeat (the CLI's --heartbeat-file)."""
    global _ACTIVE
    _ACTIVE = Heartbeat(path)
    return _ACTIVE


def deconfigure() -> None:
    """Drop the process-wide heartbeat (end of a CLI run)."""
    global _ACTIVE
    _ACTIVE = None


def beat(**progress) -> None:
    """Module-level beat: no-op unless a heartbeat is configured, so
    library code calls it unconditionally."""
    if _ACTIVE is not None:
        _ACTIVE.beat(**progress)


def read_beat(path: str) -> Optional[dict]:
    """The last complete beat record at ``path``, or None (missing,
    unreadable or torn)."""
    try:
        with open(path, "r") as f:
            rec = json.loads(f.read())
    except (OSError, json.JSONDecodeError):
        return None
    return rec if isinstance(rec, dict) else None

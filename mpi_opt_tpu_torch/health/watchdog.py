"""Stall detection over rank heartbeat files, the supervisor's side (a
copy of ``mpi_opt_tpu/health/watchdog.py``).

``StallDetector`` tracks, per watched path, the last beat counter seen
and WHEN it last advanced (supervisor clock — rank clocks are never
compared across hosts). A rank whose counter has not moved for longer
than ``stall_timeout`` is reported stale.

Engagement rule: a rank is only watched once its heartbeat file EXISTS
— i.e. once it has beaten at least once. Ranks beat at progress
boundaries (first driver batch / first fused launch), which puts the
long, legitimate silence of cold-start compilation BEFORE the first
beat, outside the watchdog's jurisdiction; after the first beat, the
gaps being timed are steady-state launch intervals the operator can
actually bound with ``--stall-timeout``. The cost: a rank that wedges
before its first beat is only caught by whole-rank exit (or the
platform); the alternative — timing compilation — makes every
conservative timeout a false kill.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

from mpi_opt_tpu_torch.health.heartbeat import read_beat


class StallDetector:
    def __init__(self, paths: Sequence[str], stall_timeout: float):
        if stall_timeout <= 0:
            raise ValueError(f"stall_timeout must be > 0, got {stall_timeout}")
        self.paths = list(paths)
        self.timeout = float(stall_timeout)
        # index -> (last beats value, monotonic time it last advanced)
        self._seen: dict[int, tuple[int, float]] = {}

    def poll(self, now: Optional[float] = None) -> list[int]:
        """Indices of watched ranks whose beats are frozen past the
        timeout. ``now`` is injectable for tests; defaults to
        ``time.monotonic()``."""
        if now is None:
            now = time.monotonic()
        stale = []
        for i, path in enumerate(self.paths):
            rec = read_beat(path)
            if rec is None:
                continue  # never beaten (or unreadable): not watched yet
            beats = int(rec.get("beats", 0))
            prev = self._seen.get(i)
            if prev is None or beats != prev[0]:
                self._seen[i] = (beats, now)
            elif now - prev[1] > self.timeout:
                stale.append(i)
        return stale

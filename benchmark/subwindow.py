"""The traced run's device sub-window: ``torch.profiler`` started and
stopped between two heartbeats of the sweep, the card synchronised at
both ends (taken anew over the same work where the trace lost launches),
and the reduction of its trace.

The busy time is the union of the intervals in which a kernel, a copy or
a fill ran on the device (the same arithmetic as the port's timeline
tool). Only device activity is recorded: recording the host's
operators too slows the host enough to starve the device (on an H100
the SmallCNN step's idle share read 19% with them, 3.8% without). An
idle gap between two device intervals is named by the launch the device
waited for.
"""

from __future__ import annotations

import json
import os
import threading
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


#: sub-windows of the same work a traced run may record: the profiler can
#: lose kernel records (one traced run in some thirty read another count
#: of GroupNorm launches than its sub-window runs). A sub-window is taken
#: anew over the next span of as many beats only when the one before fell
#: short, and only the last one recorded is exported: a profiler session
#: started after another leaves the earlier one's durations at zero.
SESSIONS = 3


class SubWindow:
    """Profiles the device work between main-thread beats ``start`` and
    ``stop`` (1-based, counted from ``arm()``). Where the trace's kernel
    names do not satisfy ``holds_its_work(names)``, it profiles the next
    span of as many beats, which runs the same work (the next
    sub-launch, the next wave), up to ``sessions`` in all."""

    def __init__(self, start: int, stop: int, out_dir: str, device,
                 holds_its_work=lambda names: True, sessions: int = SESSIONS):
        period = int(stop) - int(start)
        self.bounds = [(int(start) + k * period, int(stop) + k * period) for k in range(sessions)]
        self.path = os.path.join(out_dir, "subwindow.pt.trace.json")
        self.device = device
        self.holds_its_work = holds_its_work
        self.armed = False
        self.beats = 0
        self.sessions: list = []  # {"prof", "t0", "t1", "held"}, in order
        self.error = None

    def arm(self) -> None:
        self.armed = True

    def _sync(self) -> None:
        import torch

        torch.cuda.synchronize(self.device)

    def on_beat(self, rec) -> None:
        if not self.armed or threading.current_thread() is not threading.main_thread():
            return
        self.beats += 1
        try:
            cur = self.sessions[-1] if self.sessions else None
            if cur is not None and cur["t1"] is None and self.beats == self.bounds[len(self.sessions) - 1][1]:
                self._sync()
                cur["t1"] = time.perf_counter()
                cur["prof"].stop()
                names = [e.name() for e in cur["prof"].profiler.kineto_results.events()]
                cur["held"] = bool(self.holds_its_work(names))
            n = len(self.sessions)
            if (n < len(self.bounds) and self.beats == self.bounds[n][0]
                    and (cur is None or cur.get("held") is False)):
                from torch.profiler import ProfilerActivity, profile

                self._sync()
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.start()
                self._sync()
                self.sessions.append({"prof": prof, "t0": time.perf_counter(), "t1": None})
        except Exception as e:  # reported with the run; the sweep goes on
            self.error = f"{type(e).__name__}: {e}"

    def export(self) -> dict | None:
        """The reduced last sub-window recorded (``session``: its index),
        or None when it did not record."""
        if not self.sessions or self.sessions[-1]["t1"] is None:
            return None
        s = self.sessions[-1]
        s["prof"].export_chrome_trace(self.path)
        s["prof"] = None
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        return dict(reduce_trace(events, s["t1"] - s["t0"]), session=len(self.sessions) - 1)


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_trace(events: list, window_s: float) -> dict:
    """Device ops by name, busy seconds and idle gaps by the launch that
    ended them, from Chrome trace events (``ts``/``dur`` in
    microseconds)."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    kernels = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0))) for e in dev]
    merged = _union([(ts, ts + dur) for _, ts, dur in kernels])
    busy_us = sum(b - a for a, b in merged)
    span_us = merged[-1][1] - merged[0][0] if merged else 0.0
    by_name: dict = {}
    for name, _, dur in kernels:
        by_name[name] = by_name.get(name, 0.0) + dur * 1e-6
    starts = sorted(dev, key=lambda e: float(e["ts"]))
    gaps: dict = {}
    j = 0
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        while j < len(starts) and float(starts[j]["ts"]) < nxt:
            j += 1
        if j < len(starts):
            name = "launch of " + starts[j]["name"][:120]
            gaps[name] = gaps.get(name, 0.0) + (nxt - end) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {
        "window_s": window_s,
        "busy_s": busy_us * 1e-6,
        # first device interval's start to the last one's end
        "device_span_s": span_us * 1e-6,
        "kernels": kernels,
        "device_ops": top(by_name),
        "idle_gaps": top(gaps),
    }

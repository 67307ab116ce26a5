"""The host's step phases laid over the profiled sub-window's device
trace: each idle gap, and each device operation, put down to the
program's span that caused it.

The program's spans (``mpi_opt_tpu_torch/obs/trace.py``) carry their
entry and exit as ``t0_ns``/``t1_ns`` on ``time.time_ns``, the clock of
the profiler's activity timestamps (the exported trace's
``baseTimeNanoseconds`` plus ``ts`` in microseconds), and the thread
that ran them (``os_tid``, and ``thread_ident``, whose low 32 bits a
CUDA-only profiler session gives its runtime events as ``tid``). Here:

- a device operation belongs to the span that launched it: its
  ``correlation`` names its runtime launch event, whose thread's
  innermost span at the launch's start is taken; where that thread has
  no open span (autograd's device thread runs the backward), the main
  thread's innermost span at that time;
- an idle gap, between two intervals of the device's busy union (the
  arithmetic of ``subwindow.reduce_trace``), belongs to the main
  thread's innermost span over the gap, split by overlap where it
  straddles spans. The sub-window's edges, before its first device
  operation and after its last, are nobody's.

A run whose spans carry no clock (a program without these fields)
reads None, as does a run with no sub-window or one that does not hold
its work.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import threading

from benchmark.readers import subwindow_holds_its_work

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
#: the training step's phases, whose cover of the main thread is logged
STEP_PHASES = ("batch", "forward", "backward", "update")
#: the phases with an idle metric of their own (``<phase>_idle_pct``);
#: ``other_idle_pct`` is the idle in none of them
NAMED_PHASES = STEP_PHASES + ("stage_in", "eval")
MASK = 0xFFFFFFFF


def _key(tid) -> int:
    """A thread id as the trace may give it: 32 bits, sign dropped."""
    return int(tid) & MASK


class Timeline:
    """One thread's innermost span at each moment: the spans, properly
    nested, flattened to sorted disjoint segments ``(a, b, name)``."""

    def __init__(self, spans):
        out, stack, pos = [], [], 0.0
        for t0, t1, name in sorted(spans, key=lambda s: (s[0], -s[1])):
            while stack and stack[-1][0] <= t0:
                end, top = stack.pop()
                if end > pos:
                    out.append((pos, end, top))
                    pos = end
            if stack and t0 > pos:
                out.append((pos, t0, stack[-1][1]))
            pos = t0
            stack.append((min(t1, stack[-1][0]) if stack else t1, name))
        while stack:
            end, top = stack.pop()
            if end > pos:
                out.append((pos, end, top))
                pos = end
        self.starts = [a for a, _, _ in out]
        self.segments = out

    def at(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.segments[i][1]:
            return self.segments[i][2]
        return None

    def overlap(self, a: float, b: float, into: dict) -> None:
        """Add the length of ``[a, b)`` spent in each span to ``into``
        (None: in no span)."""
        covered = 0.0
        i = max(0, bisect.bisect_right(self.starts, a) - 1)
        while i < len(self.segments) and self.segments[i][0] < b:
            s0, s1, name = self.segments[i]
            part = min(b, s1) - max(a, s0)
            if part > 0:
                into[name] = into.get(name, 0.0) + part
                covered += part
            i += 1
        if b - a > covered:
            into[None] = into.get(None, 0.0) + (b - a - covered)


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def analyse(doc: dict, spans: list, main: tuple) -> dict | None:
    """The sub-window's idle gaps and device time by span name (µs),
    from a Chrome trace ``doc`` and the program's span records; ``main``
    is the main thread's ``(os_tid, thread_ident)``. None where no span
    carries the clock fields."""
    base = int(doc.get("baseTimeNanoseconds", 0))
    threads: dict = {}
    for s in spans:
        if "t0_ns" not in s or "t1_ns" not in s:
            continue
        ivl = ((int(s["t0_ns"]) - base) / 1e3, (int(s["t1_ns"]) - base) / 1e3, s["span"])
        threads.setdefault((s.get("os_tid"), s.get("thread_ident")), []).append(ivl)
    if not threads:
        return None
    lines = {ident: Timeline(ivls) for ident, ivls in threads.items()}
    by_key: dict = {}
    for (os_tid, ident), line in lines.items():
        for tid in (os_tid, ident):
            if tid is not None:
                by_key[_key(tid)] = line
    main_line = by_key.get(_key(main[0])) or by_key.get(_key(main[1])) or Timeline([])

    events = doc["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    launch = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e
    device_us: dict = {}
    unmatched = 0
    for e in dev:
        r = launch.get(e.get("args", {}).get("correlation"))
        if r is None:
            unmatched += 1
            continue
        t = float(r["ts"])
        line = by_key.get(_key(r.get("tid", -1)))
        name = None if line is None else line.at(t)
        if name is None:
            name = main_line.at(t)
        device_us[name] = device_us.get(name, 0.0) + float(e.get("dur", 0.0))

    merged = _union([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in dev])
    idle_us: dict = {}
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        main_line.overlap(end, nxt, idle_us)
    cover: dict = {}
    tail = 0.0
    if merged:
        main_line.overlap(merged[0][0], merged[-1][1], cover)
        # how long the device ran on after the main thread's last step
        # phase closed (the host waits in the sub-window's closing sync)
        ends = [b for a, b, name in main_line.segments if name in STEP_PHASES and a < merged[-1][1]]
        tail = max(0.0, merged[-1][1] - max(ends)) if ends else 0.0
    return {
        "idle_us": idle_us,
        "gap_us": sum(idle_us.values()),
        "device_us": device_us,
        "device_span_us": merged[-1][1] - merged[0][0] if merged else 0.0,
        "main_cover_us": cover,
        "tail_us": tail,
        "device_ops": len(dev),
        "unmatched": unmatched,
    }


def of_run(run) -> dict | None:
    """``analyse`` of the run's exported sub-window (once a run), or
    None where there is nothing to read."""
    cached = getattr(run, "_host_phases", False)
    if cached is not False:
        return cached
    got = None
    sub = getattr(run, "subwindow", None)
    if (sub is not None and os.path.exists(sub.path) and run.profile is not None
            and run.profile["window_s"] > 0 and subwindow_holds_its_work(run)):
        with open(sub.path) as f:
            doc = json.load(f)
        main = threading.main_thread()
        got = analyse(doc, run.spans, (main.native_id, main.ident))
        if got is not None:
            span = got["device_span_us"] or 1.0
            cover = {str(k): round(100.0 * v / span, 3) for k, v in got["main_cover_us"].items()}
            steps = sum(got["main_cover_us"].get(p, 0.0) for p in STEP_PHASES)
            window_us = run.profile["window_s"] * 1e6
            print(f"[bench] host phases: main thread over the device span {cover} %, step phases "
                  f"{100.0 * steps / span:.3f} %, the device's last {got['tail_us'] / 1e3:.3f} ms "
                  f"after the last step phase closed; idle gaps {100.0 * got['gap_us'] / window_us:.4f} "
                  f"% of the sub-window, edges {100.0 * (window_us - span) / window_us:.4f} %; "
                  f"{got['unmatched']} of {got['device_ops']} device operations without a launch "
                  f"event", file=sys.stderr, flush=True)
    run._host_phases = got
    return got


def idle_pct(run, phase: str):
    """Percent of the sub-window idle while the main thread was in
    ``phase``."""
    got = of_run(run)
    if got is None:
        return None
    return 100.0 * got["idle_us"].get(phase, 0.0) * 1e-6 / run.profile["window_s"]


def other_idle_pct(run):
    """Percent of the sub-window idle while the main thread was in none
    of ``NAMED_PHASES``."""
    got = of_run(run)
    if got is None:
        return None
    named = sum(got["idle_us"].get(p, 0.0) for p in NAMED_PHASES)
    return 100.0 * (got["gap_us"] - named) * 1e-6 / run.profile["window_s"]


def device_ms_per_step(run, phase: str):
    """Device milliseconds of the operations launched from ``phase``
    spans, over the sub-window's steps (the cell file's ``profile``)."""
    got = of_run(run)
    if got is None:
        return None
    return got["device_us"].get(phase, 0.0) * 1e-3 / run.cell["profile"]["steps"]

"""Span tracing: where a sweep's seconds go, from the system itself
(port of ``mpi_opt_tpu/obs/trace.py``).

``span("phase", **attrs)`` wraps a region of host code; on exit it
makes ONE duration record for the configured metrics sink::

    {"event": "span", "span": "train", "dur_s": 1.23, "self_s": 1.01,
     "t": <end, process clock>, "ts": <end, epoch s>, "t0_ns": ...,
     "t1_ns": ..., "rank": 0, "tid": 0, "os_tid": 4242,
     "thread_ident": 139..., "parent": None, ...attrs}

``t0_ns`` and ``t1_ns`` are the span's entry and exit on
``time.time_ns``, the clock of ``torch.profiler``'s activity timestamps
(the exported Chrome trace's ``baseTimeNanoseconds`` plus ``ts`` in
microseconds). ``os_tid`` is the thread's native id and
``thread_ident`` its ``threading.get_ident()`` (the pthread id); the
trace's CUDA runtime events name their thread by one of them (a
CUDA-only session of torch 2.11 gives the pthread id's low 32 bits as
``tid``). So a span can be laid over the device trace, and each launch
and each idle gap put down to the span that caused it. ``parent`` is
the enclosing span on the same thread. ``ts`` and ``t`` are the span's
end, taken at exit.

A span hands its record to the sink's ``hold`` (``MetricsLogger``
keeps it in memory: no JSON work and no write inside a training step);
``flush`` asks the sink to write what it holds, at every
``train/common.py::launch_boundary`` before its hooks run, at
``configure`` and ``deconfigure``, and when a span raised (a crashed
phase still emits). The logger also writes what it holds before any
record it logs and at close. A sink without ``hold`` gets each record
through ``log`` at the span's exit.

Design rules (the JAX package's):

- **Null mode costs nothing.** With no sink configured (``configure``
  never called), a span does zero JSON work and builds no record: it
  only pushes and pops a thread-local frame, which the heartbeat's
  ``phase`` field (``health/heartbeat.py``) needs even untraced, and
  reads no clock but ``perf_counter``.
- **Thread-safe.** Each thread owns its own span stack (the staging
  engine's worker traces its copies while the main loop dispatches);
  records carry a small ``tid``. The sink (``MetricsLogger``) holds
  records in a lock-free queue and writes whole lines under its own
  lock.
- **Self time is computed at exit**: every span accumulates its direct
  children's durations, and ``self_s = dur_s - children``, so the
  attribution (``obs/report.py``) never double-counts wall.
- **Tracing never kills the run it traces**: a sink failure warns once
  and goes quiet.
- **A span adds no device synchronisation.** A span's end is host
  time; the call sites close a span after a barrier the sweep already
  has there (a launch's curve fetch, the interval's drain, a copy's
  CUDA event), so ``dur_s`` is the device work's wall.

The port has no XLA compile, so it emits no ``compile`` spans: the
attribution's compile table reports zero counts.

While a ``utils/profiling.py`` window records, each span also enters
``torch.profiler.record_function`` of its name (gated on
``profiling.active()``, as the JAX package gates its
``TraceAnnotation``), so a window's trace carries the sweep's phase
names ("train", "stage_in") and spans cost nothing more otherwise. A
suppressed span (``suppressed``) enters no range, as it emits no record.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

from mpi_opt_tpu_torch.utils import profiling

_SINK = None  # the MetricsLogger spans emit through (None = disabled)
_TAGS: dict = {}  # rank/tenant labels stamped into every record
# warn-once latch, deliberately unlocked: two threads racing here can
# only warn twice
# sweeplint: disable=guarded-by -- idempotent warn-once latch: worst race outcome is a duplicate warning
_WARNED = False
_LOCAL = threading.local()  # .stack: list[[phase, child_dur, name]]; .tid; .os_tid; .ident; .suppress
_TID_LOCK = threading.Lock()
_NEXT_TID = [0]
# the most recently entered, still active span on any thread: the
# heartbeat's fallback when the beating thread holds no span. A plain
# GIL-atomic store, approximate under races, as a diagnostic label may be
# sweeplint: disable=guarded-by -- GIL-atomic store of a best-effort diagnostic label; approximate-under-races is the documented contract
_LAST_PHASE: Optional[str] = None


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
        _LOCAL.os_tid = threading.get_native_id()
        _LOCAL.ident = threading.get_ident()
        with _TID_LOCK:
            _LOCAL.tid = _NEXT_TID[0]
            _NEXT_TID[0] += 1
    return st


def configure(metrics, rank: int = 0, tenant: Optional[str] = None):
    """Install ``metrics`` (a ``MetricsLogger``) as the span sink; returns
    the prior (sink, tags) state for ``deconfigure``. The prior sink
    writes what it holds first."""
    global _SINK, _TAGS
    flush()
    prior = (_SINK, _TAGS)
    _SINK = metrics
    tags = {"rank": int(rank)}
    if tenant:
        tags["tenant"] = str(tenant)
    _TAGS = tags
    return prior


def deconfigure(prior=None) -> None:
    """Drop (or restore) the span sink. ``prior`` is ``configure``'s or
    ``save``'s return value; None restores the disabled state. The sink
    writes what it holds first."""
    global _SINK, _TAGS
    flush()
    if prior is None:
        _SINK, _TAGS = None, {}
    else:
        _SINK, _TAGS = prior


def save():
    """The current (sink, tags) state, shaped like ``configure``'s
    return value, for a caller to restore with ``deconfigure``."""
    return (_SINK, _TAGS)


def enabled() -> bool:
    return _SINK is not None


def note_device(sp: dict, device=None) -> None:
    """Attach the device kind to an active span's attrs (the setup spans
    carry it, so ``obs/bubbles.py`` finds the roofline's cap):
    ``torch.cuda.get_device_name`` on CUDA, "cpu" otherwise. No-op
    untraced, never raises."""
    if _SINK is None:
        return
    try:
        import torch

        dev = torch.device("cuda" if device is None else device)
        sp["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    except Exception:
        pass


def current_phase() -> Optional[str]:
    """The calling thread's innermost active span, else the most
    recently entered still-active span on any thread (best effort),
    else None. Feeds the heartbeat's ``phase``."""
    st = getattr(_LOCAL, "stack", None)
    if st:
        return st[-1][0]
    return _LAST_PHASE


@contextlib.contextmanager
def suppressed():
    """Silence span emission on THIS thread for the body (the FLOP
    probe's own work must not count as the sweep's)."""
    prev = getattr(_LOCAL, "suppress", False)
    _LOCAL.suppress = True
    try:
        yield
    finally:
        _LOCAL.suppress = prev


def _warn(e: Exception) -> None:
    global _WARNED
    if not _WARNED:
        _WARNED = True
        import warnings

        warnings.warn(
            f"span emission failed ({type(e).__name__}: {e}); tracing "
            "records may be incomplete for this process",
            stacklevel=4,
        )


def flush() -> None:
    """Have the sink write the span records it holds. Safe from any
    thread; a sink failure warns once."""
    sink = _SINK
    try:
        getattr(sink, "flush", lambda: None)()
    except Exception as e:
        _warn(e)


def _emit(sink, name: str, dur: float, self_s: float, t0_ns: int, t1_ns: int, parent, attrs: dict) -> None:
    try:
        record = getattr(sink, "hold", None) or sink.log
        record(
            "span",
            ts=round(t1_ns * 1e-9, 6),
            span=name,
            dur_s=round(dur, 6),
            self_s=round(self_s, 6),
            t0_ns=t0_ns,
            t1_ns=t1_ns,
            tid=_LOCAL.tid,
            os_tid=_LOCAL.os_tid,
            thread_ident=_LOCAL.ident,
            parent=parent,
            **_TAGS,
            **attrs,
        )
    except Exception as e:
        _warn(e)


def _profiler_range(name: str):
    """``record_function(name)``, entered, while a ``profile_window``
    records and the thread's spans are not suppressed; else None."""
    if not profiling.active() or getattr(_LOCAL, "suppress", False):
        return None
    try:
        import torch

        rf = torch.profiler.record_function(name)
        rf.__enter__()
        return rf
    except Exception:
        return None


@contextlib.contextmanager
def span(name: str, **attrs):
    """Trace one phase of host work; yields a mutable dict for attrs
    known only at exit (``sp["bytes"] = n``). Exceptions propagate; the
    span still emits, so a crashed phase shows in the attribution."""
    global _LAST_PHASE
    st = _stack()
    # an ``op`` attr joins the phase name (``boundary:rung_cut``) for the
    # heartbeat; the record keeps the bare name
    phase = f"{name}:{attrs['op']}" if "op" in attrs else name
    frame = [phase, 0.0, name]
    st.append(frame)
    _LAST_PHASE = phase
    rf = _profiler_range(name)
    t0_ns = time.time_ns() if _SINK is not None else None
    t0 = time.perf_counter()
    raised = True
    try:
        yield attrs
        raised = False
    finally:
        dur = time.perf_counter() - t0
        if rf is not None:
            try:
                rf.__exit__(None, None, None)
            except Exception:
                pass
        st.pop()
        _LAST_PHASE = st[-1][0] if st else None
        if st:
            st[-1][1] += dur  # credit the parent's child accumulator
        sink = _SINK
        if sink is not None and not getattr(_LOCAL, "suppress", False):
            t1_ns = time.time_ns()
            _emit(sink, name, dur, max(0.0, dur - frame[1]),
                  t1_ns - int(dur * 1e9) if t0_ns is None else t0_ns, t1_ns,
                  st[-1][2] if st else None, attrs)
            if raised:
                flush()


def traced(name: Optional[str] = None, **attrs):
    """Decorator form of ``span`` (defaults to the function's name)."""

    def deco(fn):
        import functools

        label = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(label, **attrs):
                return fn(*args, **kwargs)

        return wrapper

    return deco

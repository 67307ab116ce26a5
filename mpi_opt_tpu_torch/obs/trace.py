"""Span tracing: where a sweep's seconds go, from the system itself
(port of ``mpi_opt_tpu/obs/trace.py``).

``span("phase", **attrs)`` wraps a region of host code; on exit it
emits ONE duration record into the configured metrics sink::

    {"event": "span", "span": "train", "dur_s": 1.23, "self_s": 1.01,
     "t": ..., "ts": <end, epoch>, "rank": 0, "tid": 0, ...attrs}

Design rules (the JAX package's):

- **Null mode costs nothing.** With no sink configured (``configure``
  never called), a span does zero JSON work: it only pushes and pops a
  thread-local frame, which the heartbeat's ``phase`` field
  (``health/heartbeat.py``) needs even untraced.
- **Thread-safe.** Each thread owns its own span stack (the staging
  engine's worker traces its copies while the main loop dispatches);
  records carry a small ``tid``. The sink (``MetricsLogger``) writes
  whole lines under its own lock.
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
names ("train", "stage_in") and spans cost nothing more otherwise.
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
_LOCAL = threading.local()  # .stack: list[[phase, child_dur]]; .tid; .suppress
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
        with _TID_LOCK:
            _LOCAL.tid = _NEXT_TID[0]
            _NEXT_TID[0] += 1
    return st


def configure(metrics, rank: int = 0, tenant: Optional[str] = None):
    """Install ``metrics`` (a ``MetricsLogger``) as the span sink; returns
    the prior (sink, tags) state for ``deconfigure``."""
    global _SINK, _TAGS
    prior = (_SINK, _TAGS)
    _SINK = metrics
    tags = {"rank": int(rank)}
    if tenant:
        tags["tenant"] = str(tenant)
    _TAGS = tags
    return prior


def deconfigure(prior=None) -> None:
    """Drop (or restore) the span sink. ``prior`` is ``configure``'s or
    ``save``'s return value; None restores the disabled state."""
    global _SINK, _TAGS
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


def _emit(name: str, dur_s: float, self_s: float, attrs: dict) -> None:
    global _WARNED
    sink = _SINK
    if sink is None or getattr(_LOCAL, "suppress", False):
        return
    try:
        sink.log(
            "span",
            span=name,
            dur_s=round(dur_s, 6),
            self_s=round(self_s, 6),
            tid=getattr(_LOCAL, "tid", 0),
            **_TAGS,
            **attrs,
        )
    except Exception as e:
        if not _WARNED:
            _WARNED = True
            import warnings

            warnings.warn(
                f"span emission failed ({type(e).__name__}: {e}); tracing "
                "records may be incomplete for this process",
                stacklevel=3,
            )


def _profiler_range(name: str):
    """``record_function(name)``, entered, while a ``profile_window``
    records; else None."""
    if not profiling.active():
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
    frame = [phase, 0.0]
    st.append(frame)
    _LAST_PHASE = phase
    rf = _profiler_range(name)
    t0 = time.perf_counter()
    try:
        yield attrs
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
        _emit(name, dur, max(0.0, dur - frame[1]), attrs)


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

"""Launch-window profiling (port of ``mpi_opt_tpu/utils/profiling.py``).

``profile_window(dir)`` wraps a measured region in a ``torch.profiler``
trace when a directory is given and is a zero-cost no-op otherwise, so
callers wrap it unconditionally:

    with profile_window(args.profile_dir, device=args.device):
        run_search(...)

``profile_window(dir, launches=(A, B))`` defers the trace to a LAUNCH
WINDOW: the profiler starts when launch A begins and stops when launch
B + 1 begins, or when the region ends (1-based, inclusive:
``--profile-launches`` on the CLI). The fused sweeps (a resident launch,
a wave interval, a rung, a TPE generation) and the driver loop (a batch
that dispatches trials) call ``launch_tick`` at the top of every launch,
where the JAX package calls it, so a window names the same launches in
both packages.

``active()`` reports whether a window is recording: ``obs/trace.py``
enters ``torch.profiler.record_function`` for its spans exactly then,
so span names ("train", "stage_in") appear on the trace's timeline and
cost nothing otherwise.

Each window writes one Chrome trace-event JSON into the directory
(Perfetto, chrome://tracing and TensorBoard's PyTorch profiler plugin
load it): ``<host>_<pid>.launches_<A>-<B>.pt.trace.json`` for a launch
window, ``<host>_<pid>.run.pt.trace.json`` for a whole region; a later
window of the same process and name gets ``.2``, ``.3``, ... before
``.pt.trace.json``. It records CPU activity, of every thread where the
installed torch offers ``profile_all_threads`` (the staging worker's
spans too), and CUDA activity when the run's device is CUDA. The device
is synchronised when the window starts and again before it stops, so
the window holds the device work of launches A..B (and of any stage-out
still in flight) and none of the launches before A.

Profiling never kills the run it measures: a start that fails prints
``[profile] trace start failed (...)`` on stderr and the run goes on
unprofiled; a failed stop or export prints ``[profile] trace stop
failed (...)``. A profiled launch is not comparable to an unprofiled
one (CUPTI's first start can take seconds inside launch A, and every
event is held in memory until the window stops), so keep windows to a
few launches.
"""

from __future__ import annotations

import contextlib
import os
import socket
import sys

_ACTIVE = False  # a profiler window is currently recording
_WINDOW = None  # the installed _LaunchWindow, if any
_RUN = None  # the recording window's (profile, trace path, device)


def active() -> bool:
    return _ACTIVE


def _all_threads():
    """The profiler config that records every thread's ranges, or None
    where the installed torch does not offer it (then only the thread
    that started the window records)."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def _trace_path(directory, label: str) -> str:
    stem = os.path.join(str(directory), f"{socket.gethostname()}_{os.getpid()}.{label}")
    path, n = f"{stem}.pt.trace.json", 1
    while os.path.exists(path):
        n += 1
        path = f"{stem}.{n}.pt.trace.json"
    return path


def _start(directory, device, label: str) -> bool:
    global _ACTIVE, _RUN
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        dev = torch.device("cuda" if device is None else device)
        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(dev)  # the launches before A stay out
        os.makedirs(directory, exist_ok=True)
        path = _trace_path(directory, label)
        prof = profile(activities=activities, experimental_config=_all_threads())
        prof.start()
    except Exception as e:
        print(
            f"[profile] trace start failed ({type(e).__name__}: {e}); continuing unprofiled",
            file=sys.stderr,
        )
        return False
    _RUN = (prof, path, dev)
    _ACTIVE = True
    return True


def _stop() -> None:
    global _ACTIVE, _RUN
    if not _ACTIVE:
        return
    _ACTIVE = False
    (prof, path, dev), _RUN = _RUN, None
    try:
        try:
            if dev.type == "cuda":
                import torch

                # launch B's device work, and a stage-out still in
                # flight on the staging thread, land inside the window
                torch.cuda.synchronize(dev)
        finally:
            prof.stop()
        prof.export_chrome_trace(path)
    except Exception as e:
        print(f"[profile] trace stop failed ({type(e).__name__}: {e})", file=sys.stderr)


class _LaunchWindow:
    """Deferred profiler start/stop driven by launch ticks."""

    def __init__(self, directory, start: int, stop: int, device=None):
        self.directory = directory
        self.start = int(start)  # first profiled launch (1-based)
        self.stop = int(stop)  # last profiled launch (inclusive)
        self.device = device
        self.n = 0

    def tick(self) -> None:
        self.n += 1
        if self.n == self.start:
            _start(self.directory, self.device, f"launches_{self.start}-{self.stop}")
        elif self.n == self.stop + 1:
            _stop()


def launch_tick() -> None:
    """Called at the top of every launch/batch; no-op unless a launch
    window is installed (the common case: one branch on a global)."""
    if _WINDOW is not None:
        _WINDOW.tick()


def parse_launch_window(spec: str):
    """``"A"`` or ``"A:B"`` -> (A, B), 1-based inclusive; ValueError on
    malformed/inverted input (the CLI maps it to a usage error)."""
    parts = spec.split(":")
    if len(parts) == 1:
        a = b = int(parts[0])
    elif len(parts) == 2:
        a, b = int(parts[0]), int(parts[1])
    else:
        raise ValueError(f"expected N or A:B, got {spec!r}")
    if a < 1 or b < a:
        raise ValueError(f"launch window must be 1-based and non-inverted, got {spec!r}")
    return a, b


@contextlib.contextmanager
def profile_window(directory=None, launches=None, device=None):
    """Profile the body into ``directory`` (no-op without one): the whole
    body, or only launches A..B of ``launches=(A, B)``. ``device`` is the
    run's device (None: CUDA, the port's default). A body's exception
    propagates; a window still open when the body ends (fewer launches
    than B) is closed then."""
    global _WINDOW
    if not directory:
        yield
        return
    if launches is not None:
        # guard only the install/teardown bookkeeping: profiling must
        # never kill (or mask an exception from) the run being measured
        _WINDOW = _LaunchWindow(directory, *launches, device=device)
        try:
            yield
        finally:
            _WINDOW = None
            _stop()
        return
    started = _start(directory, device, "run")
    try:
        yield
    finally:
        if started:
            _stop()

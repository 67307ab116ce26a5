"""Percent of the profiled sub-window in which the device sat idle while
the main thread was in a ``backward`` span (``host_phases.py``)."""

from benchmark.host_phases import idle_pct


def read(run):
    return idle_pct(run, "backward")

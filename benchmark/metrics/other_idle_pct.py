"""Percent of the profiled sub-window in which the device sat idle while
the main thread was in none of the step's phases (``batch``,
``forward``, ``backward``, ``update``), ``stage_in`` or ``eval`` (the
wave loop, heartbeats, the collector), between the sub-window's first
and last device operations (``host_phases.NAMED_PHASES``)."""

from benchmark.host_phases import other_idle_pct


def read(run):
    return other_idle_pct(run)

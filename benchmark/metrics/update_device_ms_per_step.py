"""Device milliseconds of the operations launched from the program's
``update`` spans, over the profiled sub-window's steps
(``host_phases.py``)."""

from benchmark.host_phases import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "update")

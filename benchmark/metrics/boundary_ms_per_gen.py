"""Self milliseconds of the program's ``boundary`` and ``journal`` spans
a generation inside the window."""

from benchmark.readers import self_ms_per_generation


def read(run):
    return self_ms_per_generation(run, ("boundary", "journal"))

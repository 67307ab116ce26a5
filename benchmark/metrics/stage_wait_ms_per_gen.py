"""Self milliseconds of the program's ``stage_wait`` spans a generation
inside the window."""

from benchmark.readers import self_ms_per_generation


def read(run):
    return self_ms_per_generation(run, ("stage_wait",))

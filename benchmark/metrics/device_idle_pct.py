"""Percent of the profiled sub-window in which no kernel, copy or fill
ran on the device."""


def read(run):
    p = run.profile
    if p is None or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])

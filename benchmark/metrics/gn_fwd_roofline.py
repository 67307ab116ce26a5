"""Share of the bytes bound that the GroupNorm forward kernel reaches
over the profiled sub-window."""

from benchmark.readers import gn_roofline


def read(run):
    return gn_roofline(run, backward=False)

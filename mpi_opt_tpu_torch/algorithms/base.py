"""The one best-pick rule (port of ``best_finite`` in
``mpi_opt_tpu/algorithms/base.py``)."""

from __future__ import annotations

import numpy as np


def best_finite(items, key):
    """The item with the highest FINITE key, else the first item.

    A diverged trial's score (NaN, or +/-inf from an exploded loss)
    never wins: Python's ``max`` never displaces a NaN front-runner and
    +inf would beat every real score. Only an all-diverged item set
    returns a diverged item (the first), so callers still see that
    something ran, with the non-finite key as the flag. None for no
    items."""
    items = list(items)
    finite = [it for it in items if np.isfinite(key(it))]
    if finite:
        return max(finite, key=key)
    return items[0] if items else None

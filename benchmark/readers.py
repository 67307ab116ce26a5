"""Shared arithmetic of the metric readers in ``metrics/``.

Each reader is ``read(run) -> number or None``: None when the run holds
nothing it can read (no sub-window, no span of its kind, a launch count
other than the cell's shapes give), and the harness then leaves the
metric out of the line.
"""

from __future__ import annotations

import math

from benchmark.reference import counts
from benchmark.reference.models import gn_groups, gn_sites


def window_spans(run, names) -> list:
    """The program's spans of ``names`` that ended inside the window."""
    w = run.window
    return [s for s in run.spans if s.get("span") in names
            and run.w0_epoch <= s.get("ts", 0.0) <= w["t1_epoch"]]


def self_ms_per_generation(run, names):
    spans = window_spans(run, names)
    if not spans or not run.window["generations"]:
        return None
    return 1e3 * sum(float(s["self_s"]) for s in spans) / run.window["generations"]


def gn_expected(run, backward: bool):
    """(launches, least bytes) of one GroupNorm kernel in the profiled
    sub-window, as the cell's shapes give them."""
    cfg, prof = run.cfg, run.cell["profile"]
    width = run.cell["member_chunk"] or prof["members"]
    chunks = math.ceil(prof["members"] / width)
    launches = [b for b, bwd in counts.gn_step_launches(cfg, width) if bwd == backward]
    expected = prof["steps"] * chunks * len(launches)
    total = prof["steps"] * chunks * sum(launches)
    if not backward and prof.get("evals"):
        n_chunks = math.ceil(cfg["n_val"] / cfg["eval_chunk"])
        per = [counts.gn_launch_bytes(cfg["eval_chunk"], s, width * c, width * gn_groups(cfg, c), False)
               for s, c, _ in gn_sites(cfg)]
        expected += prof["evals"] * n_chunks * chunks * len(per)
        total += prof["evals"] * n_chunks * chunks * sum(per)
    return expected, total


def gn_times(profile, backward: bool) -> list:
    """Device seconds of each launch of one GroupNorm kernel in a
    profiled sub-window."""
    key = "gn_bwd" if backward else "gn_fwd"
    return [dur * 1e-6 for name, _, dur in profile["kernels"] if key in name]


def subwindow_holds_its_work(run) -> bool:
    """Whether the profiled sub-window recorded exactly the steps and
    evals the cell file says it holds: its GroupNorm launches, forward
    and backward, witness them."""
    return run.profile is not None and launches_hold(run)(k for k, _, _ in run.profile["kernels"])


def launches_hold(run):
    """``holds(names)``: whether kernel names hold exactly the GroupNorm
    launches, forward and backward, of the cell's sub-window."""
    expected = {("gn_bwd" if b else "gn_fwd"): gn_expected(run, b)[0] for b in (False, True)}

    def holds(names) -> bool:
        seen = dict.fromkeys(expected, 0)
        for name in names:
            for key in expected:
                seen[key] += key in name
        return seen == expected

    return holds


def gn_roofline(run, backward: bool):
    """Percent of the bytes bound of one GroupNorm kernel over the
    profiled sub-window: the least bytes of the launches the cell's
    shapes give, over 3.35 TB/s, against the kernel's device time."""
    if run.profile is None:
        return None
    times = gn_times(run.profile, backward)
    expected, total = gn_expected(run, backward)
    if len(times) != expected or not times:
        return None
    return 100.0 * (total / counts.PEAK_BYTES_PER_S) / sum(times)

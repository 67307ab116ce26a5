"""Wall-clock-to-target metrics of a sweep (port of the pure-Python part
of ``mpi_opt_tpu/utils/metrics.py``: ``wall_to_target``,
``wall_to_target_launchwise``, ``sweep_wall_to_target``, copied so that
the port imports nothing of the JAX package)."""

from __future__ import annotations


def wall_to_target(curve, wall_s: float, target: float):
    """Prorated wall-clock (seconds) until a per-generation best-score
    curve first reaches ``target``; None if it never does.

    The metric-of-record definition (BASELINE.json: "wall-clock to
    target validation accuracy"): generations are uniform work, so
    reaching the target at generation g costs (g+1)/G of the sweep's
    wall. Single-sourced here so every bench compares raw float curve
    values against the target identically.
    """
    curve = [float(v) for v in curve]
    for g, v in enumerate(curve):
        if v >= target:
            return wall_s * (g + 1) / len(curve)
    return None


def wall_to_target_launchwise(curve, launch_gens, launch_walls, target: float):
    """``wall_to_target`` with MEASURED per-launch wall times.

    A gen-chunked fused sweep runs as N launches of ``launch_gens[i]``
    generations taking ``launch_walls[i]`` seconds each (fused_pbt
    returns both). Whole-sweep prorating assumes every generation costs
    the same; here only generations *within* one launch are prorated
    (the scan's iterations really are identical programs), and launch
    boundaries use their measured times — tightening the granularity
    error from one sweep-fraction to at most one launch's interior.
    None if the curve never reaches target.
    """
    if len(launch_gens) != len(launch_walls):
        raise ValueError(
            f"launch_gens ({len(launch_gens)}) and launch_walls "
            f"({len(launch_walls)}) must align"
        )
    if sum(launch_gens) != len(curve):
        raise ValueError(
            f"launch_gens sums to {sum(launch_gens)} but curve has "
            f"{len(curve)} generations"
        )
    curve = [float(v) for v in curve]
    g0 = 0  # first generation index of the current launch
    done = 0.0  # wall of all completed launches before it
    for n_g, w in zip(launch_gens, launch_walls):
        for j in range(n_g):
            if curve[g0 + j] >= target:
                return done + w * (j + 1) / n_g
        g0 += n_g
        done += w
    return None


def sweep_wall_to_target(result: dict, wall_s: float, target: float):
    """Launch-granular when the sweep result carries measured launch
    durations (fused_pbt always does for fresh sweeps), whole-sweep
    prorating otherwise (``launch_walls`` is None when a resume from a
    pre-upgrade snapshot left early durations unknown).

    Semantics note: ``launch_walls`` deliberately excludes checkpoint-
    save time (the metric measures the sweep's compute-to-target),
    while the fallback's ``wall_s`` is the caller's clock and usually
    includes it. Records should carry the total wall
    alongside (benches record both) so the difference is visible."""
    if result.get("launch_walls") is not None:
        return wall_to_target_launchwise(
            result["best_curve"], result["launch_gens"], result["launch_walls"], target
        )
    return wall_to_target(result["best_curve"], wall_s, target)

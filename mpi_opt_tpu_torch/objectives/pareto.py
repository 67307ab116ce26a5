"""Pareto ranking on the device, and the host-side front and volume math
(port of ``mpi_opt_tpu/objectives/pareto.py``).

Device side, stock torch ops on the scores' device with fixed shapes
and no host synchronisation (the reference's are XLA work, not Pallas):

- ``pareto_rank``: the exact non-dominated-sort front index. A point's
  front number is the longest chain of dominators ending at it, so
  exactly ``n`` Bellman iterations over the ``[n, n]`` dominance matrix
  give the NSGA-II fronts. The loop never exits early: that would need a
  host read each iteration.
- ``crowding_distance``: per-front crowding (normalized neighbour gaps
  per objective, front boundaries ``inf``), from one composite
  (front-major, value) sort per objective. The sort is stable, as
  ``jnp.argsort`` is: ties in the composite key keep index order.
- ``pareto_score``: the effective scalar every selection site ranks.
  Feasible points order by ``-rank`` then crowding (squashed into
  ``[0, 0.5]`` so it never crosses a rank), infeasible but finite
  points sit below every feasible one, ordered by least constraint
  violation, and non-finite points are ``-inf``.

Host side (numpy, copied from the JAX package): ``pareto_front_mask``,
``hypervolume`` (exact recursive slicing, reference point = the
per-objective front minimum) and ``select_best`` (the typed
best-feasible winner pick).

Everything works in maximize form (``objectives/spec.py``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "pareto_rank",
    "crowding_distance",
    "pareto_score",
    "pareto_front_mask",
    "hypervolume",
    "select_best",
]


def _as_f32(t, device) -> torch.Tensor:
    return torch.as_tensor(t, device=device).to(torch.float32)


def _ok_mask(norm_scores: torch.Tensor, valid) -> torch.Tensor:
    finite = torch.isfinite(norm_scores).all(dim=-1)
    if valid is None:
        return finite
    return finite & torch.as_tensor(valid, dtype=torch.bool, device=norm_scores.device)


def pareto_rank(norm_scores: torch.Tensor, valid=None) -> torch.Tensor:
    """Exact non-dominated-sort front index per row (0 = Pareto front),
    int64 ``[n]``.

    ``norm_scores``: ``[n, m]`` maximize-form scores. Rows that are
    non-finite in any objective (or masked by ``valid``) get rank ``n``,
    after every real front.
    """
    n = norm_scores.shape[0]
    ok = _ok_mask(norm_scores, valid)
    s = torch.where(ok[:, None], norm_scores.to(torch.float32), -torch.inf)
    # dom[j, i]: j dominates i (>= everywhere, > somewhere, both alive)
    ge = (s[:, None, :] >= s[None, :, :]).all(dim=-1)
    gt = (s[:, None, :] > s[None, :, :]).any(dim=-1)
    dom = ge & gt & ok[:, None] & ok[None, :]
    rank = torch.zeros(n, dtype=torch.int64, device=norm_scores.device)
    zero = torch.zeros((), dtype=torch.int64, device=norm_scores.device)
    for _ in range(n):
        best = torch.where(dom, rank[:, None] + 1, zero).amax(dim=0)
        rank = torch.maximum(rank, best)
    return torch.where(ok, rank, n)


def crowding_distance(norm_scores: torch.Tensor, rank: torch.Tensor, valid=None) -> torch.Tensor:
    """NSGA-II crowding distance within each front (higher = lonelier),
    f32 ``[n]``.

    Per objective the values are min-max normalized over live rows, then
    each row's gap to its two same-front neighbours is summed;
    front-boundary rows (and invalid rows) are ``inf``.
    """
    n, m = norm_scores.shape
    dev = norm_scores.device
    ok = _ok_mask(norm_scores, valid)
    s = norm_scores.to(torch.float32)
    rr = rank.to(torch.float32)
    lo = torch.where(ok[:, None], s, torch.inf).amin(dim=0)
    hi = torch.where(ok[:, None], s, -torch.inf).amax(dim=0)
    span = torch.clamp(hi - lo, min=1e-12)
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    d = torch.zeros(n, dtype=torch.float32, device=dev)
    for j in range(m):
        vn = torch.where(ok, (s[:, j] - lo[j]) / span[j], 0.0)
        order = torch.argsort(rr * 2.0 + vn, stable=True)  # vn in [0, 1] < front stride 2
        r_s = rank[order]
        v_s = vn[order]
        prev_same = torch.cat([no, r_s[1:] == r_s[:-1]])
        next_same = torch.cat([r_s[:-1] == r_s[1:], no])
        prev_v = torch.cat([v_s[:1], v_s[:-1]])
        next_v = torch.cat([v_s[1:], v_s[-1:]])
        gap = torch.where(prev_same & next_same, next_v - prev_v, torch.inf)
        # the gaps back to row order: an index write through the permutation
        by_row = torch.zeros(n, dtype=torch.float32, device=dev)
        by_row[order] = gap
        d = d + by_row
    return torch.where(ok, d, torch.inf)


def _violation(norm_scores: torch.Tensor, norm_bounds) -> torch.Tensor:
    """Summed scale-normalized constraint violation per row (0 when
    feasible). Unconstrained objectives carry ``-inf`` bounds and
    contribute nothing."""
    b = _as_f32(norm_bounds, norm_scores.device)
    s = norm_scores.to(torch.float32)
    scale = torch.clamp(b.abs(), min=1.0)
    per = torch.where(
        torch.isfinite(b)[None, :],
        torch.clamp(b[None, :] - s, min=0.0) / scale[None, :],
        0.0,
    )
    return per.sum(dim=-1)


def pareto_score(norm_scores: torch.Tensor, valid=None, norm_bounds=None) -> torch.Tensor:
    """The effective selection scalar, f32 ``[n]`` (see module doc).

    Descending order of the result is the multi-objective preference
    order: feasible fronts first (crowding breaks ties inside a front),
    then infeasible but finite rows by least violation, then ``-inf``
    for diverged rows. ``norm_bounds`` may be a tensor on the scores'
    device (what the sweeps pass: no copy) or an array.
    """
    n = norm_scores.shape[0]
    dev = norm_scores.device
    ok = _ok_mask(norm_scores, valid)
    if norm_bounds is None:
        feasible = ok
        violation = torch.zeros(n, dtype=torch.float32, device=dev)
    else:
        b = _as_f32(norm_bounds, dev)
        sane = torch.where(ok[:, None], norm_scores.to(torch.float32), -torch.inf)
        feasible = ok & torch.where(torch.isfinite(b)[None, :], sane >= b[None, :], True).all(dim=-1)
        violation = _violation(sane, b)
    rank = pareto_rank(norm_scores, valid=feasible)
    crowd = crowding_distance(norm_scores, rank, valid=feasible)
    squash = torch.where(torch.isfinite(crowd), crowd / (1.0 + crowd), 1.0)
    eff_feasible = -rank.to(torch.float32) + 0.5 * squash
    # every feasible eff > -n; infeasible strictly below, by violation
    eff_infeasible = -(n + 1.0) - violation
    return torch.where(feasible, eff_feasible, torch.where(ok, eff_infeasible, -torch.inf))


# -- host side (winner picks, result summaries) ---------------------------


def pareto_front_mask(norm_scores, valid=None) -> np.ndarray:
    """Boolean mask of non-dominated rows (host numpy; rows non-finite
    in any objective are never on the front)."""
    s = np.asarray(norm_scores, dtype=np.float64)
    if s.ndim != 2:
        raise ValueError(f"expected [n, m] scores, got shape {s.shape}")
    ok = np.all(np.isfinite(s), axis=-1)
    if valid is not None:
        ok = ok & np.asarray(valid, dtype=bool)
    masked = np.where(ok[:, None], s, -np.inf)
    ge = np.all(masked[:, None, :] >= masked[None, :, :], axis=-1)
    gt = np.any(masked[:, None, :] > masked[None, :, :], axis=-1)
    dom = ge & gt & ok[:, None] & ok[None, :]
    return ok & ~np.any(dom, axis=0)


def hypervolume(front, ref=None) -> float:
    """Exact hypervolume of a maximize-form front (recursive slicing).

    ``ref`` defaults to the per-objective minimum over the (finite)
    front: deterministic, so the same front always reports the same
    volume; boundary points then contribute zero in the dimension they
    anchor, the usual convention for a self-referenced front.
    """
    pts = np.asarray(front, dtype=np.float64)
    if pts.size == 0:
        return 0.0
    if pts.ndim != 2:
        raise ValueError(f"expected [n, m] front, got shape {pts.shape}")
    pts = pts[np.all(np.isfinite(pts), axis=-1)]
    if len(pts) == 0:
        return 0.0
    ref = pts.min(axis=0) if ref is None else np.asarray(ref, dtype=np.float64)
    pts = np.maximum(pts, ref)

    def _hv(p: np.ndarray, r: np.ndarray) -> float:
        if len(p) == 0:
            return 0.0
        if r.shape[0] == 1:
            return float(max(0.0, p[:, 0].max() - r[0]))
        p = p[np.argsort(-p[:, 0], kind="stable")]
        vol = 0.0
        for i in range(len(p)):
            right = p[i + 1, 0] if i + 1 < len(p) else r[0]
            width = p[i, 0] - right
            if width > 0.0:
                vol += width * _hv(p[: i + 1, 1:], r[1:])
        return vol

    return _hv(pts, ref)


def select_best(scores, spec) -> dict:
    """Constraint-aware winner pick over raw ``[n, m]`` scores (host).

    Typed result: ``kind`` is ``"feasible"`` (best normalized primary
    among feasible rows), ``"least_violation"`` (nothing feasible yet:
    the least-violating finite row, the primary breaking ties), or
    ``"diverged"`` (no finite row at all; ``index`` is None).
    """
    raw = np.asarray(scores, dtype=np.float64)
    norm = np.asarray(spec.normalize(raw), dtype=np.float64)
    primary = np.asarray(spec.scalarize(raw), dtype=np.float64)
    ok = np.all(np.isfinite(norm), axis=-1)
    if not np.any(ok):
        return {"index": None, "kind": "diverged", "violation": None}
    b = spec.norm_bounds()
    sane = np.where(ok[:, None], norm, -np.inf)
    feasible = ok & np.all(np.where(np.isfinite(b)[None, :], sane >= b[None, :], True), axis=-1)
    if np.any(feasible):
        idx = int(np.argmax(np.where(feasible, primary, -np.inf)))
        return {"index": idx, "kind": "feasible", "violation": 0.0}
    scale = np.maximum(np.abs(b), 1.0)
    per = np.where(
        np.isfinite(b)[None, :],
        np.maximum(b[None, :] - sane, 0.0) / scale[None, :],
        0.0,
    )
    viol = np.where(ok, per.sum(axis=-1), np.inf)
    # least violation wins; the primary breaks exact ties deterministically
    best_v = viol.min()
    tied = ok & np.isclose(viol, best_v, rtol=0.0, atol=0.0)
    idx = int(np.argmax(np.where(tied, primary, -np.inf)))
    return {"index": idx, "kind": "least_violation", "violation": float(viol[idx])}

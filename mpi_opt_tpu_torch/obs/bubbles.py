"""Bubble attribution, staging overlap and the roofline verdict (port
of ``mpi_opt_tpu/obs/bubbles.py``, which imports no JAX; copied so the
port imports nothing of the JAX package).

- **Busy vs idle is per (tenant, rank).** Device-occupying spans
  (``BUSY_SPANS``: train, stage_in, stage_out, boundary) from all of a
  rank's threads merge into one interval union; the gaps in the rank's
  [first-begin, last-end] window are the bubbles.
- **Gaps are attributed by overlap with host-side spans**
  (``CAUSE_OF_SPAN``); ``unattributed`` is gap time no span covers.
- **Staging overlap** reads the engine's cumulative counters from the
  newest ``stage_out``/``stage_wait`` span that carries them.
- **The roofline verdict**: ``bubble-bound`` when the device idles more
  than ``IDLE_BOUND_FRAC`` of the wall, ``transfer-bound`` when un-hidden
  staging wait exceeds ``TRANSFER_BOUND_FRAC``, else ``compute-bound``,
  with ``mxu_frac`` the achieved TF/s over the platform cap
  (``--peak-tflops``, else ``CALIBRATED_PEAK_TFLOPS`` by the device kind
  the setup span recorded). The name ``mxu_frac`` is the JAX package's
  record key; on the card it is the share of the tensor cores' peak.
- **The service surface**: ``stream_idle_frac`` (one parse) and
  ``StreamIdleTracker`` (incremental), the idle fraction the sweep
  service writes into a traced tenant's status at every slice end.
"""

from __future__ import annotations

from typing import Optional

#: spans during which the device is occupied (compute or an active
#: host<->device transfer); everything between their merged intervals
#: is a bubble
BUSY_SPANS = frozenset({"train", "stage_in", "stage_out", "boundary"})

#: non-busy span -> bubble cause bucket (anything else is "other")
CAUSE_OF_SPAN = {
    "compile": "compile",
    "stage_wait": "staging_wait",
    "journal": "journal",
    "save": "checkpoint",
    "save_wait": "checkpoint",
    "restore": "checkpoint",
    "digest": "checkpoint",
    "setup": "setup",
    "slice_setup": "setup",
}

#: run-level verdict thresholds (see module docstring). A quarter of
#: the wall is the point where the named cost dominates any plausible
#: kernel win — below it the kernel gap is the bigger lever.
IDLE_BOUND_FRAC = 0.25
TRANSFER_BOUND_FRAC = 0.25

#: platform matmul caps by device kind (TF/s), for a trace whose setup
#: span recorded its card (``trace.note_device``): the data sheet's dense
#: bf16 peak. A card not named here needs ``--peak-tflops``.
CALIBRATED_PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,  # H100 SXM
}


# -- interval arithmetic ---------------------------------------------------


def _merge(intervals: list) -> list:
    """Sorted union of (begin, end) intervals (empty/inverted dropped)."""
    ivs = sorted((b, e) for b, e in intervals if e > b)
    out: list = []
    for b, e in ivs:
        if out and b <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((b, e))
    return out

def _complement(merged: list, lo: float, hi: float) -> list:
    """Gaps of a MERGED interval union within [lo, hi] (each >= 0)."""
    gaps = []
    cur = lo
    for b, e in merged:
        if b > cur:
            gaps.append((cur, min(b, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(b, e) for b, e in gaps if e > b]

def _overlap_len(merged: list, gap: tuple) -> float:
    """Seconds a MERGED union overlaps one (begin, end) gap."""
    lo, hi = gap
    return sum(max(0.0, min(e, hi) - max(b, lo)) for b, e in merged)


def _span_interval(rec: dict) -> tuple:
    ts = float(rec["ts"])
    return (ts - float(rec["dur_s"]), ts)


def _group_key(rec: dict) -> tuple:
    return (rec.get("tenant"), int(rec.get("rank") or 0))


def _group_label(key: tuple) -> str:
    tenant, rank = key
    return f"{tenant}:rank{rank}" if tenant else f"rank{rank}"


# -- bubble analysis -------------------------------------------------------


def analyze(spans: list, include_gaps: bool = False) -> Optional[dict]:
    """Device-idle gaps per (tenant, rank), attributed by cause.

    Returns the attribution's ``bubbles`` section (None when no spans):
    run totals (``wall_s``/``busy_s``/``idle_s``/``idle_frac``, gap
    count, largest gap, per-cause idle seconds) plus a ``per_rank``
    breakdown. ``wall_s`` is the SUM of per-rank windows (each rank
    judged on its own clock), so ``busy_s + idle_s == wall_s`` exactly.
    ``include_gaps=True`` adds each rank's raw gap list; the attribution
    JSON omits it."""
    if not spans:
        return None
    groups: dict = {}
    for r in spans:
        groups.setdefault(_group_key(r), []).append(r)
    per_rank = {}
    tot_wall = tot_busy = tot_idle = tot_largest = 0.0
    tot_gaps = 0
    by_cause_tot: dict = {}
    for key in sorted(groups, key=lambda k: (k[0] or "", k[1])):
        group = groups[key]
        ivs = [_span_interval(r) for r in group]
        lo = min(b for b, _e in ivs)
        hi = max(e for _b, e in ivs)
        busy = _merge(
            [_span_interval(r) for r in group if r["span"] in BUSY_SPANS]
        )
        gaps = _complement(busy, lo, hi)
        cause_ivs: dict = {}
        all_nonbusy = []
        for r in group:
            if r["span"] in BUSY_SPANS:
                continue
            iv = _span_interval(r)
            all_nonbusy.append(iv)
            cause = CAUSE_OF_SPAN.get(r["span"], "other")
            cause_ivs.setdefault(cause, []).append(iv)
        cause_merged = {c: _merge(v) for c, v in cause_ivs.items()}
        nonbusy_merged = _merge(all_nonbusy)
        by_cause: dict = {}
        unattributed = 0.0
        gap_list = []
        for gap in gaps:
            g_len = gap[1] - gap[0]
            g_causes = {}
            for cause, merged in cause_merged.items():
                sec = _overlap_len(merged, gap)
                if sec > 0:
                    g_causes[cause] = sec
                    by_cause[cause] = by_cause.get(cause, 0.0) + sec
            covered = _overlap_len(nonbusy_merged, gap)
            un = max(0.0, g_len - covered)
            unattributed += un
            if include_gaps:
                dominant = (
                    max(g_causes, key=g_causes.get) if g_causes else "unattributed"
                )
                gap_list.append(
                    {
                        "begin_s": round(gap[0], 6),
                        "end_s": round(gap[1], 6),
                        "dur_s": round(g_len, 6),
                        "cause": dominant,
                    }
                )
        if unattributed > 0:
            by_cause["unattributed"] = unattributed
        wall = hi - lo
        idle = sum(e - b for b, e in gaps)
        busy_s = wall - idle
        entry = {
            "rank": key[1],
            "tenant": key[0],
            "wall_s": round(wall, 4),
            "busy_s": round(busy_s, 4),
            "idle_s": round(idle, 4),
            "idle_frac": round(idle / wall, 4) if wall > 0 else None,
            "gaps": len(gaps),
            "largest_gap_s": round(max((e - b for b, e in gaps), default=0.0), 4),
            "by_cause": {c: round(v, 4) for c, v in sorted(by_cause.items())},
        }
        if include_gaps:
            entry["gap_list"] = gap_list
        per_rank[_group_label(key)] = entry
        tot_wall += wall
        tot_busy += busy_s
        tot_idle += idle
        tot_gaps += len(gaps)
        tot_largest = max(tot_largest, entry["largest_gap_s"])
        for c, v in by_cause.items():
            by_cause_tot[c] = by_cause_tot.get(c, 0.0) + v
    return {
        "wall_s": round(tot_wall, 4),
        "busy_s": round(tot_busy, 4),
        "idle_s": round(tot_idle, 4),
        "idle_frac": round(tot_idle / tot_wall, 4) if tot_wall > 0 else None,
        "gaps": tot_gaps,
        "largest_gap_s": tot_largest,
        "by_cause": {c: round(v, 4) for c, v in sorted(by_cause_tot.items())},
        "per_rank": per_rank,
    }


# -- staging overlap -------------------------------------------------------


def staging_summary(spans: list) -> Optional[dict]:
    """The run's staging-overlap accounting, promoted from StagingEngine
    counters to trace evidence (None when the run staged nothing).

    Each (tenant, rank) group runs its OWN StagingEngine, so the
    cumulative counters are read per group and summed — collapsing a
    multi-rank merge onto one rank's newest span would divide one
    engine's overlap by every engine's transfer and under-report
    overlap by roughly the rank count. Per group:
    ``overlap_s``/``wait_s`` come from the newest stage span carrying
    the engine's cumulative attrs — exact, and present even for a run
    killed mid-generation; ``transfer_s`` is the sum of ``stage_out``
    durations (the worker's measured busy time); legacy streams without
    the attrs fall back to span-duration arithmetic. ``overlap_frac``
    is total overlap over total transfer."""
    groups: dict = {}
    for r in spans:
        if r["span"] in ("stage_out", "stage_wait", "stage_in"):
            groups.setdefault(_group_key(r), []).append(r)
    if not groups:
        return None
    transfer_s = wait_s = overlap_s = 0.0
    staged_bytes = n_outs = n_drains = 0
    for group in groups.values():
        outs = [r for r in group if r["span"] == "stage_out"]
        waits = [r for r in group if r["span"] == "stage_wait"]
        g_transfer = sum(float(r["dur_s"]) for r in outs)
        tagged = [
            r
            for r in outs + waits
            if isinstance(r.get("overlap_s"), (int, float))
            and isinstance(r.get("wait_s"), (int, float))
        ]
        if tagged:
            last = max(tagged, key=lambda r: float(r["ts"]))
            g_overlap, g_wait = float(last["overlap_s"]), float(last["wait_s"])
        else:
            g_wait = sum(float(r["dur_s"]) for r in waits)
            g_overlap = max(0.0, g_transfer - g_wait)
        transfer_s += g_transfer
        wait_s += g_wait
        overlap_s += g_overlap
        staged_bytes += sum(
            int(r["bytes"])
            for r in group
            if r["span"] != "stage_wait" and isinstance(r.get("bytes"), (int, float))
        )
        n_outs += len(outs)
        n_drains += len(waits)
    return {
        "transfer_s": round(transfer_s, 4),
        "wait_s": round(wait_s, 4),
        "overlap_s": round(overlap_s, 4),
        "overlap_frac": round(overlap_s / transfer_s, 4) if transfer_s > 0 else None,
        "staged_bytes": staged_bytes,
        "stage_outs": n_outs,
        "drains": n_drains,
    }


# -- the roofline verdict --------------------------------------------------


def resolve_peak(spans: list, peak_tflops=None) -> tuple:
    """(platform cap in TF/s, provenance) — explicit ``--peak-tflops``
    first, else the calibration table keyed by the device kind a setup
    span recorded, else (None, None)."""
    if peak_tflops:
        return float(peak_tflops), "cli"
    for r in spans:
        kind = r.get("device")
        if isinstance(kind, str) and kind in CALIBRATED_PEAK_TFLOPS:
            return CALIBRATED_PEAK_TFLOPS[kind], f"calibration:{kind}"
    return None, None


def roofline(
    spans: list,
    bubbles: Optional[dict],
    staging: Optional[dict],
    peak_tflops=None,
    peak_source=None,
) -> Optional[dict]:
    """The roofline section: per train launch, achieved TF/s against the
    platform cap (``mxu_frac``) and a bound verdict; run level, the
    single verdict the diff gate budgets (``idle_frac``/``min_overlap``
    /``min_mxu_frac`` keys). None when the run has no train spans."""
    train = sorted(
        (r for r in spans if r["span"] == "train"), key=lambda r: float(r["ts"])
    )
    if not train:
        return None
    # per-group stage_wait unions: a launch's un-hidden transfer wait is
    # the stage_wait time INSIDE its window, judged on its own rank
    waits_by_group: dict = {}
    for r in spans:
        if r["span"] == "stage_wait":
            waits_by_group.setdefault(_group_key(r), []).append(_span_interval(r))
    waits_by_group = {k: _merge(v) for k, v in waits_by_group.items()}
    per_launch = []
    for r in train:
        dur = float(r["dur_s"])
        window = _span_interval(r)
        stall = _overlap_len(waits_by_group.get(_group_key(r), []), window)
        stall_frac = stall / dur if dur > 0 else 0.0
        flops = r.get("flops")
        tflops = (
            float(flops) / dur / 1e12
            if isinstance(flops, (int, float)) and dur > 0
            else None
        )
        mxu = (
            round(tflops / peak_tflops, 4)
            if tflops is not None and peak_tflops
            else None
        )
        per_launch.append(
            {
                "launch": r.get("launch", r.get("batch")),
                "dur_s": round(dur, 4),
                "tflops_per_sec": None if tflops is None else round(tflops, 4),
                "mxu_frac": mxu,
                "stall_frac": round(stall_frac, 4),
                "bound": (
                    "transfer-bound"
                    if stall_frac > TRANSFER_BOUND_FRAC
                    else "compute-bound"
                ),
            }
        )
    with_flops = [
        (float(r["flops"]), float(r["dur_s"]))
        for r in train
        if isinstance(r.get("flops"), (int, float)) and float(r["dur_s"]) > 0
    ]
    tflops_all = (
        sum(f for f, _d in with_flops) / sum(d for _f, d in with_flops) / 1e12
        if with_flops
        else None
    )
    mxu_all = (
        round(tflops_all / peak_tflops, 4)
        if tflops_all is not None and peak_tflops
        else None
    )
    idle_frac = bubbles.get("idle_frac") if bubbles else None
    wall = bubbles.get("wall_s") if bubbles else None
    wait_frac = (
        round(staging["wait_s"] / wall, 4)
        if staging is not None and wall
        else None
    )
    if idle_frac is not None and idle_frac > IDLE_BOUND_FRAC:
        bound = "bubble-bound"
    elif wait_frac is not None and wait_frac > TRANSFER_BOUND_FRAC:
        bound = "transfer-bound"
    else:
        bound = "compute-bound"
    return {
        "peak_tflops": peak_tflops,
        "peak_source": peak_source,
        "tflops_per_sec": None if tflops_all is None else round(tflops_all, 4),
        "mxu_frac": mxu_all,
        "idle_frac": idle_frac,
        "stall_frac": wait_frac,
        "bound": bound,
        "per_launch": per_launch,
    }


# -- service surface -------------------------------------------------------


def stream_idle_frac(path: str) -> Optional[float]:
    """One-shot idle fraction of a metrics stream; None when the stream
    is unreadable or carries no spans — never an exception, a telemetry
    read must not kill its caller. The resident scheduler uses
    :class:`StreamIdleTracker` instead: this re-parses the whole file
    every call, which is O(n^2) over a long-lived tenant's slices."""
    try:
        from mpi_opt_tpu_torch.obs.report import _is_span, load_stream

        spans = [r for r in load_stream(path) if _is_span(r)]
        rep = analyze(spans)
    except (OSError, ValueError, KeyError):
        return None
    return None if rep is None else rep["idle_frac"]


class StreamIdleTracker:
    """Incremental idle fraction over a GROWING metrics stream.

    The scheduler refreshes a tenant's ``idle_frac`` at every slice end;
    re-parsing the whole stream each time would make cumulative status
    cost quadratic in stream length over a resident tenant's lifetime.
    This tracker remembers its byte offset (complete lines only — the
    tenant may be mid-append), folds new busy spans into per-group
    merged interval unions, and derives idle as window minus busy union
    — the same accounting ``analyze`` does, minus cause attribution,
    which the per-slice status field doesn't need. ``poll()`` never
    raises and tolerates a stream that doesn't exist yet."""

    #: compact the per-group interval list once it grows past this — a
    #: merge is O(k log k) and busy spans mostly coalesce, so the list
    #: stays proportional to genuine gaps, not span count
    _COMPACT_AT = 64

    def __init__(self, path: str):
        self.path = path
        self._offset = 0
        self._groups: dict = {}  # group key -> [lo, hi, busy intervals]

    def poll(self) -> Optional[float]:
        import json as _json

        try:
            with open(self.path, "rb") as f:
                f.seek(self._offset)
                data = f.read()
        except OSError:
            return self.idle_frac()
        end = data.rfind(b"\n")
        if end >= 0:
            self._offset += end + 1
            for raw in data[:end].splitlines():
                line = raw.decode("utf-8", "replace").strip()
                if not line.startswith("{"):
                    continue
                try:
                    rec = _json.loads(line)
                except ValueError:
                    continue
                if not (
                    isinstance(rec, dict)
                    and rec.get("event") == "span"
                    and isinstance(rec.get("span"), str)
                    and isinstance(rec.get("dur_s"), (int, float))
                    and isinstance(rec.get("ts"), (int, float))
                ):
                    continue
                b, e = _span_interval(rec)
                g = self._groups.setdefault(_group_key(rec), [b, e, []])
                g[0], g[1] = min(g[0], b), max(g[1], e)
                if rec["span"] in BUSY_SPANS:
                    g[2].append((b, e))
                    if len(g[2]) > self._COMPACT_AT:
                        g[2] = _merge(g[2])
        return self.idle_frac()

    def idle_frac(self) -> Optional[float]:
        wall = busy = 0.0
        for lo, hi, ivs in self._groups.values():
            w = hi - lo
            if w <= 0:
                continue
            wall += w
            busy += min(w, sum(e - b for b, e in _merge(ivs)))
        if wall <= 0:
            return None
        return round(max(0.0, wall - busy) / wall, 4)

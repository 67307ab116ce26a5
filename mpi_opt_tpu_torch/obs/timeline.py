"""``trace --timeline OUT.json``: Chrome trace-event export (port of
``mpi_opt_tpu/obs/timeline.py``, which imports no JAX; copied so the
port imports nothing of the JAX package).

The span stream is already a timeline (every record carries absolute
``ts`` + ``dur_s``); this module renders it in the trace-event format
Perfetto (https://ui.perfetto.dev) and chrome://tracing load natively:

- one PROCESS row per (tenant, rank) group, the grouping the bubble
  analysis judges (ranks are never compared across clocks);
- one THREAD track per emitting thread (``tid``): the main host loop
  and the staging engine's transfer thread render as separate lanes, so
  stage-out overlapping compute is visible as overlap;
- every span is a complete ("X") event whose ``args`` carry the span's
  attrs verbatim (FLOPs, bytes, memory watermarks, launch ordinals...);
  train spans also carry the roofline verdict
  (``peak_tflops``/``mxu_frac``/``bound``) when a platform cap is known
  (``mxu_frac`` is the JAX package's name: on the card, the tensor-core
  share);
- non-span metrics events (trial, oom_backoff, summary...) become
  instant ("i") events on the same rows: the lifecycle markers that
  explain why a gap exists;
- a synthetic "device idle" track per process renders the bubble
  analysis itself: one X event per idle gap, named by its dominant
  cause, with ``idle_gap_s`` in args (``obs/bubbles.py``).

Timestamps are microseconds relative to the earliest record
(``otherData.t0_epoch_s`` keeps the absolute anchor), matching the
trace-event spec. The document is the JAX package's on the same streams
but for ``otherData.generator``, and ``validate_timeline`` checks it;
it is written atomically: a Ctrl-C must not leave a torn half-document
where a dashboard polls. This is the sweep's own span timeline; a
``--profile-dir`` window (``utils/profiling.py``) is the profiler's.
"""

from __future__ import annotations

import json
import os

from mpi_opt_tpu_torch.obs import bubbles

#: record keys that are structure, not span args
_CORE_KEYS = frozenset(
    {"event", "span", "dur_s", "self_s", "ts", "t", "tid", "rank", "tenant"}
)

#: tid of the synthetic per-process idle track (far above real thread
#: ids, which are small allocation ordinals)
IDLE_TID = 10_000


def _us(seconds: float) -> float:
    # clamped at 0: gap boundaries come back from bubbles.analyze
    # rounded to 6 decimals, which can land a sub-microsecond BEFORE
    # the t0 anchor — a negative timestamp would fail the trace-event
    # schema over float dust
    return max(0.0, round(seconds * 1e6, 3))


def _args(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in _CORE_KEYS and v is not None}


def build(streams: dict, peak_tflops=None, attribution=None) -> dict:
    """The trace-event document over ``{label: records}`` streams (the
    same input shape as ``report.attribute``). ``attribution`` is an
    already-built ``attribute()`` result over the SAME streams: its
    staging/roofline sections are reused instead of recomputed — the
    trace CLI computes both anyway, and one analysis cannot drift from
    the other. Only the bubble pass reruns here (with ``include_gaps``:
    the idle track needs the raw gap list the attribution omits)."""
    from mpi_opt_tpu_torch.obs.report import _begin, _is_span

    # deterministic label order (matching report.attribute's merge), so
    # stable sorts downstream break ts ties identically run to run
    merged = [r for label in sorted(streams) for r in streams[label]]
    if not merged:
        return {
            "traceEvents": [],
            "displayTimeUnit": "ms",
            "otherData": {"generator": "mpi_opt_tpu_torch trace --timeline"},
        }
    spans = [r for r in merged if _is_span(r)]
    t0 = min(_begin(r) for r in merged)
    # stable pid per (tenant, rank): sorted so rank 0 renders first
    keys = sorted(
        {bubbles._group_key(r) for r in merged}, key=lambda k: (k[0] or "", k[1])
    )
    pid_of = {key: i + 1 for i, key in enumerate(keys)}
    events: list = []
    for key, pid in pid_of.items():
        tenant, rank = key
        name = f"tenant {tenant} · rank {rank}" if tenant else f"rank {rank}"
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "ts": 0,
                "args": {"name": name},
            }
        )
        events.append(
            {
                "name": "process_sort_index",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "ts": 0,
                "args": {"sort_index": pid},
            }
        )
    # thread names: the staging worker is recognizable by what it emits
    threads: dict = {}
    for r in spans:
        tkey = (pid_of[bubbles._group_key(r)], int(r.get("tid") or 0))
        threads.setdefault(tkey, set()).add(r["span"])
    main_tid = {}
    for (pid, tid), _names in sorted(threads.items()):
        main_tid.setdefault(pid, tid)
    for (pid, tid), names in sorted(threads.items()):
        if "stage_out" in names:
            label = f"staging (tid {tid})"
        elif tid == main_tid[pid]:
            label = f"main (tid {tid})"
        else:
            label = f"tid {tid}"
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "ts": 0,
                "args": {"name": label},
            }
        )
    # roofline verdicts for train-event args: the gap-carrying bubble
    # pass always runs (the idle track needs it); the platform cap is
    # reused from the caller's attribution when given (one resolution,
    # no drift), but the per-launch list is recomputed over THIS
    # function's own span list — zip pairs by sorted-by-ts position, and
    # only sorting the identical list makes ts ties pair exactly
    # (roofline itself is linear-ish and cheap next to analyze)
    bub = bubbles.analyze(spans, include_gaps=True)
    if attribution is not None:
        a_roof = attribution.get("roofline") or {}
        peak, peak_src = a_roof.get("peak_tflops"), a_roof.get("peak_source")
    else:
        peak, peak_src = bubbles.resolve_peak(spans, peak_tflops)
    roof = bubbles.roofline(spans, bub, bubbles.staging_summary(spans), peak, peak_src)
    launch_verdicts = {}
    if roof is not None:
        train = sorted(
            (r for r in spans if r["span"] == "train"), key=lambda r: float(r["ts"])
        )
        for r, entry in zip(train, roof["per_launch"]):
            launch_verdicts[id(r)] = entry
    for r in merged:
        pid = pid_of[bubbles._group_key(r)]
        if _is_span(r):
            args = _args(r)
            verdict = launch_verdicts.get(id(r))
            if verdict is not None and peak:
                args["peak_tflops"] = peak
                args["bound"] = verdict["bound"]
                if verdict["mxu_frac"] is not None:
                    args["mxu_frac"] = verdict["mxu_frac"]
            events.append(
                {
                    "name": r["span"],
                    "cat": "span",
                    "ph": "X",
                    "pid": pid,
                    "tid": int(r.get("tid") or 0),
                    "ts": _us(_begin(r) - t0),
                    "dur": max(0.0, _us(float(r["dur_s"]))),
                    "args": args,
                }
            )
        else:
            events.append(
                {
                    "name": str(r["event"]),
                    "cat": "event",
                    "ph": "i",
                    "s": "p",  # process-scoped instant marker
                    "pid": pid,
                    "tid": int(r.get("tid") or 0),
                    "ts": _us(float(r["ts"]) - t0),
                    "args": _args(r),
                }
            )
    # the bubble analysis as its own track: one X event per idle gap
    if bub is not None:
        for label, entry in bub["per_rank"].items():
            pid = pid_of[(entry["tenant"], entry["rank"])]
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": IDLE_TID,
                    "ts": 0,
                    "args": {"name": "device idle"},
                }
            )
            for gap in entry.get("gap_list", ()):
                events.append(
                    {
                        "name": f"idle:{gap['cause']}",
                        "cat": "bubble",
                        "ph": "X",
                        "pid": pid,
                        "tid": IDLE_TID,
                        "ts": _us(gap["begin_s"] - t0),
                        "dur": max(0.0, _us(gap["dur_s"])),
                        "args": {"idle_gap_s": gap["dur_s"], "cause": gap["cause"]},
                    }
                )
    other = {
        "generator": "mpi_opt_tpu_torch trace --timeline",
        "t0_epoch_s": round(t0, 6),
        "streams": sorted(streams),
    }
    if peak:
        other["peak_tflops"] = peak
        other["peak_source"] = peak_src
    return {"traceEvents": events, "displayTimeUnit": "ms", "otherData": other}


def write_timeline(streams: dict, path: str, peak_tflops=None, attribution=None) -> int:
    """Build and atomically write the timeline document; returns the
    event count (the CLI's confirmation line)."""
    doc = build(streams, peak_tflops=peak_tflops, attribution=attribution)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):  # failed mid-write: no orphan debris
            os.unlink(tmp)
    return len(doc["traceEvents"])


def validate_timeline(doc) -> list:
    """Problems with a trace-event document (empty = loads in Perfetto
    as far as the spec's required fields go). The CLI's callers and the
    tests both run THIS, so the export and its gate cannot drift
    apart."""
    problems = []
    if not isinstance(doc, dict):
        return [f"document must be an object, not {type(doc).__name__}"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["missing/non-list 'traceEvents'"]
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        for k in ("name", "ph", "pid", "tid", "ts"):
            if k not in ev:
                problems.append(f"event {i}: missing {k!r}")
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            problems.append(f"event {i}: unexpected phase {ph!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: X event needs dur >= 0, got {dur!r}")
        if ph == "i" and ev.get("s") not in ("g", "p", "t"):
            problems.append(f"event {i}: instant scope {ev.get('s')!r}")
        if not isinstance(ev.get("ts"), (int, float)) or ev.get("ts") < 0:
            problems.append(f"event {i}: ts must be a number >= 0")
    pids = {ev.get("pid") for ev in evs if isinstance(ev, dict) and ev.get("ph") != "M"}
    named = {
        ev.get("pid")
        for ev in evs
        if isinstance(ev, dict)
        and ev.get("ph") == "M"
        and ev.get("name") == "process_name"
    }
    for pid in sorted(p for p in pids - named if p is not None):
        problems.append(f"pid {pid}: no process_name metadata")
    return problems

"""``python -m mpi_opt_tpu_torch trace FILE|DIR``: phase-time
attribution over metrics streams (port of ``mpi_opt_tpu/obs/report.py``,
which imports no JAX; copied so the port imports nothing of the JAX
package).

Input is one or more JSONL metrics streams (``--metrics-file`` output
of a ``--trace`` run; a directory is walked for streams). Records merge
by absolute ``ts`` and the span records (``obs/trace.py``) are
attributed:

- per-phase wall: count, total (inclusive) and self (exclusive)
  seconds, percent of wall, p50/p95 span duration, per-span self
  statistics and a device-memory column where spans carried
  ``obs/memory.py`` attrs;
- the compile table: the port compiles nothing through XLA and emits
  no ``compile`` span, so its counts are zero;
- achieved TF/s from the ``flops`` of ``train`` spans
  (``train/common.segment_flops_hint``);
- time to first trial, coverage (attributed self seconds over wall,
  above 100% when the staging worker overlaps compute), and the
  ``obs/bubbles.py`` sections: device-idle bubbles by cause, staging
  overlap, and the roofline verdict.

``--json`` prints one object (the bench embeds ``bench_attribution``);
text mode renders the table. ``--timeline OUT.json`` also exports the
merged streams as Chrome trace-event JSON (``obs/timeline.py``);
``--diff BASE NEW [--gate TOL.json]`` compares two attributions and
gates them (``obs/diff.py``).
"""

from __future__ import annotations

import json
import math
import os
import sys
from typing import Optional

_MAX_SNIFF_LINES = 20


def sniff_stream(path: str) -> bool:
    """Is ``path`` a metrics stream? One JSON object per line carrying
    an ``event`` key (a ledger's lines carry ``kind`` instead — the
    trace CLI must not ingest journals as phase data). Mixed files
    (rank logs with non-JSON lines around the stream) still sniff true
    if any early line matches."""
    try:
        with open(path, "r", errors="replace") as f:
            for _ in range(_MAX_SNIFF_LINES):
                line = f.readline()
                if not line:
                    break
                line = line.strip()
                if not line or not line.startswith("{"):
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict) and "event" in rec:
                    return True
    except OSError:
        return False
    return False


def discover_streams(directory: str) -> list:
    """Metrics streams under ``directory``: ``.jsonl``/``.out``/``.log``
    files that sniff as streams. A ``run.log`` beside a sniffing
    ``metrics.jsonl`` holds the stdout copy of the same stream and is
    skipped, so no span counts twice."""
    found = []
    for root, _dirs, files in os.walk(directory):
        has_metrics = "metrics.jsonl" in files and sniff_stream(
            os.path.join(root, "metrics.jsonl")
        )
        for f in files:
            if not f.endswith((".jsonl", ".out", ".log")):
                continue
            if f == "run.log" and has_metrics:
                continue
            path = os.path.join(root, f)
            if sniff_stream(path):
                found.append(path)
    return sorted(found)


def load_stream(path: str) -> list:
    """Every parseable event record in ``path`` (non-JSON lines and
    non-event JSON — summaries' sibling shapes, stray prints — are
    skipped: a rank log legitimately mixes streams)."""
    records = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or not line.startswith("{"):
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and "event" in rec and "ts" in rec:
                records.append(rec)
    return records


def _percentile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _is_span(rec: dict) -> bool:
    return (
        rec.get("event") == "span"
        and isinstance(rec.get("span"), str)
        and isinstance(rec.get("dur_s"), (int, float))
    )


def _begin(rec: dict) -> float:
    ts = float(rec["ts"])
    return ts - float(rec["dur_s"]) if _is_span(rec) else ts


def _phase_table(spans: list, wall: float) -> dict:
    phases: dict = {}
    for r in spans:
        phases.setdefault(r["span"], []).append(r)
    out = {}
    for name in sorted(phases):
        group = phases[name]
        durs = sorted(float(r["dur_s"]) for r in group)
        selfs = sorted(float(r.get("self_s", r["dur_s"])) for r in group)
        self_s = sum(selfs)
        n = len(group)
        mean_self = self_s / n
        # per-span SELF spread, the noise a later diff judges
        # significance against (self, not dur — a cold compile nested in
        # launch 1's train span must not look like train-phase jitter)
        sd_self = (
            math.sqrt(sum((v - mean_self) ** 2 for v in selfs) / (n - 1))
            if n >= 2
            else None
        )
        # per-phase device-memory watermark (obs/memory.py span attrs):
        # max over the phase's spans; None when untracked (CPU without
        # accounting)
        mem_peak = [r["mem_peak_bytes"] for r in group if isinstance(r.get("mem_peak_bytes"), (int, float))]
        mem_steady = [r["mem_bytes"] for r in group if isinstance(r.get("mem_bytes"), (int, float))]
        out[name] = {
            "count": n,
            "total_s": round(sum(durs), 4),
            "self_s": round(self_s, 4),
            "wall_pct": round(100.0 * self_s / wall, 2) if wall > 0 else None,
            "p50_s": round(_percentile(durs, 0.50), 4),
            "p95_s": round(_percentile(durs, 0.95), 4),
            "mean_self_s": round(mean_self, 6),
            "sd_self_s": None if sd_self is None else round(sd_self, 6),
            "p50_self_s": round(_percentile(selfs, 0.50), 6),
            "p95_self_s": round(_percentile(selfs, 0.95), 6),
            "mem_peak_bytes": max(mem_peak) if mem_peak else None,
            "mem_bytes": max(mem_steady) if mem_steady else None,
        }
    return out


def _memory_summary(spans: list) -> Optional[dict]:
    """The run-level device-memory watermark: the max over every span's
    memory attrs (None when nothing carried them)."""
    peaks = [r["mem_peak_bytes"] for r in spans if isinstance(r.get("mem_peak_bytes"), (int, float))]
    if not peaks:
        return None
    steady = [r["mem_bytes"] for r in spans if isinstance(r.get("mem_bytes"), (int, float))]
    srcs = sorted({r["mem_src"] for r in spans if isinstance(r.get("mem_src"), str)})
    return {
        "peak_bytes": int(max(peaks)),
        "bytes_in_use": int(max(steady)) if steady else None,
        # stable string|null schema even when merged streams mixed
        # accountings
        "source": "+".join(srcs) if srcs else None,
    }


def _train_throughput(spans: list) -> Optional[dict]:
    """Achieved TF/s from flops-carrying train spans (None when no span
    carried a FLOP count — e.g. the backend's cost analysis was
    unavailable)."""
    train = [
        r
        for r in spans
        if r["span"] == "train" and isinstance(r.get("flops"), (int, float))
    ]
    if not train:
        return None
    per_launch = []
    for r in sorted(train, key=lambda r: (r.get("ts", 0.0))):
        d = float(r["dur_s"])
        per_launch.append(
            {
                "launch": r.get("launch"),
                "dur_s": round(d, 4),
                "flops": float(r["flops"]),
                "tflops_per_sec": round(float(r["flops"]) / d / 1e12, 4)
                if d > 0
                else None,
            }
        )
    flops = sum(e["flops"] for e in per_launch)
    dur = sum(e["dur_s"] for e in per_launch)
    return {
        "flops": flops,
        "train_s": round(dur, 4),
        "tflops_per_sec": round(flops / dur / 1e12, 4) if dur > 0 else None,
        "per_launch": per_launch,
    }


def _time_to_first_trial(records: list, t_start: float) -> Optional[float]:
    """Seconds from the stream's first record to the first completed
    trial evidence: the end of the first ``train`` span (a fused launch
    completes population x generations member-trials) or the first
    driver ``batch`` event."""
    marks = [
        float(r["ts"])
        for r in records
        if (_is_span(r) and r["span"] == "train") or r.get("event") == "batch"
    ]
    if not marks:
        return None
    return round(min(marks) - t_start, 4)


def _stream_summary(label: str, records: list) -> Optional[dict]:
    if not records:
        return None
    t_start = min(_begin(r) for r in records)
    t_end = max(float(r["ts"]) for r in records)
    wall = max(0.0, t_end - t_start)
    spans = [r for r in records if _is_span(r)]
    self_total = sum(float(r.get("self_s", r["dur_s"])) for r in spans)
    ranks = sorted({r["rank"] for r in spans if "rank" in r})
    tenants = sorted({r["tenant"] for r in spans if "tenant" in r})
    return {
        "label": label,
        "records": len(records),
        "span_records": len(spans),
        "wall_s": round(wall, 4),
        "t_start": round(t_start, 4),
        "t_end": round(t_end, 4),
        "rank": ranks[0] if len(ranks) == 1 else (ranks or None),
        "tenant": tenants[0] if len(tenants) == 1 else (tenants or None),
        "coverage": round(self_total / wall, 4) if wall > 0 else None,
        "time_to_first_trial_s": _time_to_first_trial(records, t_start),
    }


def attribute(streams: dict, peak_tflops=None) -> dict:
    """The full attribution over ``{label: records}`` streams, merged by
    absolute ``ts``. Returns the ``--json`` object. ``peak_tflops``
    overrides the roofline's platform cap (default: the calibration
    table keyed by the setup span's recorded device kind)."""
    from mpi_opt_tpu_torch.obs import bubbles as _bubbles

    merged = []
    stream_summaries = []
    for label in sorted(streams):
        records = streams[label]
        s = _stream_summary(label, records)
        if s is not None:
            stream_summaries.append(s)
        merged.extend(records)
    merged.sort(key=lambda r: float(r["ts"]))
    spans = [r for r in merged if _is_span(r)]
    if merged:
        t_start = min(_begin(r) for r in merged)
        t_end = max(float(r["ts"]) for r in merged)
        wall = max(0.0, t_end - t_start)
    else:
        wall = 0.0
    self_total = sum(float(r.get("self_s", r["dur_s"])) for r in spans)
    compile_spans = [r for r in spans if r["span"] == "compile"]
    compile_rep = {}
    for kind in ("cold", "persistent"):
        group = [r for r in compile_spans if r.get("cache") == kind]
        compile_rep[kind] = {
            "count": len(group),
            "total_s": round(sum(float(r["dur_s"]) for r in group), 4),
        }
    tenants = sorted({r["tenant"] for r in spans if "tenant" in r})
    per_tenant = None
    if tenants:
        per_tenant = {
            t: _phase_table([r for r in spans if r.get("tenant") == t], wall)
            for t in tenants
        }
    ttft = [
        (s["label"], s["time_to_first_trial_s"])
        for s in stream_summaries
        if s["time_to_first_trial_s"] is not None
    ]
    # intra-phase attribution (obs/bubbles.py): idle gaps, staging
    # overlap, and the roofline verdict the diff gate budgets
    bubbles_rep = _bubbles.analyze(spans)
    staging_rep = _bubbles.staging_summary(spans)
    peak, peak_src = _bubbles.resolve_peak(spans, peak_tflops)
    roofline_rep = _bubbles.roofline(spans, bubbles_rep, staging_rep, peak, peak_src)
    return {
        "streams": stream_summaries,
        "records": len(merged),
        "span_records": len(spans),
        "wall_s": round(wall, 4),
        "attributed_s": round(self_total, 4),
        "coverage": round(self_total / wall, 4) if wall > 0 else None,
        "phases": _phase_table(spans, wall),
        "compile": compile_rep,
        "train": _train_throughput(spans),
        "time_to_first_trial_s": min((v for _l, v in ttft), default=None),
        "memory": _memory_summary(spans),
        "bubbles": bubbles_rep,
        "staging": staging_rep,
        "roofline": roofline_rep,
        "tenants": per_tenant,
    }


def bench_attribution(path: str, peak_tflops=None) -> dict:
    """The compact attribution subset the bench embeds beside its rate
    (``bench.py``). ``peak_tflops`` feeds the roofline; without it the
    calibration table applies."""
    rep = attribute({os.path.basename(path): load_stream(path)}, peak_tflops=peak_tflops)
    return {
        k: rep.get(k)
        for k in (
            "wall_s",
            "coverage",
            "phases",
            "compile",
            "train",
            "time_to_first_trial_s",
            "memory",
            "bubbles",
            "staging",
            "roofline",
        )
    }


def _render_text(rep: dict) -> str:
    lines = [
        f"trace: {len(rep['streams'])} stream(s), {rep['records']} records "
        f"({rep['span_records']} spans), wall {rep['wall_s']}s"
        + (
            f", {round(100.0 * rep['coverage'], 1)}% attributed"
            if rep["coverage"] is not None
            else ""
        )
    ]
    if rep["phases"]:
        # memory column only when some phase carried a watermark (an
        # untraced-memory stream keeps the narrow historical table)
        has_mem = any(p.get("mem_peak_bytes") for p in rep["phases"].values())
        header = (
            f"  {'phase':<12} {'count':>6} {'total s':>9} {'self s':>9} "
            f"{'wall %':>7} {'p50 s':>8} {'p95 s':>8}"
        )
        if has_mem:
            header += f" {'mem MiB':>8}"
        lines.append(header)
        for name, p in sorted(
            rep["phases"].items(), key=lambda kv: -kv[1]["self_s"]
        ):
            pct = "-" if p["wall_pct"] is None else f"{p['wall_pct']:.1f}"
            row = (
                f"  {name:<12} {p['count']:>6} {p['total_s']:>9.3f} "
                f"{p['self_s']:>9.3f} {pct:>7} {p['p50_s']:>8.4f} {p['p95_s']:>8.4f}"
            )
            if has_mem:
                mem = p.get("mem_peak_bytes")
                row += f" {'-' if mem is None else format(mem / (1 << 20), '.1f'):>8}"
            lines.append(row)
    c = rep["compile"]
    if c.get("cold", {}).get("count") or c.get("persistent", {}).get("count"):
        lines.append(
            f"  compile: {c['cold']['count']} cold ({c['cold']['total_s']}s), "
            f"{c['persistent']['count']} persistent-cache hits "
            f"({c['persistent']['total_s']}s); train launches without a "
            "compile span hit the in-process jit cache"
        )
    t = rep["train"]
    roof = rep.get("roofline")
    # launch ordinals repeat across ranks/tenants in a merged stream —
    # annotate a throughput row only when its ordinal maps to exactly
    # ONE roofline entry, else the row would wear an arbitrary rank's
    # verdict (the --json per_launch list stays complete either way)
    launch_bound: dict = {}
    if roof is not None:
        for e in roof["per_launch"]:
            if e["launch"] is not None:
                launch_bound.setdefault(e["launch"], []).append(e)
    launch_bound = {k: v[0] for k, v in launch_bound.items() if len(v) == 1}
    if t is not None and t["tflops_per_sec"] is not None:
        lines.append(
            f"  train: {t['tflops_per_sec']} TF/s achieved "
            f"({t['flops']:.3e} FLOPs over {t['train_s']}s)"
        )
        for e in t["per_launch"]:
            if e["launch"] is not None:
                row = (
                    f"    launch {e['launch']}: {e['dur_s']}s, "
                    f"{e['tflops_per_sec']} TF/s"
                )
                v = launch_bound.get(e["launch"])
                if v is not None:
                    row += f", {v['bound']}"
                    if v["mxu_frac"] is not None:
                        row += f" ({round(100.0 * v['mxu_frac'], 1)}% of cap)"
                lines.append(row)
    stg = rep.get("staging")
    if stg is not None:
        pct = (
            "-"
            if stg["overlap_frac"] is None
            else f"{round(100.0 * stg['overlap_frac'], 1)}%"
        )
        lines.append(
            f"  staging: {stg['staged_bytes'] / 1e9:.3f} GB moved, transfer "
            f"{stg['transfer_s']}s, hidden {stg['overlap_s']}s ({pct} overlap), "
            f"wait {stg['wait_s']}s over {stg['drains']} drain(s)"
        )
    bub = rep.get("bubbles")
    if bub is not None and bub["wall_s"]:
        pct = (
            "-"
            if bub["idle_frac"] is None
            else f"{round(100.0 * bub['idle_frac'], 1)}%"
        )
        lines.append(
            f"  bubbles: {bub['idle_s']}s device-idle ({pct} of wall) over "
            f"{bub['gaps']} gap(s), largest {bub['largest_gap_s']}s"
        )
        if bub["by_cause"]:
            causes = ", ".join(
                f"{c} {v}s"
                for c, v in sorted(bub["by_cause"].items(), key=lambda kv: -kv[1])
            )
            lines.append(f"    idle by cause: {causes}")
    if roof is not None:
        if roof["mxu_frac"] is not None:
            detail = (
                f"{roof['tflops_per_sec']} TF/s = "
                f"{round(100.0 * roof['mxu_frac'], 1)}% of "
                f"{roof['peak_tflops']} TF/s cap [{roof['peak_source']}]"
            )
        elif roof["tflops_per_sec"] is not None:
            detail = f"{roof['tflops_per_sec']} TF/s achieved, no platform cap (--peak-tflops)"
        else:
            detail = "no traced FLOPs"
        lines.append(f"  roofline: {roof['bound']} ({detail})")
    if rep["time_to_first_trial_s"] is not None:
        lines.append(f"  time to first trial: {rep['time_to_first_trial_s']}s")
    mem = rep.get("memory")
    if mem is not None:
        steady = mem.get("bytes_in_use")
        lines.append(
            f"  device memory: peak {mem['peak_bytes'] / (1 << 20):.1f} MiB"
            + (
                f", steady {steady / (1 << 20):.1f} MiB"
                if steady is not None
                else ""
            )
            + f" ({mem['source']})"
        )
    if rep["tenants"]:
        for name, table in sorted(rep["tenants"].items()):
            busy = round(sum(p["self_s"] for p in table.values()), 3)
            top = sorted(table.items(), key=lambda kv: -kv[1]["self_s"])[:3]
            top_s = ", ".join(f"{n} {p['self_s']}s" for n, p in top)
            lines.append(f"  tenant {name}: {busy}s attributed ({top_s})")
    for s in rep["streams"]:
        if len(rep["streams"]) > 1:
            lines.append(
                f"  stream {s['label']}: wall {s['wall_s']}s, "
                f"{s['span_records']} spans"
                + (
                    f", first trial at {s['time_to_first_trial_s']}s"
                    if s["time_to_first_trial_s"] is not None
                    else ""
                )
            )
    return "\n".join(lines)


def trace_main(argv=None) -> int:
    """The ``python -m mpi_opt_tpu_torch trace`` subcommand."""
    import argparse

    p = argparse.ArgumentParser(
        prog="mpi_opt_tpu_torch trace",
        description="phase-time attribution over JSONL metrics streams",
    )
    p.add_argument(
        "targets",
        nargs="+",
        metavar="FILE|DIR",
        help="metrics stream(s) (--metrics-file output of a --trace run), or "
        "directories to discover streams under. With --diff: exactly two targets, "
        "each a stream/dir, a `trace --json` attribution file, or a bench record "
        "with an embedded trace",
    )
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument(
        "--timeline",
        default=None,
        metavar="OUT.json",
        help="also export the merged streams as Chrome trace-event JSON (load in "
        "https://ui.perfetto.dev or chrome://tracing): per-rank process rows, "
        "per-thread tracks, span attrs as args, plus a 'device idle' track "
        "rendering the bubble analysis",
    )
    p.add_argument(
        "--peak-tflops",
        type=float,
        default=None,
        help="platform matmul cap for the roofline verdict (TF/s); default: "
        "the obs/bubbles.py table keyed by the card the setup span recorded",
    )
    p.add_argument(
        "--diff",
        action="store_true",
        help="compare two attributions (BASE NEW): per-phase deltas judged against "
        "each phase's own measured jitter, achieved-TF/s, time-to-first-trial and "
        "device-memory watermark deltas (obs/diff.py)",
    )
    p.add_argument(
        "--gate",
        default=None,
        metavar="TOL.json",
        help="with --diff: apply per-phase tolerance budgets from this file and "
        "exit 1 on regression (the JAX package's file format; README)",
    )
    args = p.parse_args(argv)
    if args.gate and not args.diff:
        p.error("--gate requires --diff")
    if args.timeline and args.diff:
        p.error("--timeline renders ONE run's streams; it cannot combine "
                "with --diff (export each side separately)")
    if args.peak_tflops is not None and args.peak_tflops <= 0:
        p.error(f"--peak-tflops must be > 0, got {args.peak_tflops}")
    if args.diff:
        from mpi_opt_tpu_torch.obs.diff import diff_main

        return diff_main(args.targets, json_out=args.json, gate_path=args.gate,
                         error=p.error, peak_tflops=args.peak_tflops)

    streams: dict = {}

    def add(label, path):
        # labels stay unique: two directories can both hold a
        # "metrics.jsonl"
        if label in streams:
            label = path
        streams[label] = load_stream(path)

    rc = 0
    for target in args.targets:
        if os.path.isdir(target):
            hits = discover_streams(target)
            if not hits:
                print(f"{target}: no metrics streams found", file=sys.stderr)
                rc = 1
            for path in hits:
                add(os.path.relpath(path, target), path)
        else:
            try:
                add(target, target)
            except OSError as e:
                print(f"{target}: {e}", file=sys.stderr)
                rc = 1
    if not any(streams.values()):
        if streams:
            print("no event records found in the given streams", file=sys.stderr)
            rc = 1
        if args.json:
            print(json.dumps({"streams": [], "records": 0, "phases": {}}))
        return rc
    rep = attribute(streams, peak_tflops=args.peak_tflops)
    if args.timeline:
        from mpi_opt_tpu_torch.obs.timeline import write_timeline

        try:
            n = write_timeline(streams, args.timeline, peak_tflops=args.peak_tflops,
                               attribution=rep)
        except OSError as e:
            print(f"--timeline {args.timeline}: {e}", file=sys.stderr)
            rc = 1
        else:
            # stderr: --json's stdout stays one machine-parseable object
            print(f"timeline: {n} events -> {args.timeline}", file=sys.stderr)
    if args.json:
        print(json.dumps(rep))
    else:
        print(_render_text(rep))
    return rc

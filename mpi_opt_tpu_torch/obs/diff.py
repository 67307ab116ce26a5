"""``trace --diff``: make two phase attributions comparable, with a
gate (port of ``mpi_opt_tpu/obs/diff.py``, which imports no JAX; copied
so the port imports nothing of the JAX package).

    python -m mpi_opt_tpu_torch trace --diff BASE NEW [--json] [--gate TOL.json]

``BASE``/``NEW`` each load as an attribution from any of:

- a JSONL **metrics stream** (``--metrics-file`` output of a ``--trace``
  run) or a **directory** of streams (every stream merges, as in
  ``trace DIR``);
- a ``trace --json`` **attribution file**;
- a **bench record** (``python -m mpi_opt_tpu_torch.bench`` stdout line
  saved to a file, a driver wrapper with the record under ``parsed``,
  or a list of records) carrying an embedded ``trace`` attribution.

Phases align by span name (``obs/trace.py`` emits only the JAX
package's registered names), so a diff never pairs unrelated work; a
span present on one side only is reported asymmetrically
(``only_in_new`` is usually new instrumentation, ``only_in_base`` lost
coverage) and never silently dropped.

**The noise model.** A delta is *significant* only when it clears the
phase's own measured jitter, judged on per-span SELF seconds (exclusive
time: a cuDNN autotune nested inside launch 1's train span would
otherwise make every first-launch diff scream):

- with >= 2 spans per side and recorded spread: a z-test on mean self
  time (``z * sqrt(sd_b^2/n_b + sd_n^2/n_n) / mean_b``, z = 3);
- attributions without self-stats (older embeds) fall back to the
  duration percentiles' dispersion ``(p95 - p50)/p50``;
- single-span phases get a coarse ``single_sample_rel`` floor (0.5):
  one sample carries no spread, so only a gross change may flag;
- everything is floored at ``min_rel`` (10%) relative and
  ``min_abs_s`` (2 ms) absolute: a 3% jitter never pages anyone, a
  seeded 2x train-phase slowdown always does.

**The gate** (``--gate TOL.json``) applies per-phase tolerance budgets
on top of significance and exits 1 on regression; ``bench_gate`` runs
the same machinery over whole sets of bench records. Tolerance file keys
(all optional; the JAX package's, so one file serves both packages)::

    {
      "default": 0.25,                  # max rel p50-self increase, any phase
      "phases": {"train": 0.10},        # per-phase overrides
      "ignore": ["journal"],            # phases never gated
      "require_significant": true,      # gate only noise-cleared deltas
      "max_cold_compile_increase": 0,   # extra cold compiles allowed
      "ttft_max_rel_increase": 0.5,     # time-to-first-trial budget
      "tflops_max_rel_decrease": 0.2,   # achieved-TF/s budget
      "wall_max_rel_increase": 0.25,    # whole-run wall budget
      "memory_max_rel_increase": 0.25,  # device-memory watermark budget
      "value_max_rel_regression": 0.25, # bench headline value (bench_gate)
      "idle_frac": 0.25,                # max device-idle fraction (NEW side)
      "min_overlap": 0.6,               # min staging overlap fraction (NEW side)
      "min_mxu_frac": 0.15              # min achieved/cap fraction (NEW side)
    }

The last three budget the NEW run's ABSOLUTE intra-phase numbers
(``obs/bubbles.py``), not deltas: an idle-fraction ceiling, a
staging-overlap floor, and a utilization floor. ``mxu_frac`` keeps the
JAX package's name; on the card it is achieved TF/s over the tensor
cores' bf16 peak. ``idle_frac`` on an attribution without bubble
analysis is a violation (lost coverage where someone declared they
care); ``min_overlap`` skips runs that staged nothing (a resident run
has no transfer to hide); ``min_mxu_frac`` is a violation when achieved
TF/s or the platform cap is unmeasured (pass ``--peak-tflops`` or run on
a calibrated card). The port compiles nothing through XLA, so its
compile counts are zero on both sides.

Unknown keys are refused (a typo'd budget must not silently gate
nothing). The ``--json`` output is a stable schema, the JAX package's.
"""

from __future__ import annotations

import json
import math
import os
import sys
from typing import Optional

DIFF_SCHEMA_VERSION = 1

#: bench record schema: version 2 adds ``schema_version`` itself, the
#: embedded ``trace`` attribution (may be null under --no-trace) and the
#: ``device_memory`` watermark. Records WITHOUT a schema_version are the
#: legacy shape (metric/value/unit only) and stay loadable: the port's
#: bench record is one of them, and the recorded history must not
#: become unreadable.
BENCH_SCHEMA_VERSION = 2

_TOL_KEYS = frozenset(
    {
        "default",
        "phases",
        "ignore",
        "require_significant",
        "max_cold_compile_increase",
        "ttft_max_rel_increase",
        "tflops_max_rel_decrease",
        "wall_max_rel_increase",
        "memory_max_rel_increase",
        "value_max_rel_regression",
        "idle_frac",
        "min_overlap",
        "min_mxu_frac",
    }
)

# noise-model defaults (see module docstring)
MIN_REL = 0.10
MIN_ABS_S = 0.002
Z_SCORE = 3.0
SINGLE_SAMPLE_REL = 0.5


# -- loading --------------------------------------------------------------


def _embedded_attribution(doc):
    """The attribution dict inside a parsed JSON document, or None.
    Accepts: an attribution itself (has ``phases``), a bench record
    (``trace`` key), a driver wrapper (``parsed``), or a list of
    records (exactly one record may carry a trace — with
    several, the caller must extract one; ambiguity is an error, not a
    guess)."""
    if isinstance(doc, list):
        hits = [d for d in doc if isinstance(d, dict) and isinstance(d.get("trace"), dict)]
        if len(hits) == 1:
            return _embedded_attribution(hits[0])
        if len(hits) > 1:
            raise ValueError(
                f"record list holds {len(hits)} embedded trace attributions "
                f"(configs {[h.get('config') for h in hits]}); extract one "
                "record, or gate the whole set with bench_gate"
            )
        return None
    if not isinstance(doc, dict):
        return None
    if isinstance(doc.get("phases"), dict):
        return doc
    if isinstance(doc.get("trace"), dict):
        return doc["trace"]
    if isinstance(doc.get("parsed"), (dict, list)):
        return _embedded_attribution(doc["parsed"])
    return None


def load_attribution(target: str, peak_tflops=None) -> dict:
    """Attribution for ``target`` (stream file / stream dir / trace
    --json file / bench record file). Raises ValueError/OSError with an
    actionable message. ``peak_tflops`` feeds the roofline when the
    target is a raw stream/dir; embedded attributions keep the cap they
    were built with."""
    from mpi_opt_tpu_torch.obs.report import attribute, discover_streams, load_stream

    if os.path.isdir(target):
        hits = discover_streams(target)
        if not hits:
            raise ValueError(f"{target}: no metrics streams found")
        return attribute(
            {os.path.relpath(p, target): load_stream(p) for p in hits},
            peak_tflops=peak_tflops,
        )
    # stream-vs-document sniff on the FIRST line only: a metrics stream
    # is one complete JSON event object per line, so line 1 decides the
    # common case without reading a (possibly large, multi-rank) stream
    # into one string. Only the ambiguous shapes — a multi-line JSON
    # document, or a rank log with non-JSON preamble lines — pay a
    # whole-file parse attempt before falling back to the stream loader.
    doc = None
    with open(target, "r", errors="replace") as f:
        first = f.readline()
        try:
            head = json.loads(first)
        except json.JSONDecodeError:
            head = None
        if head is not None and not (isinstance(head, dict) and "event" in head):
            # line 1 is a JSON document (bench record line). If MORE
            # JSON lines follow (a multi-record bench stdout saved to a
            # file: one record per line), collect them ALL and let the list rule
            # decide — silently diffing only line 1 of a multi-record
            # file would report one config as if it covered the set
            # ("ambiguity is an error, not a guess")
            rest = []
            jsonl = True
            for line in f:
                if not line.strip():
                    continue
                try:
                    rest.append(json.loads(line))
                except json.JSONDecodeError:
                    jsonl = False
                    break
            doc = [head] + rest if (rest and jsonl) else head
        elif head is None:
            f.seek(0)
            try:
                doc = json.loads(f.read())  # pretty-printed document?
            except json.JSONDecodeError:
                doc = None  # mixed rank log: the stream loader's case
    if doc is not None and not (isinstance(doc, dict) and "event" in doc):
        rep = _embedded_attribution(doc)
        if rep is None:
            raise ValueError(
                f"{target}: JSON document carries no trace attribution "
                "(no 'phases'/'trace' — a record measured untraced "
                "cannot be diffed)"
            )
        return rep
    records = load_stream(target)
    if not records:
        raise ValueError(f"{target}: no event records (not a metrics stream?)")
    return attribute({os.path.basename(target): records}, peak_tflops=peak_tflops)


# -- the noise model ------------------------------------------------------


def _metric_key(base: dict, new: dict) -> str:
    """The per-span duration this diff compares — chosen JOINTLY:
    median SELF seconds only when BOTH sides carry it, else
    median inclusive duration for both. Falling back per side would
    compare exclusive seconds against inclusive ones and invent a
    regression out of metric mixing whenever a new stream is diffed
    against a legacy embed."""
    if base.get("p50_self_s") is not None and new.get("p50_self_s") is not None:
        return "p50_self_s"
    return "p50_s"


def _noise_rel(base: dict, new: dict) -> float:
    """The phase's own measured jitter as a relative band; deltas inside
    it are noise by construction."""
    n_b, n_n = int(base.get("count") or 0), int(new.get("count") or 0)
    sd_b, sd_n = base.get("sd_self_s"), new.get("sd_self_s")
    mean_b = base.get("mean_self_s")
    if (
        min(n_b, n_n) >= 2
        and sd_b is not None
        and sd_n is not None
        and mean_b
    ):
        se = math.sqrt(sd_b**2 / n_b + sd_n**2 / n_n)
        return max(MIN_REL, Z_SCORE * se / mean_b)
    # legacy attributions: dispersion from the duration percentiles
    disp = 0.0
    for p in (base, new):
        p50, p95 = p.get("p50_s") or 0.0, p.get("p95_s") or 0.0
        if p50 > 0:
            disp = max(disp, (p95 - p50) / p50)
    if min(n_b, n_n) <= 1:
        disp = max(disp, SINGLE_SAMPLE_REL)
    return max(MIN_REL, disp)


def _rel(base_v, new_v) -> Optional[float]:
    if base_v is None or new_v is None or base_v == 0:
        return None
    return (new_v - base_v) / abs(base_v)


def _diff_phase(base: dict, new: dict) -> dict:
    metric = _metric_key(base, new)
    b_m, n_m = base.get(metric), new.get(metric)
    delta = None if (b_m is None or n_m is None) else n_m - b_m
    rel = _rel(b_m, n_m)
    noise = _noise_rel(base, new)
    significant = (
        rel is not None
        and delta is not None
        and abs(delta) > MIN_ABS_S
        and abs(rel) > noise
    )
    keep = (
        "count",
        "total_s",
        "self_s",
        "p50_s",
        "p95_s",
        "mean_self_s",
        "sd_self_s",
        "p50_self_s",
        "mem_peak_bytes",
    )
    out = {
        "base": {k: base.get(k) for k in keep},
        "new": {k: new.get(k) for k in keep},
        "delta_total_s": round(float(new.get("total_s", 0)) - float(base.get("total_s", 0)), 4),
        "delta_self_s": round(float(new.get("self_s", 0)) - float(base.get("self_s", 0)), 4),
        "delta_p50_s": None
        if base.get("p50_s") is None or new.get("p50_s") is None
        else round(new["p50_s"] - base["p50_s"], 4),
        "delta_p95_s": None
        if base.get("p95_s") is None or new.get("p95_s") is None
        else round(new["p95_s"] - base["p95_s"], 4),
        "metric": metric,
        "base_metric_s": b_m,
        "new_metric_s": n_m,
        "delta_metric_s": None if delta is None else round(delta, 4),
        "rel": None if rel is None else round(rel, 4),
        "noise_rel": round(noise, 4),
        "significant": significant,
        "direction": (
            "flat"
            if not significant
            else ("regression" if delta > 0 else "improvement")
        ),
    }
    return out


# -- the diff -------------------------------------------------------------


def _only(phases: dict, names) -> list:
    return [
        {
            "span": n,
            "count": phases[n].get("count"),
            "total_s": phases[n].get("total_s"),
        }
        for n in sorted(names)
    ]


def diff_attributions(
    base: dict, new: dict, base_label: str = "base", new_label: str = "new"
) -> dict:
    """The full diff report over two attribution dicts (the ``--json``
    object, minus the ``gate`` section ``apply_gate`` adds)."""
    b_ph, n_ph = base.get("phases") or {}, new.get("phases") or {}
    shared = sorted(set(b_ph) & set(n_ph))
    phases = {name: _diff_phase(b_ph[name], n_ph[name]) for name in shared}
    compile_rep = {}
    for kind in ("cold", "persistent"):
        b = (base.get("compile") or {}).get(kind) or {}
        n = (new.get("compile") or {}).get(kind) or {}
        compile_rep[kind] = {
            "base_count": int(b.get("count") or 0),
            "new_count": int(n.get("count") or 0),
            "delta_count": int(n.get("count") or 0) - int(b.get("count") or 0),
            "base_total_s": float(b.get("total_s") or 0.0),
            "new_total_s": float(n.get("total_s") or 0.0),
            "delta_total_s": round(
                float(n.get("total_s") or 0.0) - float(b.get("total_s") or 0.0), 4
            ),
        }
    b_tr, n_tr = base.get("train"), new.get("train")
    train = None
    if b_tr and n_tr and b_tr.get("tflops_per_sec") and n_tr.get("tflops_per_sec"):
        train = {
            "base_tflops_per_sec": b_tr["tflops_per_sec"],
            "new_tflops_per_sec": n_tr["tflops_per_sec"],
            "rel": round(_rel(b_tr["tflops_per_sec"], n_tr["tflops_per_sec"]), 4),
        }
    ttft = None
    b_t, n_t = base.get("time_to_first_trial_s"), new.get("time_to_first_trial_s")
    if b_t is not None and n_t is not None:
        ttft = {
            "base_s": b_t,
            "new_s": n_t,
            "delta_s": round(n_t - b_t, 4),
            "rel": _rel(b_t, n_t) and round(_rel(b_t, n_t), 4),
        }
    wall = None
    b_w, n_w = base.get("wall_s"), new.get("wall_s")
    if b_w is not None and n_w is not None:
        wall = {
            "base_s": b_w,
            "new_s": n_w,
            "delta_s": round(n_w - b_w, 4),
            "rel": _rel(b_w, n_w) and round(_rel(b_w, n_w), 4),
        }
    memory = None
    b_mem = (base.get("memory") or {}).get("peak_bytes")
    n_mem = (new.get("memory") or {}).get("peak_bytes")
    if b_mem is not None and n_mem is not None:
        memory = {
            "base_peak_bytes": b_mem,
            "new_peak_bytes": n_mem,
            "delta_bytes": n_mem - b_mem,
            "rel": _rel(b_mem, n_mem) and round(_rel(b_mem, n_mem), 4),
        }
    # intra-phase sections: present when EITHER side carries them — a
    # one-sided section is how a legacy embed diffs against a newer
    # stream without crashing or hiding the new measurement
    bubbles = None
    b_i = (base.get("bubbles") or {}).get("idle_frac")
    n_i = (new.get("bubbles") or {}).get("idle_frac")
    if b_i is not None or n_i is not None:
        bubbles = {
            "base_idle_frac": b_i,
            "new_idle_frac": n_i,
            "delta": round(n_i - b_i, 4) if b_i is not None and n_i is not None else None,
        }
    staging = None
    b_o = (base.get("staging") or {}).get("overlap_frac")
    n_o = (new.get("staging") or {}).get("overlap_frac")
    if base.get("staging") is not None or new.get("staging") is not None:
        staging = {
            "base_overlap_frac": b_o,
            "new_overlap_frac": n_o,
            "delta": round(n_o - b_o, 4) if b_o is not None and n_o is not None else None,
            "base_wait_s": (base.get("staging") or {}).get("wait_s"),
            "new_wait_s": (new.get("staging") or {}).get("wait_s"),
        }
    roofline = None
    b_r, n_r = base.get("roofline") or {}, new.get("roofline") or {}
    if b_r or n_r:
        b_m, n_m = b_r.get("mxu_frac"), n_r.get("mxu_frac")
        roofline = {
            "base_mxu_frac": b_m,
            "new_mxu_frac": n_m,
            "delta": round(n_m - b_m, 4) if b_m is not None and n_m is not None else None,
            "base_bound": b_r.get("bound"),
            "new_bound": n_r.get("bound"),
        }
    return {
        "tool": "tracediff",
        "schema_version": DIFF_SCHEMA_VERSION,
        "base": {
            "label": base_label,
            "wall_s": b_w,
            "records": base.get("records"),
            "span_records": base.get("span_records"),
        },
        "new": {
            "label": new_label,
            "wall_s": n_w,
            "records": new.get("records"),
            "span_records": new.get("span_records"),
        },
        "phases": phases,
        "only_in_base": _only(b_ph, set(b_ph) - set(n_ph)),
        "only_in_new": _only(n_ph, set(n_ph) - set(b_ph)),
        "compile": compile_rep,
        "train": train,
        "time_to_first_trial": ttft,
        "wall": wall,
        "memory": memory,
        "bubbles": bubbles,
        "staging": staging,
        "roofline": roofline,
        "significant_regressions": [
            n for n in shared if phases[n]["direction"] == "regression"
        ],
        "significant_improvements": [
            n for n in shared if phases[n]["direction"] == "improvement"
        ],
        "gate": None,
    }


# -- the gate -------------------------------------------------------------


def validate_tolerances(tol: dict) -> None:
    """Refuse unknown tolerance keys — a typo'd budget silently gating
    nothing is the CI failure mode this gate exists to prevent."""
    if not isinstance(tol, dict):
        raise ValueError(f"tolerance file must hold a JSON object, not {type(tol).__name__}")
    unknown = sorted(set(tol) - _TOL_KEYS)
    if unknown:
        raise ValueError(
            f"unknown tolerance keys {unknown}; legal keys: {sorted(_TOL_KEYS)}"
        )
    # value TYPES are validated here too: this runs BEFORE a bench run
    # is paid for, and a null/list budget surviving to apply_gate would
    # traceback only after the measurement (bool is an int subclass —
    # excluded: {"default": true} is a typo, not a budget)
    def _num(key, v):
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ValueError(f"tolerance {key!r} must be a number, got {v!r}")

    for key in _TOL_KEYS - {"phases", "ignore", "require_significant"}:
        if key in tol:
            _num(key, tol[key])
    phases = tol.get("phases", {})
    if not isinstance(phases, dict):
        raise ValueError("'phases' must map span name -> max rel increase")
    for name, v in phases.items():
        _num(f"phases.{name}", v)
    ignore = tol.get("ignore", [])
    if not isinstance(ignore, (list, tuple)) or not all(
        isinstance(i, str) for i in ignore
    ):
        raise ValueError("'ignore' must be a list of span names")
    if "require_significant" in tol and not isinstance(
        tol["require_significant"], bool
    ):
        raise ValueError("'require_significant' must be a boolean")


def apply_gate(report: dict, tol: dict) -> dict:
    """Judge ``report`` against tolerance budgets; returns the ``gate``
    section ({ok, violations, tolerances}) and attaches it to the
    report. Regressions only — an improvement never fails a gate."""
    validate_tolerances(tol)
    default = float(tol.get("default", 0.25))
    per_phase = tol.get("phases", {})
    ignore = set(tol.get("ignore", ()))
    require_sig = bool(tol.get("require_significant", True))
    violations = []
    # a phase the operator EXPLICITLY budgeted that vanished from the
    # new side is lost coverage, not a pass: its regression became
    # unmeasurable exactly where someone declared they care (phases
    # under the default budget only may come and go — instrumentation
    # evolves — and stay visible via only_in_base)
    gone = {p["span"] for p in report.get("only_in_base", ())}
    for name in sorted(set(per_phase) & gone - ignore):
        violations.append(
            f"phase {name}: explicitly budgeted but missing from the new "
            "run (span lost — instrumentation dropped or tracing broken)"
        )
    for name, d in sorted(report["phases"].items()):
        if name in ignore:
            continue
        budget = float(per_phase.get(name, default))
        rel = d.get("rel")
        if rel is None or rel <= budget:
            continue
        if require_sig and not d.get("significant"):
            continue
        violations.append(
            f"phase {name}: {d['metric']} +{rel:.1%} exceeds the "
            f"{budget:.0%} budget (noise band {d['noise_rel']:.1%})"
        )
    if "max_cold_compile_increase" in tol:
        allowed = int(tol["max_cold_compile_increase"])
        delta = report["compile"]["cold"]["delta_count"]
        if delta > allowed:
            violations.append(
                f"compile: {delta} extra cold compile(s) exceeds the "
                f"allowed {allowed} (a warm path went cold)"
            )
    if "ttft_max_rel_increase" in tol and report["time_to_first_trial"]:
        rel = report["time_to_first_trial"].get("rel")
        budget = float(tol["ttft_max_rel_increase"])
        if rel is not None and rel > budget:
            violations.append(
                f"time-to-first-trial +{rel:.1%} exceeds the {budget:.0%} budget"
            )
    if "tflops_max_rel_decrease" in tol and report["train"]:
        rel = report["train"].get("rel")
        budget = float(tol["tflops_max_rel_decrease"])
        if rel is not None and -rel > budget:
            violations.append(
                f"achieved TF/s {rel:.1%} exceeds the -{budget:.0%} budget"
            )
    if "wall_max_rel_increase" in tol and report["wall"]:
        rel = report["wall"].get("rel")
        budget = float(tol["wall_max_rel_increase"])
        if rel is not None and rel > budget:
            violations.append(f"wall +{rel:.1%} exceeds the {budget:.0%} budget")
    if "memory_max_rel_increase" in tol and report["memory"]:
        rel = report["memory"].get("rel")
        budget = float(tol["memory_max_rel_increase"])
        if rel is not None and rel > budget:
            violations.append(
                f"device-memory watermark +{rel:.1%} exceeds the "
                f"{budget:.0%} budget"
            )
    # absolute intra-phase budgets: judged on the NEW side's
    # own numbers, not deltas — the diff's base is only context here
    if "idle_frac" in tol:
        budget = float(tol["idle_frac"])
        n_i = (report.get("bubbles") or {}).get("new_idle_frac")
        if n_i is None:
            # explicitly budgeted but unmeasurable: the lost-coverage
            # rule (same as a budgeted phase vanishing)
            violations.append(
                "idle_frac budgeted but the new attribution carries no "
                "bubble analysis (pre-round-8 embed, or a span-less stream)"
            )
        elif n_i > budget:
            violations.append(
                f"device-idle fraction {n_i:.1%} exceeds the {budget:.0%} "
                "budget (bubble-bound: see the trace table's idle-by-cause row)"
            )
    if "min_overlap" in tol:
        budget = float(tol["min_overlap"])
        n_o = (report.get("staging") or {}).get("new_overlap_frac")
        # None skips: a resident run stages nothing, so there is no
        # transfer to hide and no overlap to fall below a floor
        if n_o is not None and n_o < budget:
            violations.append(
                f"staging overlap {n_o:.1%} below the {budget:.0%} floor "
                "(the double buffer stopped hiding the transfer)"
            )
    if "min_mxu_frac" in tol:
        budget = float(tol["min_mxu_frac"])
        n_m = (report.get("roofline") or {}).get("new_mxu_frac")
        if n_m is None:
            violations.append(
                "min_mxu_frac budgeted but achieved TF/s or the platform "
                "cap is unmeasured (traced FLOPs + --peak-tflops or a "
                "calibrated device kind required)"
            )
        elif n_m < budget:
            violations.append(
                f"MXU utilization {n_m:.1%} of the platform cap is below "
                f"the {budget:.0%} floor (the kernel gap widened)"
            )
    gate = {"ok": not violations, "violations": violations, "tolerances": tol}
    report["gate"] = gate
    return gate


# -- rendering ------------------------------------------------------------


def _fmt_rel(rel) -> str:
    return "-" if rel is None else f"{rel:+.1%}"


def render_text(rep: dict) -> str:
    lines = [
        f"trace diff: {rep['base']['label']} (wall {rep['base']['wall_s']}s) "
        f"-> {rep['new']['label']} (wall {rep['new']['wall_s']}s"
        + (
            f", {_fmt_rel(rep['wall']['rel'])}"
            if rep["wall"] and rep["wall"].get("rel") is not None
            else ""
        )
        + ")"
    ]
    if rep["phases"]:
        lines.append(
            f"  {'phase':<12} {'base':>9} {'new':>9} {'delta':>9} "
            f"{'noise':>7}  verdict"
        )
        order = sorted(
            rep["phases"].items(),
            key=lambda kv: -abs(kv[1].get("delta_metric_s") or 0.0),
        )
        for name, d in order:
            b = "-" if d["base_metric_s"] is None else f"{d['base_metric_s']:.4f}"
            n = "-" if d["new_metric_s"] is None else f"{d['new_metric_s']:.4f}"
            verdict = d["direction"].upper() if d["significant"] else "ok"
            lines.append(
                f"  {name:<12} {b:>9} {n:>9} {_fmt_rel(d['rel']):>9} "
                f"{d['noise_rel']:>6.0%}  {verdict}"
            )
    for key, label in (("only_in_base", "removed"), ("only_in_new", "new")):
        for p in rep[key]:
            lines.append(
                f"  {label} phase: {p['span']} ({p['count']} span(s), "
                f"{p['total_s']}s total)"
            )
    c = rep["compile"]
    lines.append(
        f"  compile: cold {c['cold']['base_count']} -> {c['cold']['new_count']} "
        f"({c['cold']['delta_total_s']:+}s), persistent "
        f"{c['persistent']['base_count']} -> {c['persistent']['new_count']}"
    )
    if rep["train"]:
        t = rep["train"]
        lines.append(
            f"  train TF/s: {t['base_tflops_per_sec']} -> "
            f"{t['new_tflops_per_sec']} ({_fmt_rel(t['rel'])})"
        )
    if rep["time_to_first_trial"]:
        t = rep["time_to_first_trial"]
        lines.append(
            f"  time to first trial: {t['base_s']}s -> {t['new_s']}s "
            f"({_fmt_rel(t['rel'])})"
        )
    if rep["memory"]:
        m = rep["memory"]
        lines.append(
            f"  device-memory peak: {m['base_peak_bytes']} -> "
            f"{m['new_peak_bytes']} bytes ({_fmt_rel(m['rel'])})"
        )

    def _fmt_frac(v):
        return "-" if v is None else f"{v:.1%}"

    if rep.get("bubbles"):
        b = rep["bubbles"]
        lines.append(
            f"  idle fraction: {_fmt_frac(b['base_idle_frac'])} -> "
            f"{_fmt_frac(b['new_idle_frac'])}"
        )
    if rep.get("staging"):
        s = rep["staging"]
        lines.append(
            f"  staging overlap: {_fmt_frac(s['base_overlap_frac'])} -> "
            f"{_fmt_frac(s['new_overlap_frac'])}"
        )
    if rep.get("roofline"):
        r = rep["roofline"]
        lines.append(
            f"  roofline: {r['base_bound'] or '-'} -> {r['new_bound'] or '-'}"
            f" (MXU {_fmt_frac(r['base_mxu_frac'])} -> "
            f"{_fmt_frac(r['new_mxu_frac'])})"
        )
    if rep["gate"] is not None:
        if rep["gate"]["ok"]:
            lines.append("  gate: OK")
        else:
            lines.append("  gate: FAIL")
            for v in rep["gate"]["violations"]:
                lines.append(f"    {v}")
    return "\n".join(lines)


def diff_main(targets, json_out: bool, gate_path, error, peak_tflops=None) -> int:
    """The ``trace --diff`` body (``error`` is parser.error-shaped:
    usage problems exit 2; unreadable/undiffable TARGETS are runtime
    failures, rc 1, matching plain ``trace``)."""
    if len(targets) != 2:
        error(f"--diff takes exactly two targets (BASE NEW), got {len(targets)}")
    tol = None
    if gate_path:
        try:
            with open(gate_path) as f:
                tol = json.load(f)
            validate_tolerances(tol)
        except (OSError, ValueError) as e:
            error(f"--gate: {e}")
    sides = []
    for target in targets:
        try:
            sides.append(load_attribution(target, peak_tflops=peak_tflops))
        except (OSError, ValueError) as e:
            print(f"{target}: {e}", file=sys.stderr)
            if json_out:
                print(json.dumps({"tool": "tracediff", "error": str(e)}))
            return 1
    rep = diff_attributions(sides[0], sides[1], targets[0], targets[1])
    rc = 0
    if tol is not None:
        gate = apply_gate(rep, tol)
        if not gate["ok"]:
            rc = 1
    if json_out:
        print(json.dumps(rep))
    else:
        print(render_text(rep))
    if rc and not json_out:
        print("regression: gate budgets exceeded (exit 1)", file=sys.stderr)
    return rc


# -- bench record schema + trajectory gate --------------------------------


def validate_bench_record(rec) -> list:
    """Problems with one bench record (empty = valid). Legacy records
    (no ``schema_version``) need only metric/value/unit — the port's
    bench record is one; version-2 records must also carry the
    ``trace`` and ``device_memory`` keys (null allowed: a --no-trace
    bench) so the trajectory comparison can rely on their PRESENCE."""
    problems = []
    if not isinstance(rec, dict):
        return [f"record must be an object, not {type(rec).__name__}"]
    if not isinstance(rec.get("metric"), str):
        problems.append("missing/non-string 'metric'")
    if not isinstance(rec.get("unit"), str):
        problems.append("missing/non-string 'unit'")
    if "value" not in rec:
        problems.append("missing 'value'")
    elif rec["value"] is not None and not isinstance(rec["value"], (int, float)):
        problems.append(f"'value' must be a number or null, got {rec['value']!r}")
    sv = rec.get("schema_version")
    if sv is None:
        return problems  # legacy shape
    if not isinstance(sv, int) or sv < 2:
        problems.append(f"'schema_version' must be an int >= 2, got {sv!r}")
        return problems
    if sv > BENCH_SCHEMA_VERSION:
        problems.append(
            f"'schema_version' {sv} is newer than this build's "
            f"{BENCH_SCHEMA_VERSION}"
        )
    for key in ("trace", "device_memory"):
        if key not in rec:
            problems.append(f"schema_version {sv} record missing '{key}' (null allowed)")
    tr = rec.get("trace")
    if tr is not None:
        if not isinstance(tr, dict) or not isinstance(tr.get("phases"), dict):
            problems.append("'trace' must be null or an attribution with 'phases'")
        else:
            for name, p in tr["phases"].items():
                for stat in ("count", "total_s", "self_s", "p50_s", "p95_s"):
                    if stat not in p:
                        problems.append(f"trace phase {name!r} missing {stat!r}")
                        break
            # the intra-phase sections are OPTIONAL (older records and
            # --no-trace records must keep validating forever), but when
            # present they must be objects
            for opt in ("bubbles", "staging", "roofline"):
                if tr.get(opt) is not None and not isinstance(tr[opt], dict):
                    problems.append(f"trace {opt!r} must be null or an object")
    mem = rec.get("device_memory")
    if mem is not None and (
        not isinstance(mem, dict) or "bytes_in_use" not in mem or "source" not in mem
    ):
        problems.append(
            "'device_memory' must be null or {bytes_in_use, source, ...}"
        )
    # the multi-objective summary (bench config 8) is OPTIONAL
    # forever — every scalar record (including the committed history)
    # stays valid without it — but a present 'scores' must be a
    # {objective: number} object so the trajectory comparison can rely
    # on its shape the same way it relies on trace/device_memory
    sc = rec.get("scores")
    if sc is not None and (
        not isinstance(sc, dict)
        or not sc
        or not all(
            isinstance(k, str)
            and isinstance(v, (int, float))
            and not isinstance(v, bool)
            for k, v in sc.items()
        )
    ):
        problems.append("'scores' must be null or a {objective: number} object")
    return problems


def _lower_is_better(rec: dict) -> bool:
    unit = str(rec.get("unit", ""))
    return "seconds" in unit or unit.endswith("_s")


def bench_gate(base_records, new_records, tol: Optional[dict] = None) -> dict:
    """The whole-trajectory verdict: match bench records (by ``config``,
    else by ``metric``), gate each pair's headline value, and — where
    both sides embed a trace attribution — run the full phase diff gate.
    A benchmark's trajectory gate consumes this."""
    tol = dict(tol or {})
    validate_tolerances(tol)
    value_budget = float(tol.get("value_max_rel_regression", 0.25))

    def by_key(records):
        if isinstance(records, dict):
            records = [records]
        out = {}
        for r in records:
            if isinstance(r, dict) and isinstance(r.get("parsed"), dict):
                r = r["parsed"]  # a driver wrapper
            if not isinstance(r, dict):
                continue
            key = r.get("config")
            if key is None:
                if "metric" not in r:
                    continue  # not a bench record at all
                key = r["metric"]
            else:
                key = f"config{key}"
            out[str(key)] = r
        return out

    base_by, new_by = by_key(base_records), by_key(new_records)
    configs = {}
    violations = []
    # zero comparable records is a FAILURE, not a clean verdict: a
    # typo'd --gate-base (wrong file, empty list, non-record shapes)
    # would otherwise gate nothing and exit 0 — the silent-CI-pass
    # failure mode this whole layer exists to prevent
    if not base_by or not new_by:
        side = "base" if not base_by else "new"
        violations.append(
            f"{side} record set holds no bench records (empty or "
            "non-record JSON — wrong file?)"
        )
    elif not set(base_by) & set(new_by):
        violations.append(
            f"no comparable records: base keys {sorted(base_by)} share "
            f"nothing with new keys {sorted(new_by)} (wrong --gate-base "
            "file, or this run measured different configs)"
        )
    for key in sorted(set(base_by) & set(new_by)):
        b, n = base_by[key], new_by[key]
        entry: dict = {"unit": n.get("unit")}
        bv, nv = b.get("value"), n.get("value")
        if nv is None and bv is not None:
            # the worst regression shape: the prior run measured a
            # value and this run has none (the config crashed and
            # recorded an error, or its target was never reached) — a
            # gate that shrugged here would pass exactly when a config
            # dies entirely
            note = n.get("error") or "no measured value in the new run"
            entry["value"] = {"base": bv, "new": None, "ok": False, "note": note}
            violations.append(
                f"{key}: no measured value in the new run "
                f"(base had {bv}; {note})"
            )
        elif bv is None:
            entry["value"] = {"ok": None, "note": "value missing in base"}
        else:
            if _lower_is_better(n):
                reg = (nv - bv) / abs(bv) if bv else None
            else:
                reg = (bv - nv) / abs(bv) if bv else None
            ok = reg is None or reg <= value_budget
            entry["value"] = {
                "base": bv,
                "new": nv,
                "regression_rel": None if reg is None else round(reg, 4),
                "budget": value_budget,
                "ok": ok,
            }
            if not ok:
                violations.append(
                    f"{key}: value {bv} -> {nv} regresses "
                    f"{reg:.1%} > {value_budget:.0%} budget"
                )
        if isinstance(b.get("trace"), dict) and isinstance(n.get("trace"), dict):
            rep = diff_attributions(b["trace"], n["trace"], f"{key}:base", f"{key}:new")
            gate = apply_gate(rep, {k: v for k, v in tol.items() if k != "value_max_rel_regression"})
            entry["trace_gate"] = {
                "ok": gate["ok"],
                "violations": gate["violations"],
                "significant_regressions": rep["significant_regressions"],
            }
            violations.extend(f"{key}: {v}" for v in gate["violations"])
        else:
            entry["trace_gate"] = None
        configs[key] = entry
    return {
        "tool": "benchgate",
        "schema_version": DIFF_SCHEMA_VERSION,
        "ok": not violations,
        "configs": configs,
        "unmatched_base": sorted(set(base_by) - set(new_by)),
        "unmatched_new": sorted(set(new_by) - set(base_by)),
        "violations": violations,
    }

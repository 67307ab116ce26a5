"""Post-hoc sweep reporting: render one-or-many ledgers for operators
(port of ``mpi_opt_tpu/ledger/report.py``, which imports no JAX; the
port keeps its own copy, so both packages render a ledger alike).

``python -m mpi_opt_tpu_torch report TARGET [TARGET ...]`` — best trial,
score trajectory, failure/timeout/retry/cache breakdown, throughput;
``--json`` for machines, ``--validate`` as the CI schema gate (exit 1
on any malformed record, torn tail included — format drift should be
caught by the suite, not by a resume failure in production).

A TARGET may be a DIRECTORY: every ledger underneath is discovered
(header-sniffed ``*.jsonl``) and rendered grouped by sweep identity —
pointed at a service ``--state-dir``, one command audits every
tenant's best/status/throughput, with each tenant's service state
(done/parked/cancelled, slices) read from the sibling ``status.json``
the scheduler maintains, and a running tenant's live phase from
``service/spool.py::live_phase``.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional

from mpi_opt_tpu_torch.ledger.store import (
    LedgerError,
    read_ledger,
    scan_boundaries,
    sniff_header,
    validate_ledger,
)
from mpi_opt_tpu_torch.service.spool import live_phase

# score trajectory rendered as a coarse unicode sparkline: enough to see
# "when did the sweep stop improving" in a terminal without plotting
_SPARK = "▁▂▃▄▅▆▇█"


def _sparkline(values: list[float], width: int = 32) -> str:
    finite = [v for v in values if v == v]  # NaN-free
    if not finite:
        return ""
    if len(values) > width:  # downsample evenly to terminal width
        step = len(values) / width
        values = [values[int(i * step)] for i in range(width)]
    lo, hi = min(finite), max(finite)
    span = (hi - lo) or 1.0
    out = []
    for v in values:
        if v != v:
            out.append(" ")
        else:
            out.append(_SPARK[int((v - lo) / span * (len(_SPARK) - 1))])
    return "".join(out)


def discover_ledgers(directory: str) -> list[str]:
    """Every ledger file under ``directory``: ``*.jsonl`` whose first
    line is a ledger header record (``store.sniff_header``). Metrics
    streams (JSONL of ``{"event": ...}``) and other JSON files are
    skipped by the sniff, so pointing this at a service state-dir finds
    exactly the per-tenant journals."""
    found = []
    for root, _dirs, files in os.walk(directory):
        for f in files:
            if not f.endswith(".jsonl"):
                continue
            path = os.path.join(root, f)
            if sniff_header(path) is not None:
                found.append(path)
    return sorted(found)


def _service_status(path: str) -> Optional[dict]:
    """The scheduler-maintained tenant status next to a service ledger
    (None for plain CLI ledgers): operators reading a state-dir report
    want done/parked/cancelled and slice counts beside the scores."""
    status_path = os.path.join(os.path.dirname(path), "status.json")
    try:
        with open(status_path) as f:
            s = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(s, dict) or "state" not in s:
        return None
    out = {
        "job": s.get("id"),
        "tenant": s.get("tenant"),
        "state": s.get("state"),
        "priority": int(s.get("priority") or 0),
        "deadline_ts": s.get("deadline_ts"),
        "slices": s.get("slices"),
        "preemptions": s.get("preemptions"),
        "program_cache": s.get("program_cache"),
        # post-slice device-memory watermark (obs/memory.py via the
        # scheduler's status write)
        "device_memory": s.get("device_memory"),
        # fleet fields: which server ran the last slice and
        # how many times a dead peer's lease was taken over — a ledger
        # that changed hands mid-sweep is still record-identical to a
        # solo run, and the report should say the handoff happened
        "server": s.get("server"),
        "takeovers": s.get("takeovers"),
    }
    # an ACTIVE tenant also reports what it is doing right now (phase
    # from its heartbeat's active-span field + current slice elapsed)
    live = live_phase(os.path.dirname(path), s)
    if live is not None:
        out.update(live)
    return out


def _mo_final_rows(records, spec):
    """Each member's LAST full-vector ok record: ``(recs, matrix)``.

    The Pareto view a report renders is the END state of the sweep —
    one point per member/trial at its highest journaled budget (PBT
    members re-evaluate every generation; SHA trials stop at different
    rungs). Records missing the vector (scalar sweeps never carry one)
    or holding a null entry (non-finite objective) never join the
    front."""
    import numpy as np

    last: dict = {}
    for r in records:
        v = r.get("scores")
        if (
            r["status"] != "ok"
            or v is None
            or len(v) != spec.m
            or any(x is None for x in v)
        ):
            continue
        key = r.get("member", r["trial_id"])
        cur = last.get(key)
        if cur is None or (r["step"], r["trial_id"]) >= (cur["step"], cur["trial_id"]):
            last[key] = r
    recs = [last[k] for k in sorted(last)]
    mat = np.asarray(
        [[float(x) for x in r["scores"]] for r in recs], dtype=np.float64
    ).reshape(len(recs), spec.m)
    return recs, mat


def _constrained_spec(spec, constraint: str):
    """``spec`` with one bound overridden from a ``--best-under`` string
    (``"params<=2e4"``). Raises LedgerError on an unknown objective or
    an operator that disagrees with its direction."""
    from mpi_opt_tpu_torch.objectives import Objective, parse_constraint

    try:
        name, op, value = parse_constraint(constraint)
    except ValueError as e:
        raise LedgerError(str(e))
    if name not in spec.names:
        raise LedgerError(
            f"--best-under names {name!r} but this sweep's objectives are "
            f"{list(spec.names)}"
        )
    objs = []
    for o in spec.objectives:
        if o.name != name:
            objs.append(o)
            continue
        want = ">=" if o.direction == "max" else "<="
        if op != want:
            raise LedgerError(
                f"--best-under {constraint!r}: objective {name!r} is "
                f"{o.direction}imized, so its constraint must use {want!r}"
            )
        objs.append(Objective(name, o.direction, float(value)))
    from mpi_opt_tpu_torch.objectives import ObjectiveSpec

    return ObjectiveSpec(tuple(objs))


def _mo_summary(header: dict, records, best_under: Optional[str]) -> Optional[dict]:
    """The multi-objective block of a report (None when the header
    carries no ``objective_spec``): final-state Pareto front, exact
    hypervolume, and — when asked — the typed ``--best-under`` answer
    (feasible / least_violation / diverged, never a crash)."""
    ospec = header.get("objective_spec")
    if not ospec:
        if best_under:
            raise LedgerError(
                "--best-under needs a multi-objective ledger (no "
                "objective_spec in header)"
            )
        return None
    import numpy as np

    from mpi_opt_tpu_torch.objectives import (
        ObjectiveSpec,
        hypervolume,
        pareto_front_mask,
        select_best,
    )

    try:
        spec = ObjectiveSpec.from_spec(ospec)
    except (ValueError, TypeError, KeyError) as e:
        raise LedgerError(f"malformed objective_spec in header: {e}")
    recs, mat = _mo_final_rows(records, spec)
    norm = np.asarray(spec.normalize(mat), dtype=np.float64)
    mask = pareto_front_mask(norm)
    idx = np.flatnonzero(mask)
    out = {
        "objectives": ospec,
        "evaluated": len(recs),
        "front_size": int(mask.sum()),
        "front": [
            {
                "trial_id": recs[i]["trial_id"],
                "member": recs[i].get("member"),
                "step": recs[i]["step"],
                "scores": [float(v) for v in mat[i]],
                "params": recs[i]["params"],
            }
            for i in idx
        ],
        "hypervolume": float(hypervolume(norm[mask])) if len(idx) else 0.0,
    }
    if best_under:
        cspec = _constrained_spec(spec, best_under)
        sel = select_best(mat, cspec) if len(recs) else {
            "index": None, "kind": "diverged", "violation": None,
        }
        picked = None if sel["index"] is None else recs[int(sel["index"])]
        out["best_under"] = {
            "constraint": best_under,
            "kind": sel["kind"],
            "violation": sel["violation"],
            "trial_id": None if picked is None else picked["trial_id"],
            "scores": None
            if picked is None
            else [float(v) for v in picked["scores"]],
            "params": None if picked is None else picked["params"],
        }
    return out


def summarize_ledger(path: str, best_under: Optional[str] = None) -> dict:
    """One ledger -> its machine-readable report dict.

    Raises LedgerError for files the tolerant loader refuses (malformed
    mid-file records, missing header), and for a ``best_under``
    constraint that cannot apply (scalar ledger, unknown objective,
    operator against the objective's direction).
    """
    header, records, n_torn = read_ledger(path)
    if header is None:
        raise LedgerError(f"{path}: empty ledger (no header)")
    cfg = header.get("config", {})
    by_status = {"ok": 0, "failed": 0, "timeout": 0}
    retried = cache_hits = 0
    best: Optional[dict] = None
    trajectory: list[float] = []  # running best over journal order
    running = float("nan")
    wall_sum = 0.0
    for r in records:
        by_status[r["status"]] += 1
        if int(r.get("attempts") or 1) > 1:
            retried += 1
        if r.get("cached"):
            cache_hits += 1
        else:
            wall_sum += float(r.get("wall_s") or 0.0)
        if r["status"] == "ok" and r.get("score") is not None:
            s = float(r["score"])
            if best is None or s > float(best["score"]):
                best = r
                running = s
        trajectory.append(running)
    # journal timestamps bound the sweep's wall even across driver
    # restarts (each record carries an absolute ts)
    ts = [float(r["ts"]) for r in records if r.get("ts") is not None]
    span = (max(ts) - min(ts)) if len(ts) > 1 else 0.0
    n = len(records)
    fused = None
    if cfg.get("mode") == "fused" or any("boundary" in r for r in records):
        # fused member journal: the per-boundary view operators actually
        # ask for — how many generations/rungs/batches are journaled and
        # how many members each one lost to divergence
        by_boundary, sizes, _problems, torn_final = scan_boundaries(records)
        order = sorted(by_boundary)
        fused = {
            "granularity": cfg.get("granularity"),
            "boundaries": len(order),
            "member_records": sum(len(by_boundary[b]) for b in order),
            "member_failures": [
                sum(1 for r in by_boundary[b].values() if r["status"] != "ok")
                for b in order
            ],
            "boundary_sizes": [sizes[b] for b in order],
            "torn_boundary": torn_final,
        }
    return {
        "path": path,
        "sweep_id": header.get("sweep_id"),
        "version": header.get("version"),
        "config": cfg,
        "trials": n,
        "by_status": by_status,
        "retried": retried,
        "cache_hits": cache_hits,
        "torn_tail_dropped": n_torn,
        "best": None
        if best is None
        else {
            "trial_id": best["trial_id"],
            "score": float(best["score"]),
            "step": best["step"],
            "params": best["params"],
        },
        "trajectory": trajectory,
        "trials_per_sec": round(n / span, 4) if span > 0 else None,
        "eval_wall_s": round(wall_sum, 3),
        "fused": fused,
        "multi_objective": _mo_summary(header, records, best_under),
        "service": _service_status(path),
    }


def _render_text(rep: dict) -> str:
    cfg = rep["config"]
    lines = [
        f"ledger {rep['path']}  (sweep {rep['sweep_id']}, schema v{rep['version']})",
        "  config: "
        + ", ".join(
            f"{k}={cfg[k]}"
            for k in ("algorithm", "workload", "backend", "seed")
            if k in cfg
        ),
        f"  trials: {rep['trials']}  "
        f"ok={rep['by_status']['ok']} failed={rep['by_status']['failed']} "
        f"timeout={rep['by_status']['timeout']} retried={rep['retried']} "
        f"cache_hits={rep['cache_hits']}",
    ]
    if rep.get("service"):
        s = rep["service"]
        pc = s.get("program_cache") or {}
        live = ""
        if s.get("state") == "running":
            live = (
                f" phase={s.get('phase')}"
                f" slice_elapsed={s.get('slice_elapsed_s')}s"
            )
        fleet = ""
        if s.get("priority"):
            fleet += f" prio={s['priority']}"
        if s.get("deadline_ts"):
            fleet += f" deadline_ts={s['deadline_ts']}"
        if s.get("server"):
            fleet += f" server={s['server']}"
        if s.get("takeovers"):
            fleet += f" takeovers={s['takeovers']}"
        lines.append(
            f"  service: tenant={s.get('tenant')} job={s.get('job')} "
            f"state={s.get('state')} slices={s.get('slices')} "
            f"preemptions={s.get('preemptions')} "
            f"cache={pc.get('hits', 0)}h/{pc.get('misses', 0)}m" + fleet + live
        )
    if rep["torn_tail_dropped"]:
        lines.append("  note: 1 torn tail line dropped (crash mid-append)")
    if rep.get("fused"):
        f = rep["fused"]
        gran = f.get("granularity") or "boundary"
        fails = f["member_failures"]
        tail = ""
        if len(fails) > 16:
            fails, tail = fails[:16], f" ... ({len(f['member_failures'])} total)"
        lines.append(
            f"  fused: {f['boundaries']} {gran} boundaries, "
            f"{f['member_records']} member records; failures/boundary: "
            f"{fails}{tail}"
        )
        if f.get("torn_boundary") is not None:
            lines.append(
                f"  note: boundary {f['torn_boundary']} is torn (killed "
                "mid-journal; --resume re-journals it)"
            )
    if rep.get("multi_objective"):
        m = rep["multi_objective"]
        obj_s = ", ".join(
            f"{o['name']}:{o['direction']}"
            + (
                ""
                if o.get("bound") is None
                else (">=" if o["direction"] == "max" else "<=") + str(o["bound"])
            )
            for o in m["objectives"]
        )
        lines.append(f"  objectives: {obj_s}")
        lines.append(
            f"  pareto: front {m['front_size']}/{m['evaluated']} evaluated, "
            f"hypervolume {m['hypervolume']:.6g}"
        )
        for fr in m["front"][:8]:
            lines.append(
                f"    trial {fr['trial_id']} @ step {fr['step']}  "
                f"scores {fr['scores']}"
            )
        if len(m["front"]) > 8:
            lines.append(f"    ... ({len(m['front'])} front points total)")
        if m.get("best_under"):
            bu = m["best_under"]
            if bu["trial_id"] is None:
                lines.append(
                    f"  best-under {bu['constraint']}: none (every evaluated "
                    "trial diverged)"
                )
            else:
                note = (
                    ""
                    if bu["kind"] == "feasible"
                    else f" [DEGRADED: nothing feasible; least violation "
                    f"{bu['violation']:.4g}]"
                )
                lines.append(
                    f"  best-under {bu['constraint']}: trial {bu['trial_id']} "
                    f"scores {bu['scores']}{note}"
                )
    if rep["best"] is None:
        lines.append("  best: none (no ok trial recorded)")
    else:
        b = rep["best"]
        lines.append(
            f"  best: trial {b['trial_id']} score {b['score']:.6f} "
            f"@ step {b['step']}  {json.dumps(b['params'])}"
        )
    spark = _sparkline(rep["trajectory"])
    if spark:
        lines.append(f"  best-so-far: {spark}")
    if rep["trials_per_sec"] is not None:
        lines.append(
            f"  throughput: {rep['trials_per_sec']} trials/s "
            f"(eval wall {rep['eval_wall_s']}s)"
        )
    return "\n".join(lines)


def replay_consistency(ledger_path: str, search_state: dict) -> list:
    """Cross-check a ledger journal against a restored snapshot's
    ``search`` item (fsck's replay-consistency gate): every trial the
    snapshot records as FINAL must hold a final record in the journal,
    because the driver fsyncs each record BEFORE reporting it to the
    algorithm — the journal can never lag the search state. A snapshot
    final missing from the journal means the pair is torn (mixed
    directories, a hand-edited journal) and a ``--ledger --resume``
    would replay into a state that is already ahead of it.

    Returns human-readable problems (empty = consistent).
    """
    try:
        _header, records, _n_torn = read_ledger(ledger_path)
    except (LedgerError, OSError) as e:
        return [f"ledger unreadable for cross-check: {e}"]
    journaled = {int(r["trial_id"]) for r in records}
    finals = {
        int(t["trial_id"])
        for t in search_state.get("algorithm", {}).get("trials", [])
        # 'done'/'failed' are terminal; 'stopped' (ASHA cut) trials also
        # completed an evaluation and were journaled before the cut
        if t.get("status") in ("done", "failed", "stopped")
    }
    missing = sorted(finals - journaled)
    if missing:
        return [
            f"snapshot records {len(missing)} final trial(s) absent from "
            f"the journal (trial ids {missing[:10]}"
            + ("...)" if len(missing) > 10 else ")")
        ]
    return []


def fused_replay_consistency(ledger_path: str, boundaries_done: int) -> list:
    """The boundary-granular twin of ``replay_consistency`` for FUSED
    sweeps (fsck's cross-check): every boundary the newest verified
    snapshot records as complete (``meta['boundaries_done']``) must be
    FULLY journaled, because the fused drivers journal each boundary's
    member records before saving its snapshot. A journaled prefix
    shorter than the snapshot's boundary count means the pair is torn
    (mixed directories, a hand-edited journal, or a ledger attached
    mid-sweep) and a ``--ledger --resume`` would refuse.

    Returns human-readable problems (empty = consistent).
    """
    try:
        _header, records, _n_torn = read_ledger(ledger_path)
    except (LedgerError, OSError) as e:
        return [f"ledger unreadable for cross-check: {e}"]
    by_boundary, sizes, problems, _torn_final = scan_boundaries(records)
    if problems:
        return [f"fused journal structure: {p}" for p in problems]
    n = 0
    while n in by_boundary and len(by_boundary[n]) == sizes[n]:
        n += 1
    if n < int(boundaries_done):
        return [
            f"snapshot records {boundaries_done} boundaries complete but "
            f"only {n} are fully journaled — the journal lags the snapshot "
            "it should never lag"
        ]
    return []


def report_main(argv=None) -> int:
    """The ``mpi_opt_tpu_torch report`` subcommand (see cli.main dispatch)."""
    import argparse

    p = argparse.ArgumentParser(
        prog="mpi_opt_tpu_torch report",
        description="render durable sweep ledgers (see README: sweep ledger)",
    )
    p.add_argument(
        "ledgers",
        nargs="+",
        metavar="TARGET",
        help="ledger JSONL path(s), or directories to discover ledgers "
        "under (e.g. a service --state-dir: all tenant journals render "
        "grouped by sweep identity)",
    )
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument(
        "--best-under",
        metavar="CONSTRAINT",
        help="answer 'best trial subject to CONSTRAINT' over a "
        "multi-objective ledger, e.g. \"params<=2e4\" — typed result: "
        "feasible, or DEGRADED to the least-violating trial when nothing "
        "satisfies it (never a crash)",
    )
    p.add_argument(
        "--validate",
        action="store_true",
        help="strict schema check only: exit 1 on any malformed record "
        "(torn tail included); no report is rendered",
    )
    args = p.parse_args(argv)

    # directory targets expand to every discovered ledger underneath;
    # an empty directory is an operator error surfaced as exit 1 (an
    # audit that silently checked nothing would read as a green audit)
    expanded, rc_expand = [], 0
    for target in args.ledgers:
        if os.path.isdir(target):
            hits = discover_ledgers(target)
            if not hits:
                # stderr: --json's stdout is a single JSON object "for
                # machines" and a stray text line would break json.loads
                print(
                    f"{target}: no ledgers found under directory",
                    file=sys.stderr,
                )
                rc_expand = 1
            expanded.extend(hits)
        else:
            expanded.append(target)
    args.ledgers = expanded

    if args.validate:
        rc = rc_expand
        out = {}
        for path in args.ledgers:
            problems = validate_ledger(path)
            out[path] = problems
            if problems:
                rc = 1
            if not args.json:
                status = "ok" if not problems else "; ".join(problems)
                print(f"{path}: {status}")
        if args.json:
            print(json.dumps({"valid": rc == 0, "problems": out}))
        return rc

    reports = []
    rc = rc_expand
    for path in args.ledgers:
        try:
            reports.append(summarize_ledger(path, best_under=args.best_under))
        except (LedgerError, OSError) as e:
            print(f"{path}: {e}", file=sys.stderr)
            rc = 1
    if args.json:
        overall = None
        cands = [r["best"] for r in reports if r["best"] is not None]
        if cands:
            overall = max(cands, key=lambda b: b["score"])
        print(json.dumps({"ledgers": reports, "best": overall}))
        return rc
    for rep in reports:
        print(_render_text(rep))
    if len(reports) > 1:
        # the grouped service view: ledgers sharing a sweep identity
        # (workload + algorithm + space hash) are one logical family —
        # e.g. N tenants of the same search — and operators compare
        # within the family before across it
        groups: dict = {}
        for r in reports:
            cfg = r["config"]
            key = (cfg.get("workload"), cfg.get("algorithm"), cfg.get("space_hash"))
            groups.setdefault(key, []).append(r)
        print(f"sweep identities: {len(groups)}")
        # identity is (workload, algorithm, space_hash) but the label
        # shows only workload/algorithm — when two groups differ ONLY by
        # search space (the exact split the grouping exists to make),
        # a short hash suffix keeps their lines distinguishable
        pair_counts: dict = {}
        for w, a, _h in groups:
            pair_counts[(w, a)] = pair_counts.get((w, a), 0) + 1
        for (workload, algorithm, h), grp in sorted(
            groups.items(), key=lambda kv: (str(kv[0][0]), str(kv[0][1]), str(kv[0][2]))
        ):
            label = f"{workload}/{algorithm}"
            if pair_counts[(workload, algorithm)] > 1:
                label += f" (space {str(h)[:8]})"
            bests = [r["best"] for r in grp if r["best"] is not None]
            best_s = (
                f"best {max(b['score'] for b in bests):.6f}" if bests else "no best"
            )
            rates = [r["trials_per_sec"] for r in grp if r["trials_per_sec"]]
            rate_s = f", {round(sum(rates), 3)} trials/s" if rates else ""
            states = [
                r["service"]["state"] for r in grp if r.get("service") is not None
            ]
            state_s = (
                "  [" + " ".join(f"{s}:{states.count(s)}" for s in sorted(set(states))) + "]"
                if states
                else ""
            )
            print(
                f"  {label}: {len(grp)} ledger(s), "
                f"{sum(r['trials'] for r in grp)} trials, {best_s}{rate_s}{state_s}"
            )
        cands = [
            (r["path"], r["best"]) for r in reports if r["best"] is not None
        ]
        if cands:
            path, b = max(cands, key=lambda pb: pb[1]["score"])
            print(
                f"overall best: score {b['score']:.6f} "
                f"(trial {b['trial_id']} of {path})"
            )
    return rc

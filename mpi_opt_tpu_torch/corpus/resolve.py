"""``--warm-start auto:DIR``: resolve priors through the corpus index
(port of ``mpi_opt_tpu/corpus/resolve.py``).

The resolution contract:

- **Exact** — every index entry whose ``space_hash`` equals the live
  space's contributes ALL its ok records; the merged set is deduped by
  canonical params key with the NEWEST record (journal ``ts``) winning,
  so a point re-evaluated across sweeps carries its freshest score and
  N overlapping ledgers never multiply one point's weight.
- **Fuzzy** — different-hash entries are admitted only when their
  structural fingerprint covers the live space (corpus/match.py) AND
  they ran the same workload (scores across workloads are not
  comparable evidence); their records enter down-weighted at budget 0
  (``fuzzy_observations``), never as exact-cache material.
- **Degrade, don't die** — a stale index entry (ledger deleted or
  rewritten behind the index), a corrupt entry, or an unreadable
  ledger becomes one ``corpus_skip`` event and the resolution
  continues with the remaining sources. A missing/corrupt index
  rebuilds in memory from discovery (the persistent file is derived
  state; ``corpus index DIR`` re-persists it).

The resolver never writes: a sweep's warm start must not mutate the
corpus it reads (concurrent sweeps share one), so the on-disk index is
refreshed only by the explicit ``corpus index`` command.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from mpi_opt_tpu_torch.corpus import index as cindex
from mpi_opt_tpu_torch.corpus.match import MIN_COMPAT, compat_score, fuzzy_observations
from mpi_opt_tpu_torch.ledger.store import LedgerError, read_ledger, sniff_header
from mpi_opt_tpu_torch.ledger.warmstart import observations_from_records


def _front_only(path: str, records) -> tuple:
    """A multi-objective ledger's records reduced to its final
    non-dominated set: ``(records, n_dominated)``.

    Seeding a new sweep from an MO prior's DOMINATED points would pull
    it toward trade-offs the prior already proved inferior, so only the
    front enters the merge; scalar ledgers (no ``objective_spec`` in
    the header) pass through untouched. A malformed spec also passes
    through — degraded evidence beats refused evidence here, the same
    rule as every other corpus degradation."""
    header = sniff_header(path)
    ospec = None if header is None else header.get("objective_spec")
    if not ospec:
        return records, 0
    import numpy as np

    from mpi_opt_tpu_torch.ledger.report import _mo_final_rows
    from mpi_opt_tpu_torch.objectives import ObjectiveSpec, pareto_front_mask

    try:
        spec = ObjectiveSpec.from_spec(ospec)
    except (ValueError, TypeError, KeyError):
        return records, 0
    recs, mat = _mo_final_rows(records, spec)
    mask = pareto_front_mask(np.asarray(spec.normalize(mat), dtype=np.float64))
    front = [recs[i] for i in np.flatnonzero(mask)]
    return front, len(records) - len(front)


@dataclasses.dataclass
class Resolution:
    """What ``--warm-start auto:`` actually ingested, for the event
    payload and the summary: ``observations`` (exact first, fuzzy
    after), ``sources`` (one row per contributing ledger), ``skips``
    (per-record loss counters merged across sources), ``skipped``
    (whole entries degraded to corpus_skip events)."""

    observations: list
    sources: list
    skips: dict
    skipped: list


def _entry_live(entry: dict) -> Optional[str]:
    """None when the entry's ledger is still the file the index saw,
    else the skip reason ("missing" / "changed")."""
    path = entry.get("path")
    if not path or not os.path.exists(path):
        return "missing"
    stamp = cindex._stat_stamp(path)
    if stamp is None:
        return "missing"
    if (entry.get("mtime_ns"), entry.get("size")) != stamp:
        return "changed"
    return None


def resolve(
    space,
    corpus_dir: str,
    workload: Optional[str] = None,
    exclude: Optional[str] = None,
    metrics=None,
) -> Resolution:
    """Resolve the corpus under ``corpus_dir`` into warm-start
    observations for ``space``. ``workload`` gates fuzzy admission;
    ``exclude`` (realpath'd) drops THIS sweep's own ledger — the
    self-warm-start guard, applied here so every resolution path
    shares it. ``metrics`` (MetricsLogger) receives ``corpus_skip``
    events for degraded entries; None stays silent."""
    skipped: list = []

    def skip(path, reason):
        skipped.append({"path": path, "reason": reason})
        if metrics is not None:
            metrics.log("corpus_skip", path=path, reason=reason)

    doc = cindex.read_index(corpus_dir)
    if doc is None:
        if os.path.exists(cindex.index_path(corpus_dir)):
            # present but unreadable/malformed: degrade loudly, then
            # rebuild from discovery — derived state is replaceable
            skip(cindex.index_path(corpus_dir), "index-unreadable")
        doc = cindex.build_index(corpus_dir)

    live_hash = space.space_hash()
    live_spec = space.spec()
    exclude_real = os.path.realpath(exclude) if exclude else None

    # records already parsed during this resolution (grown-ledger
    # re-summaries), keyed by path — consumed by load_records below
    records_cache: dict = {}
    exact_entries, fuzzy_entries = [], []
    for entry in doc.get("entries", []):
        if not isinstance(entry, dict) or not entry.get("path"):
            skip(str(entry)[:200], "malformed-entry")
            continue
        if entry.get("error"):
            skip(entry["path"], f"unreadable: {entry['error']}")
            continue
        if exclude_real and os.path.realpath(entry["path"]) == exclude_real:
            continue  # this run's own ledger is not a prior sweep
        reason = _entry_live(entry)
        if reason == "missing":
            skip(entry["path"], "stale-entry: ledger deleted")
            continue
        if reason == "changed":
            # the ledger grew/rewrote since indexing: re-summarize it
            # live (fresh evidence is better evidence), degrade to a
            # skip only if the re-read fails; the parsed records are
            # cached so the merge loops don't re-read the file
            entry, records = cindex.summarize_entry_with_records(entry["path"])
            if entry.get("error"):
                skip(entry["path"], f"stale-entry: {entry['error']}")
                continue
            records_cache[entry["path"]] = records
        if entry.get("space_hash") == live_hash:
            exact_entries.append(entry)
        elif (
            workload is not None
            and entry.get("workload") == workload
            and compat_score(live_spec, entry.get("fingerprint")) >= MIN_COMPAT
        ):
            fuzzy_entries.append(entry)

    sources: list = []
    skips: dict = {}
    observations: list = []

    def load_records(entry):
        """One read per ledger per resolution: a grown (``changed``)
        entry was already re-read by ``summarize_entry`` above — the
        cache hands those records straight to the merge loops instead
        of parsing the file a second time."""
        path = entry["path"]
        if path in records_cache:
            return records_cache.pop(path)
        _header, records, _ = read_ledger(path)
        return records

    # exact: merge ALL matching ledgers' ok records, dedup by canonical
    # (params, budget) key — the budget is part of evaluation identity
    # (an ASHA point at step 10 and step 270 is TWO pieces of evidence,
    # the same both-keys-survive rule as EvalCache) — newest journal ts
    # wins within one key
    merged: dict = {}
    exact_order = []  # (path, n contributed) in entry order, for the event
    total_ok = 0
    for entry in exact_entries:
        try:
            records = load_records(entry)
        except (LedgerError, OSError) as e:
            skip(entry["path"], f"unreadable: {type(e).__name__}: {e}")
            continue
        records, n_dom = _front_only(entry["path"], records)
        if n_dom:
            skips["dominated"] = skips.get("dominated", 0) + n_dom
        n = 0
        for rec in records:
            if rec["status"] != "ok" or rec.get("score") is None:
                continue
            try:
                key = (space.params_key(rec["params"]), int(rec["step"]))
            except KeyError:
                continue  # same hash yet missing a dim: hand-edited; skip
            cur = merged.get(key)
            if cur is None or float(rec.get("ts") or 0.0) >= float(
                cur.get("ts") or 0.0
            ):
                merged[key] = rec
            n += 1
        total_ok += n
        exact_order.append((entry["path"], n, entry))
    exact_obs, exact_skips = observations_from_records(
        list(merged.values()), space
    )
    observations.extend(exact_obs)
    for k, v in exact_skips.items():
        skips[k] = skips.get(k, 0) + v
    for path, n, entry in exact_order:
        sources.append(
            {
                "path": path,
                "match": "exact",
                "records": n,
                "space_hash": entry.get("space_hash"),
            }
        )
    # counted unconditionally: one resumed ledger's cached re-journals
    # dedup within a SINGLE source too
    dropped = total_ok - len(merged)
    if dropped:
        skips["duplicate_params"] = skips.get("duplicate_params", 0) + dropped

    # fuzzy: per-source down-weighted low-fidelity observations
    for entry in fuzzy_entries:
        try:
            records = load_records(entry)
        except (LedgerError, OSError) as e:
            skip(entry["path"], f"unreadable: {type(e).__name__}: {e}")
            continue
        records, n_dom = _front_only(entry["path"], records)
        if n_dom:
            skips["dominated"] = skips.get("dominated", 0) + n_dom
        obs, n_skipped = fuzzy_observations(space, records)
        if not obs:
            skip(entry["path"], "fuzzy: no record encodable into the live space")
            continue
        observations.extend(obs)
        if n_skipped:
            skips["fuzzy_dropped"] = skips.get("fuzzy_dropped", 0) + n_skipped
        sources.append(
            {
                "path": entry["path"],
                "match": "fuzzy",
                "records": len(obs),
                "space_hash": entry.get("space_hash"),
            }
        )

    return Resolution(
        observations=observations, sources=sources, skips=skips, skipped=skipped
    )

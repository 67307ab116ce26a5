"""The persistent ledger-corpus index: ``corpus index DIR`` (port of
``mpi_opt_tpu/corpus/index.py``; the same document, so either package
reads the other's index).

One JSON document (``corpus-index.json`` at the corpus root) mapping
every ledger under DIR to the facts auto warm-start resolution needs
without re-reading the corpus: sweep identity ``(workload, space_hash,
algorithm)``, record/ok counts, best score, the structural space
fingerprint (corpus/match.py), and a ``(mtime_ns, size)`` freshness
stamp. Discovery reuses ``ledger/report.py:discover_ledgers`` — the
same header-sniffed walk ``report DIR`` audits with, so "what the
report sees" and "what the corpus indexes" can never drift.

Durability: the index is derived state (the ledgers are the truth), so
corruption is cheap — but a TORN index is not: a sweep resolving
``--warm-start auto:`` through half a JSON document would silently see
half a corpus. Every write goes through :func:`write_index` — tmp +
fsync + rename, the same atomic pattern as every spool status write —
and the ``corpus-index-write`` sweeplint checker makes any other write
path a lint error (the lease-checker pattern).
Reads are tolerant: an unreadable/malformed index is reported as None
and callers rebuild from discovery, never crash.

Indexing is incremental: an existing entry whose ledger's
``(mtime_ns, size)`` is unchanged is carried over without re-reading
the file, so re-indexing a thousand-ledger corpus costs one stat per
ledger plus one read per CHANGED ledger.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from mpi_opt_tpu_torch.corpus.match import fingerprint_from_records, fingerprint_from_spec
from mpi_opt_tpu_torch.ledger.report import discover_ledgers
from mpi_opt_tpu_torch.ledger.store import LedgerError, read_ledger

INDEX_VERSION = 1
INDEX_NAME = "corpus-index.json"


def index_path(corpus_dir: str) -> str:
    return os.path.join(corpus_dir, INDEX_NAME)


def write_index(path: str, doc: dict) -> None:
    """THE one legal index write: tmp + fsync + atomic rename (the
    ``corpus-index-write`` checker flags any other). A crash mid-write
    leaves the previous index intact; tmp debris is cleaned up."""
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):  # failed mid-write: no orphan debris
            os.unlink(tmp)


def read_index(corpus_dir: str) -> Optional[dict]:
    """The index document, or None when absent/unreadable/malformed —
    derived state degrades to a rebuild, never to a crash."""
    try:
        with open(index_path(corpus_dir)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or not isinstance(doc.get("entries"), list):
        return None
    try:
        if int(doc.get("version", -1)) > INDEX_VERSION:
            return None  # a newer build's index: rebuild rather than misread
    except (TypeError, ValueError):
        return None  # version: null / "x" — same rebuild-don't-crash rule
    return doc


def _stat_stamp(path: str) -> Optional[tuple]:
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_size)


def summarize_entry(path: str) -> dict:
    """One ledger -> its index entry (``error`` key when unreadable:
    the index records the problem instead of silently shrinking the
    corpus — resolution skips errored entries with an event)."""
    return summarize_entry_with_records(path)[0]


def summarize_entry_with_records(path: str) -> tuple:
    """``(entry, records)`` — the records the summary was built from
    ride along so a caller that needs both (resolve's re-read of a
    grown ledger) pays ONE file parse, not two. ``records`` is empty
    when the entry is errored."""
    stamp = _stat_stamp(path)
    entry: dict = {
        "path": os.path.abspath(path),
        "mtime_ns": None if stamp is None else stamp[0],
        "size": None if stamp is None else stamp[1],
    }
    try:
        header, records, _n_torn = read_ledger(path)
    except (LedgerError, OSError) as e:
        entry["error"] = f"{type(e).__name__}: {e}"
        return entry, []
    if header is None:
        entry["error"] = "empty ledger (no header)"
        return entry, []
    cfg = header.get("config", {})
    ok = [r for r in records if r["status"] == "ok" and r.get("score") is not None]
    best = max((float(r["score"]) for r in ok), default=None)
    spec = header.get("space_spec")
    entry.update(
        workload=cfg.get("workload"),
        algorithm=cfg.get("algorithm"),
        mode=cfg.get("mode", "driver"),
        space_hash=cfg.get("space_hash"),
        sweep_id=header.get("sweep_id"),
        records=len(records),
        ok=len(ok),
        best_score=best,
        fingerprint=(
            fingerprint_from_spec(spec)
            if spec is not None
            else fingerprint_from_records(ok)
        ),
    )
    ospec = header.get("objective_spec")
    if ospec:
        # multi-objective sweeps summarize their final
        # non-dominated front so auto warm-start can rank MO priors
        # (and resolve can seed from the front) without re-reading the
        # ledger; a malformed spec degrades to None, never a crash
        entry["pareto"] = _pareto_entry(ospec, records)
    return entry, records


def _pareto_entry(ospec, records) -> Optional[dict]:
    """Front size/objectives/hypervolume of an MO ledger's final state
    (see ``ledger/report._mo_final_rows`` for the end-state rule)."""
    import numpy as np

    from mpi_opt_tpu_torch.ledger.report import _mo_final_rows
    from mpi_opt_tpu_torch.objectives import (
        ObjectiveSpec,
        hypervolume,
        pareto_front_mask,
    )

    try:
        spec = ObjectiveSpec.from_spec(ospec)
    except (ValueError, TypeError, KeyError):
        return None
    _recs, mat = _mo_final_rows(records, spec)
    norm = np.asarray(spec.normalize(mat), dtype=np.float64)
    mask = pareto_front_mask(norm)
    return {
        "objectives": [o.get("name") for o in ospec],
        "front_size": int(mask.sum()),
        "hypervolume": float(hypervolume(norm[mask])) if mask.any() else 0.0,
    }


def build_index(corpus_dir: str, prior: Optional[dict] = None) -> dict:
    """Scan ``corpus_dir`` and build the index document, reusing
    ``prior``'s entries for ledgers whose freshness stamp is unchanged.
    The document's own ``corpus-index.json`` is never indexed (it is
    not a ledger and the sniff rejects it anyway)."""
    carried = {}
    if prior is not None:
        carried = {
            e.get("path"): e
            for e in prior.get("entries", [])
            if isinstance(e, dict)
        }
    entries = []
    for path in discover_ledgers(corpus_dir):
        path = os.path.abspath(path)
        stamp = _stat_stamp(path)
        old = carried.get(path)
        if (
            old is not None
            and stamp is not None
            and (old.get("mtime_ns"), old.get("size")) == stamp
            and "error" not in old
        ):
            entries.append(old)
            continue
        entries.append(summarize_entry(path))
    return {
        "version": INDEX_VERSION,
        "tool": "corpus-index",
        "root": os.path.abspath(corpus_dir),
        "entries": entries,
    }


def index_corpus(corpus_dir: str) -> dict:
    """Build (incrementally) and persist the index; returns the doc."""
    doc = build_index(corpus_dir, prior=read_index(corpus_dir))
    write_index(index_path(corpus_dir), doc)
    return doc

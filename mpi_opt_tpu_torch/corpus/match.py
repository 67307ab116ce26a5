"""Structural space fingerprints + fuzzy compatibility scoring (port of
``mpi_opt_tpu/corpus/match.py``).

The space HASH answers "is this the exact same search space" — the
right gate for replay and exact warm start, and the wrong one for a
corpus: widen one Uniform bound, add one hyperparameter, and a
thousand-trial ledger's evidence hashes to a stranger. The fingerprint
is the structural view the fuzzy path matches on instead: one row per
domain with its name, a coarse KIND (numeric vs choice), and bounds /
canonicalized options.

Two sources, one shape:

- ``fingerprint_from_spec`` — the authoritative form, from
  ``SearchSpace.spec()`` (ledger headers carry it as the top-level
  ``space_spec``);
- ``fingerprint_from_records`` — the inference fallback for
  pre-upgrade ledgers: names and value types from the journaled
  canonical params, bounds as the OBSERVED min/max. Honest about what
  it is (``inferred: True``): observed bounds understate the real
  domain, which only makes fuzzy admission more conservative.

Fuzzy admission is per-DIMENSION (``compat_score``: the fraction of
the live space's dims a prior fingerprint covers by name + kind) and
then per-RECORD (``encode_record``: every live dim must hold an
encodable value — a Choice value among the live options, a numeric
inside the live bounds). A prior record that falls outside the live
domain is SKIPPED, never clipped: clipping would fabricate evidence at
a boundary point the prior sweep never evaluated.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from mpi_opt_tpu_torch.algorithms.base import Observation
from mpi_opt_tpu_torch.space import Choice, IntUniform, SearchSpace, _plain

#: minimum fraction of the live space's dims a fuzzy source must cover
#: (name + kind) to be considered at all; per-record encoding then
#: enforces FULL coverage, so the threshold only prunes hopeless
#: sources before their records are read
MIN_COMPAT = 1.0


def fingerprint_from_spec(spec) -> list:
    """``SearchSpace.spec()`` rows -> fingerprint rows."""
    out = []
    for d in spec:
        row = {"name": d["name"], "kind": _kind_of_spec(d)}
        if "options" in d:
            row["options"] = list(d["options"])
        else:
            row["low"], row["high"] = d.get("low"), d.get("high")
        out.append(row)
    return out


def _kind_of_spec(d: dict) -> str:
    return "choice" if d.get("kind") == "Choice" else "numeric"


def fingerprint_from_records(records) -> list:
    """Inferred fingerprint for a pre-``space_spec`` ledger: domain
    names from the canonical params, kind from the value types, bounds
    as observed min/max (numerics) or the observed value set (others).
    Empty for a record-less ledger — nothing to infer from."""
    names: list = []
    values: dict = {}
    for rec in records:
        for name, v in (rec.get("params") or {}).items():
            if name not in values:
                names.append(name)
                values[name] = []
            values[name].append(v)
    out = []
    for name in names:
        vs = values[name]
        # bool is an int in Python, but a bool-valued dim is a Choice
        # in every space this repo builds — judge it non-numeric
        numeric = all(
            isinstance(v, (int, float)) and not isinstance(v, bool) for v in vs
        )
        row: dict = {"name": name, "inferred": True}
        if numeric:
            row["kind"] = "numeric"
            row["low"], row["high"] = min(vs), max(vs)
        else:
            row["kind"] = "choice"
            row["options"] = sorted({repr(v) for v in vs})
        out.append(row)
    return out


def compat_score(live_spec, entry_fp) -> float:
    """Fraction of the LIVE space's dims the entry fingerprint covers
    with a same-name, same-kind domain. 1.0 = every live dim has a
    structurally compatible counterpart (the prior may have EXTRA dims
    — a superset space still informs the live one); 0.0 = disjoint."""
    if not live_spec:
        return 0.0
    live = fingerprint_from_spec(live_spec)
    theirs = {row["name"]: row for row in (entry_fp or [])}
    hit = sum(
        1
        for row in live
        if theirs.get(row["name"], {}).get("kind") == row["kind"]
    )
    return hit / len(live)


def encode_record(space: SearchSpace, rec: dict) -> Optional[np.ndarray]:
    """One fuzzy-source ok record -> a unit row for ``space``, or None.

    Every live dim must be present and in-domain: Choice values must
    canonicalize to a live option, numerics must sit inside the live
    bounds (quantized Int/Choice indices included via the domains' own
    ``to_unit``). Out-of-domain records return None — skipped evidence,
    not clipped fabrication."""
    params = rec.get("params") or {}
    typed = {}
    for name, dom in space.domains.items():
        if name not in params:
            return None
        v = params[name]
        if isinstance(dom, Choice):
            for opt in dom.options:
                if _plain(opt) == v:
                    typed[name] = opt
                    break
            else:
                return None
        else:
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                return None
            lo, hi = dom.low, dom.high
            if isinstance(dom, IntUniform):
                if v != int(v):
                    return None
                v = int(v)
            if not (lo <= v <= hi):
                return None
            typed[name] = v
    return space.params_to_unit(typed)


def fuzzy_observations(
    space: SearchSpace, records, keep_frac: float = 0.5
) -> tuple[list, int]:
    """Down-weighted low-fidelity observations from a fuzzy source:
    ``(observations, n_skipped)``.

    The down-weighting is explicit and two-fold (a different-space
    prior is a HINT, and must never outweigh same-space evidence):
    only the top ``keep_frac`` of the source's encodable finite-scored
    records survive (best-first — the part of a foreign surface most
    likely to transfer), and every survivor enters at ``budget=0`` —
    the lowest fidelity, so budget-aware consumers (BOHB's per-budget
    stores) file it beneath any real evaluation and the exact-match
    EvalCache, whose key includes the budget, can never serve it as a
    result. ``n_skipped`` counts records dropped for being out of the
    live domain or non-finite."""
    encodable = []
    skipped = 0
    for rec in records:
        if rec.get("status") != "ok" or rec.get("score") is None:
            skipped += 1
            continue
        score = float(rec["score"])
        if not np.isfinite(score):
            skipped += 1
            continue
        unit = encode_record(space, rec)
        if unit is None:
            skipped += 1
            continue
        encodable.append((score, unit))
    encodable.sort(key=lambda su: su[0], reverse=True)
    keep = int(np.ceil(len(encodable) * keep_frac)) if encodable else 0
    skipped += len(encodable) - keep
    obs = [
        Observation(unit=unit, score=score, budget=0)
        for score, unit in encodable[:keep]
    ]
    return obs, skipped

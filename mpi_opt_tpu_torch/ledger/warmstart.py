"""Feed a prior sweep's ledger into a new algorithm as observations
(port of ``mpi_opt_tpu/ledger/warmstart.py``, which imports no JAX;
the port keeps its own copy).

A finished (or even half-finished) sweep's journal is evidence about
the objective surface; a NEW sweep over the SAME space should not start
blind. ``warm_start`` converts a ledger's ok records into
``Observation``s — unit-cube rows via the space's canonical params
round trip — and hands them to ``Algorithm.ingest_observations``: TPE
and BOHB build surrogate priors, random/ASHA seed their first
suggestions with the prior best (see each algorithm's override).

Warm start is CROSS-MODE: fused member records (ledger/fused.py) carry
the same canonical params / score / step fields as driver trial
records, so a fused sweep's ledger seeds a driver TPE/BOHB search and
a driver ledger seeds a fused one (the fused drivers pre-fill their
observation buffers / seed their cohorts — see each driver's
``warm_obs``). The ONLY compatibility gate is the space hash; the mode
that produced the observations is irrelevant to their evidence value.

Space compatibility is checked by HASH, not by hope: a ledger written
for a different space would decode its params into the wrong unit
coordinates and silently poison the new search, so a mismatch raises.
WITHIN a hash-matched ledger, individual records that cannot inform
the search — non-ok status, a missing score, a Choice value no live
option canonicalizes to — are SKIPPED and COUNTED (``skips``), not
silently dropped and not fatal: one bit-rotted record must not refuse
the other thousand, but the ``warm_start`` event must say how many
records the prior lost on the way in.
"""

from __future__ import annotations

from mpi_opt_tpu_torch.algorithms.base import Algorithm, Observation
from mpi_opt_tpu_torch.ledger.store import LedgerError, read_ledger
from mpi_opt_tpu_torch.space import Choice, _plain

#: the per-record skip reasons ``observations_from_records`` counts —
#: one shared shape so every ``warm_start`` event payload agrees
SKIP_REASONS = ("not_ok", "bad_choice")


def _decode_params(space, params: dict) -> dict:
    """Journaled canonical params -> live typed params for ``space``.

    Scalars round-trip as-is; Choice options were canonicalized through
    ``_plain`` (exotic objects became their repr), so decoding matches
    each journaled value against the canonical form of the live options
    instead of feeding a repr STRING to ``value_to_index``.
    """
    out = dict(params)
    for name, dom in space.domains.items():
        if not isinstance(dom, Choice):
            continue
        v = params[name]
        for opt in dom.options:
            if _plain(opt) == v:
                out[name] = opt
                break
        else:
            raise LedgerError(
                f"params[{name!r}] = {v!r} matches no option of {dom.options} "
                "(same space hash but un-decodable Choice value)"
            )
    return out


def observations_from_records(records, space) -> tuple[list, dict]:
    """ok trial records (ledger JSON shape) -> ``(observations, skips)``.

    ``skips`` counts the records that could NOT become observations,
    by reason: ``not_ok`` (failed/timeout status or a missing score —
    nothing to learn from) and ``bad_choice`` (a Choice value no live
    option canonicalizes to: the hash matched but the record predates
    an option's repr change, or was hand-edited). Counting instead of
    raising keeps one damaged record from refusing a thousand good
    ones, while the caller's ``warm_start`` event carries the honest
    loss tally instead of a silently shorter observation list.
    """
    obs: list[Observation] = []
    skips = {k: 0 for k in SKIP_REASONS}
    for rec in records:
        if rec["status"] != "ok" or rec.get("score") is None:
            skips["not_ok"] += 1
            continue
        try:
            decoded = _decode_params(space, rec["params"])
        except LedgerError:
            skips["bad_choice"] += 1
            continue
        vec = rec.get("scores")
        obs.append(
            Observation(
                unit=space.params_to_unit(decoded),
                score=float(rec["score"]),
                budget=int(rec["step"]),
                # the optional objective vector rides along so the
                # all-finite guard below can see it; None entries stay
                # None — the guard treats them as non-finite
                scores=None
                if vec is None
                else tuple(None if v is None else float(v) for v in vec),
            )
        )
    return obs, {k: v for k, v in skips.items() if v}


def load_observations(path: str, space) -> tuple[list, dict]:
    """A ledger's ok records as Observations for ``space``:
    ``(observations, skips)`` (see ``observations_from_records``).

    Raises LedgerError when the ledger has no header or was written for
    a space whose hash differs from ``space``'s.
    """
    header, records, _ = read_ledger(path)
    if header is None:
        raise LedgerError(f"{path}: empty ledger, nothing to warm-start from")
    theirs = header.get("config", {}).get("space_hash")
    ours = space.space_hash()
    if theirs != ours:
        raise LedgerError(
            f"{path}: ledger space hash {theirs!r} != this search's {ours!r} "
            "— the prior sweep ran over a different search space, and its "
            "params would decode into the wrong unit coordinates"
        )
    return observations_from_records(records, space)


def observation_fully_finite(o) -> bool:
    """True when every numeric fact of the observation is finite: the
    scalar score AND — for multi-objective priors — every entry of its
    ``scores`` vector. A NaN in ANY objective disqualifies the record
    from seeding: the scalarized score of a partially-diverged trial
    can look healthy while the trial itself is exactly what a new sweep
    must not start at."""
    import numpy as np

    if not np.isfinite(o.score):
        return False
    if getattr(o, "scores", None) is not None:
        return all(
            v is not None and np.isfinite(v) for v in o.scores
        )
    return True


def best_observation(observations) -> "Observation | None":
    """The highest FINITE-scored prior observation, or None — the point
    the sampler-family consumers (driver random/ASHA, fused cohort
    seeding) start from. Non-finite priors never seed (see
    ``observation_fully_finite`` for the vector-score generalization):
    a diverged prior point is exactly what a new sweep must not start
    at."""
    finite = [o for o in observations if observation_fully_finite(o)]
    return max(finite, key=lambda o: o.score) if finite else None


def warm_start(algorithm: Algorithm, path: str) -> int:
    """Ingest a prior ledger into ``algorithm``; returns how many
    observations actually informed it (the algorithm's own count)."""
    obs, _skips = load_observations(path, algorithm.space)
    return algorithm.ingest_observations(obs)

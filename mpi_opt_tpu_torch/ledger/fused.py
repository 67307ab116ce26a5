"""Boundary-granular member journaling for fused on-device sweeps (port
of ``mpi_opt_tpu/ledger/fused.py``: the records, trial ids and the
resume check's tolerance are the JAX package's).

A fused sweep evaluates its whole population on the device, so there
is no per-trial host loop to journal from. ``FusedJournal`` journals ONE
record per population member at every natural boundary (a PBT
generation) into the same versioned ``SweepLedger`` schema the driver
path uses: member id, canonical params (decoded from the member's unit
row), score, budget, and a status derived from the score's finiteness.

Ordering contract (the fused twin of the driver's fsync-before-report
invariant): a boundary's records are journaled BEFORE that boundary's
snapshot is saved, so the journal can never lag the snapshot it will
be replayed against. Consequences:

- the only append-crash damage shape is a torn FINAL boundary (no
  snapshot covers it — ``SweepLedger`` truncates it on load and the
  resumed sweep re-trains + re-journals it);
- on resume, every boundary the restored snapshot records as complete
  must already be fully journaled (``require_prefix``) — a journal
  BEHIND its snapshot is a hole in the audit trail that nothing can
  reconstruct, and is refused;
- a boundary that is re-computed on resume but already journaled is
  VERIFIED against the journal instead of re-written (fused resumes
  are deterministic): any divergence raises ``LedgerError``. The
  snapshot stays authoritative for optimizer state; the ledger stays
  authoritative for the audit trail.

Offsets make one ledger span a composite sweep: fused Hyperband runs
one ``fused_sha`` a bracket, each journaling under its bracket's
``boundary_offset`` (global rung index), ``trial_offset`` (global record
index) and ``member_offset`` (global trial identity), so the whole sweep
reads as one contiguous boundary sequence. A multi-objective sweep's
records carry each member's raw objective vector as ``scores`` beside
the scalarized ``score``; a scalar sweep's carry no such key.
"""

from __future__ import annotations

import numpy as np

from mpi_opt_tpu_torch.ledger.store import LedgerError, SweepLedger, scan_boundaries


class FusedJournal:
    """One fused sweep's (or bracket's) member-granular journal view."""

    def __init__(self, ledger: SweepLedger, space, boundary_offset: int = 0,
                 trial_offset: int = 0, member_offset: int = 0):
        self.ledger = ledger
        self.space = space
        self.boundary_offset = int(boundary_offset)
        self.trial_offset = int(trial_offset)
        self.member_offset = int(member_offset)
        self.written = 0  # member records appended by this process
        self.verified = 0  # member records re-verified on resume
        # a fresh load already refused structurally-damaged journals and
        # truncated a torn final boundary — but an OPEN ledger re-entered
        # after an error escaped mid-boundary (the CLI's --retries path)
        # still holds the partial boundary in memory: apply the same
        # self-heal here, so the retry re-journals it instead of
        # misreading it as a sweep-shape divergence
        ledger.drop_torn_boundary()
        self._by_boundary, self._sizes, _problems, _torn = scan_boundaries(
            ledger.records
        )

    # -- resume consistency ------------------------------------------------

    def complete_prefix(self) -> int:
        """The largest N with boundaries [0, N) all fully journaled."""
        n = 0
        while n in self._by_boundary and len(self._by_boundary[n]) == self._sizes[n]:
            n += 1
        return n

    def boundary_done(self, b_local: int) -> bool:
        b = self.boundary_offset + int(b_local)
        return b in self._by_boundary and len(self._by_boundary[b]) == self._sizes[b]

    def require_prefix(self, n_local: int) -> None:
        """Refuse a resume whose snapshot is AHEAD of the journal: the
        snapshot records ``n_local`` boundaries (past this view's offset)
        complete, but the journal does not hold them all — an audit hole
        the sweep cannot reconstruct (those boundaries will never be
        re-computed). The inverse — journal ahead of snapshot — is fine:
        the re-trained boundaries verify against their records."""
        need = self.boundary_offset + int(n_local)
        have = self.complete_prefix()
        if have < need:
            raise LedgerError(
                f"{self.ledger.path}: snapshot records {need} boundaries "
                f"complete but only {have} are fully journaled — the ledger "
                "lags the snapshot it should never lag (mixed files, or a "
                "ledger attached mid-sweep). Point --ledger at the journal "
                "this sweep has written from its start, or at a fresh path "
                "without --resume"
            )

    # -- the per-boundary service point ------------------------------------

    def record_boundary(self, b_local: int, members, units, scores, step: int,
                        scores_mo=None) -> None:
        """Journal (or verify) one boundary's member records.

        ``members`` are the boundary's member identities (local: the
        journal applies ``member_offset``), ``units``
        their unit-cube rows, ``scores`` their evaluation scores,
        ``step`` the budget the scores were measured at. First visit
        appends one fsync'd record per member; a re-computed boundary
        (resume) verifies status/score against the journal instead —
        divergence raises ``LedgerError`` (the journal belongs to a
        different trajectory).

        ``scores_mo`` (optional raw ``[n, m]`` objective matrix) rides
        each record as its ``scores`` vector; ``scores`` stays the
        authoritative scalarized value, so every scalar consumer reads a
        multi-objective journal unchanged.
        """
        b = self.boundary_offset + int(b_local)
        members = [int(m) for m in np.asarray(members).tolist()]
        scores = np.asarray(scores, dtype=np.float64)
        units = np.asarray(units)
        if scores_mo is not None:
            scores_mo = np.asarray(scores_mo, dtype=np.float64)
        existing = self._by_boundary.get(b)
        if existing is not None:
            self._verify(b, members, scores, scores_mo)
            return
        # trial ids are the journal's record ordinals, derived from the
        # already-journaled boundaries of THIS view so a resume that
        # skipped straight past completed boundaries still numbers
        # identically to an uninterrupted run
        base = self.trial_offset + sum(
            len(self._by_boundary[k]) for k in self._by_boundary if self.boundary_offset <= k < b
        )
        grp: dict[int, dict] = {}
        for i, m in enumerate(members):
            rec = self.ledger.record_member(
                trial_id=base + i,
                member=self.member_offset + m,
                boundary=b,
                boundary_size=len(members),
                canonical_params=self.space.canonical_params(
                    self.space.materialize_row(units[i])
                ),
                score=scores[i],
                step=step,
                scores=None if scores_mo is None else scores_mo[i],
            )
            grp[self.member_offset + m] = rec
        self._by_boundary[b] = grp
        self._sizes[b] = len(members)
        self.written += len(members)

    def _verify(self, b: int, members, scores, scores_mo=None) -> None:
        """The resume cross-check: a re-computed boundary must match its
        journal. Scores compare with a small tolerance (resumes are
        bit-identical on CPU, documented-equivalent where accelerator
        compiled-shape rounding differs); member sets and statuses
        compare exactly. A re-computed objective vector verifies against
        the journaled ``scores`` vector the same way (vectors are
        journaled on ok records only)."""
        existing = self._by_boundary[b]
        if len(existing) != len(members):
            raise LedgerError(
                f"boundary {b}: journal holds {len(existing)} member records "
                f"but the sweep re-computed {len(members)} — the ledger "
                "belongs to a different sweep shape"
            )
        for i, m in enumerate(members):
            mg = self.member_offset + int(m)
            rec = existing.get(mg)
            if rec is None:
                raise LedgerError(
                    f"boundary {b}: member {mg} re-computed but not in the "
                    "journal — member sets diverge"
                )
            s = float(scores[i])
            finite = np.isfinite(s)
            if scores_mo is not None:
                finite = finite and bool(np.all(np.isfinite(scores_mo[i])))
            status = "ok" if finite else "failed"
            if rec["status"] != status:
                raise LedgerError(
                    f"boundary {b} member {mg}: journaled status "
                    f"{rec['status']!r} but the re-computed score is "
                    f"{s!r} — the ledger diverges from this sweep's "
                    "trajectory (different seed/config/data?)"
                )
            if status == "ok" and not np.isclose(
                float(rec["score"]), s, rtol=1e-5, atol=1e-6
            ):
                raise LedgerError(
                    f"boundary {b} member {mg}: journaled score "
                    f"{rec['score']} but re-computed {s} — the ledger "
                    "diverges from this sweep's trajectory"
                )
            if status == "ok" and scores_mo is not None and rec.get("scores") is not None:
                want = np.asarray([float(v) for v in rec["scores"]])
                got = np.asarray(scores_mo[i], dtype=np.float64)
                if want.shape != got.shape or not np.allclose(want, got, rtol=1e-5, atol=1e-6):
                    raise LedgerError(
                        f"boundary {b} member {mg}: journaled objective vector "
                        f"{want.tolist()} but re-computed {got.tolist()} — the ledger "
                        "diverges from this sweep's trajectory"
                    )
        self.verified += len(members)


def make_journal(ledger, space, **offsets):
    """``FusedJournal`` over ``ledger``, or None when no ledger is
    active."""
    if ledger is None:
        return None
    return FusedJournal(ledger, space, **offsets)

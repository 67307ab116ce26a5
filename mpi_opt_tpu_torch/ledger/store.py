"""Append-only, crash-safe journal of trial evaluations (port of
``mpi_opt_tpu/ledger/store.py``, which imports no JAX; copied whole so
that both packages write and read the same files).

File format (one JSON object per line):

- line 1 — the HEADER record: ``{"kind": "header", "version": N,
  "sweep_id": ..., "config": {...}, "created_ts": ...}``. ``config``
  captures the sweep's identity (algorithm, workload, backend, seed,
  space_hash, capacity, ...): a resume whose live config differs is a
  DIFFERENT sweep and is refused, because replaying its records through
  a differently-configured algorithm would silently corrupt the search.
- every later line — one FINAL trial record: ``{"kind": "trial",
  "trial_id", "params" (canonical, see SearchSpace.canonical_params),
  "status" (ok|failed|timeout), "score" (null when non-finite — JSON has
  no NaN), "step", "error", "attempts", "wall_s", "cached", "ts"}``.
  FINAL means post-retry: the driver journals exactly one record per
  completed trial, after its FailurePolicy has resolved.

FUSED sweeps journal through the SAME schema at member granularity
(``ledger/fused.py``): their trial records additionally carry
``member`` (population/cohort row identity), ``boundary`` (the global
index of the natural boundary that produced the evaluation — PBT
generation, SHA/BOHB rung, TPE batch) and ``boundary_size`` (how many
member records that boundary journals), and their header ``config``
marks ``mode: "fused"`` plus the boundary ``granularity``. One boundary
is journaled as one contiguous block, so the only damage an append-kill
can leave is a TORN FINAL BOUNDARY (fewer than ``boundary_size``
records for the last boundary) — recoverable exactly like a torn tail
line, because the journal-before-snapshot ordering guarantees no
snapshot ever covers a partially-journaled boundary.

Durability contract: each record is flushed AND fsync'd before the
driver reports it to the algorithm (fused: before the boundary's
snapshot is saved), so the journal can never lag the search state it
will be replayed into. Recovery is tolerant of exactly the failures
append-fsync can produce — a TORN FINAL LINE (the process died
mid-write): the tail fragment is truncated away on load and the
journal continues from the last complete record; and, for fused
journals, a TORN FINAL BOUNDARY (the process died between a boundary's
member records), truncated the same way. A malformed line — or a
partially-journaled boundary — anywhere ELSE means the file was edited
or mixed with another stream, and loading refuses rather than guessing.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import uuid
from typing import Optional, Sequence

import numpy as np

from mpi_opt_tpu_torch.obs import trace
from mpi_opt_tpu_torch.trial import TrialResult, failed_result

LEDGER_SCHEMA_VERSION = 1


class LedgerError(ValueError):
    """Malformed or incompatible ledger content."""


def sniff_header(path: str) -> Optional[dict]:
    """Line 1 parsed as a ledger header record, else None — the ONE
    home for the "is this .jsonl file a ledger?" convention that both
    ``report``'s directory discovery and ``fsck``'s sibling
    auto-detection gate on (a metrics stream is also one-JSON-per-line,
    so the kind check, not the extension, is what identifies a ledger).
    The first line is capped at 1 MB: a real header is a few hundred
    bytes, and an arbitrary single-line .jsonl file should cost a
    bounded read to reject."""
    try:
        with open(path, "r") as f:
            first = json.loads(f.readline(1_000_000))
    except (OSError, ValueError):
        return None
    if isinstance(first, dict) and first.get("kind") == "header":
        return first
    return None


def _check_shape(rec, lineno: int) -> dict:
    if not isinstance(rec, dict) or "kind" not in rec:
        raise LedgerError(f"line {lineno}: not a ledger record (no 'kind')")
    return rec


def _check_trial_record(rec: dict, lineno: int) -> None:
    missing = [k for k in ("trial_id", "params", "status", "step") if k not in rec]
    if missing:
        raise LedgerError(f"line {lineno}: trial record missing {missing}")
    if rec["status"] not in ("ok", "failed", "timeout"):
        raise LedgerError(f"line {lineno}: unknown status {rec['status']!r}")
    if rec["status"] == "ok" and not isinstance(rec.get("score"), (int, float)):
        raise LedgerError(f"line {lineno}: ok record without a numeric score")
    if rec.get("scores") is not None:
        # the optional multi-objective vector: absent on every
        # scalar record forever; when present it must be a list of
        # numbers — an ok record's objectives are all finite by the
        # journaling rule, so null entries only belong on failed records
        scores = rec["scores"]
        if not isinstance(scores, list) or not scores:
            raise LedgerError(
                f"line {lineno}: 'scores' must be a non-empty list when present"
            )
        bad = [
            s for s in scores
            if isinstance(s, bool)  # JSON true/false is drift, not a score
            or not (s is None or isinstance(s, (int, float)))
        ]
        if bad:
            raise LedgerError(
                f"line {lineno}: non-numeric entries in 'scores': {bad!r}"
            )
        if rec["status"] == "ok" and any(s is None for s in scores):
            raise LedgerError(
                f"line {lineno}: ok record with a null objective in 'scores'"
            )
    if "boundary" in rec:
        fused_missing = [k for k in ("member", "boundary_size") if k not in rec]
        if fused_missing:
            raise LedgerError(
                f"line {lineno}: fused member record missing {fused_missing}"
            )


def scan_boundaries(records: Sequence[dict]):
    """Group fused member records by boundary and judge the grouping.

    Returns ``(by_boundary, sizes, problems, torn_final)``:
    ``by_boundary`` maps boundary index -> {member: record}; ``sizes``
    maps boundary -> its declared ``boundary_size``; ``problems`` lists
    structural damage that append-crash CANNOT produce (a hand-edited
    or mixed file); ``torn_final`` is the final boundary's index when
    it is partially journaled — the ONE shape a mid-journal kill leaves
    (recoverable: the journal-before-snapshot ordering means no
    snapshot covers it) — else None.

    Rules enforced: fused and driver records never mix in one journal;
    boundary indices are non-decreasing and contiguous blocks (a
    boundary never resumes after another started); within a boundary,
    ``boundary_size`` is consistent, members are unique, and the count
    never exceeds the declared size; boundary 0 exists and indices have
    no gaps; only the FINAL boundary may be short.
    """
    by_boundary: dict[int, dict[int, dict]] = {}
    sizes: dict[int, int] = {}
    problems: list[str] = []
    last_b = None
    saw_driver = False
    for rec in records:
        if "boundary" not in rec:
            saw_driver = True
            if by_boundary:
                problems.append(
                    f"trial {rec['trial_id']}: driver record mixed into a "
                    "fused member journal"
                )
            continue
        if saw_driver and not by_boundary:
            # the mirror order (driver records first) is the same mixed
            # file and must be refused the same way
            problems.append(
                f"trial {rec['trial_id']}: fused member record mixed "
                "into a driver journal"
            )
        b = int(rec["boundary"])
        m = int(rec["member"])
        size = int(rec["boundary_size"])
        if last_b is not None and b < last_b:
            problems.append(
                f"boundary {b}: records out of order (after boundary {last_b})"
            )
        if b in by_boundary and last_b != b:
            problems.append(
                f"boundary {b}: non-contiguous (resumes after boundary {last_b})"
            )
        grp = by_boundary.setdefault(b, {})
        if b in sizes and sizes[b] != size:
            problems.append(
                f"boundary {b}: inconsistent boundary_size "
                f"({sizes[b]} vs {size})"
            )
        sizes.setdefault(b, size)
        if m in grp:
            problems.append(f"boundary {b}: member {m} journaled twice")
        grp[m] = rec
        if len(grp) > sizes[b]:
            problems.append(
                f"boundary {b}: {len(grp)} member records exceed the "
                f"declared boundary_size {sizes[b]}"
            )
        last_b = b
    torn_final = None
    if by_boundary:
        order = sorted(by_boundary)
        if order != list(range(order[-1] + 1)):
            problems.append(
                "boundary indices are not the contiguous range "
                f"0..{order[-1]}: missing "
                f"{sorted(set(range(order[-1] + 1)) - set(order))}"
            )
        for b in order:
            if len(by_boundary[b]) < sizes[b]:
                if b == last_b:
                    torn_final = b
                else:
                    problems.append(
                        f"boundary {b}: only {len(by_boundary[b])}/{sizes[b]} "
                        "member records journaled mid-file"
                    )
    return by_boundary, sizes, problems, torn_final


def read_ledger(path: str, strict: bool = False):
    """(header, trial_records, n_torn) from a ledger file.

    ``strict=False`` (load-for-resume): a torn FINAL line is dropped
    (n_torn=1) — the one shape an append-crash leaves behind. Torn
    means NOT-VALID-JSON specifically: a prefix of a longer JSON line
    can never itself parse (the closing brace is the last byte), so
    decode failure on the tail is the append-crash signature. A tail
    line that PARSES but fails schema checks was written whole by
    something else — edited, or another tool — and refuses to load
    like any other malformed line (truncating it would destroy a
    completed trial's data). ``strict=True`` (validate mode): every
    line must parse, including the tail.
    """
    header: Optional[dict] = None
    records: list[dict] = []
    with open(path, "r") as f:
        lines = f.read().split("\n")
    if lines and lines[-1] == "":
        lines.pop()  # the trailing newline of a cleanly-written file
    for i, raw in enumerate(lines):
        lineno = i + 1
        is_tail = i == len(lines) - 1
        try:
            rec = json.loads(raw)
        except json.JSONDecodeError as e:
            if strict or not is_tail:
                raise LedgerError(
                    f"line {lineno}: not valid JSON ({e.msg})"
                ) from None
            return header, records, 1
        _check_shape(rec, lineno)
        if rec["kind"] == "header":
            if lineno != 1:
                raise LedgerError(f"line {lineno}: header must be line 1")
            if int(rec.get("version", -1)) > LEDGER_SCHEMA_VERSION:
                raise LedgerError(
                    f"ledger schema v{rec['version']} is newer than this "
                    f"build's v{LEDGER_SCHEMA_VERSION}"
                )
            header = rec
        elif rec["kind"] == "trial":
            _check_trial_record(rec, lineno)
            records.append(rec)
        else:
            raise LedgerError(f"line {lineno}: unknown kind {rec['kind']!r}")
    if lines and header is None:
        raise LedgerError("line 1: not a ledger header")
    return header, records, 0


def validate_ledger(path: str) -> list[str]:
    """Strict schema check; returns human-readable problems (empty = ok)."""
    problems: list[str] = []
    try:
        header, records, _ = read_ledger(path, strict=True)
    except LedgerError as e:
        return [str(e)]
    except OSError as e:
        return [f"unreadable: {e}"]
    if header is None:
        problems.append("empty ledger (no header record)")
    seen: set = set()
    for rec in records:
        tid = rec["trial_id"]
        if tid in seen:
            problems.append(f"trial {tid}: duplicated final record")
        seen.add(tid)
    if any("boundary" in r for r in records):
        # fused member journal: the boundary-granular invariants are
        # part of the schema — a torn FINAL boundary is flagged here
        # (strict mode reports damage; the resume path self-heals it)
        _by, sizes, b_problems, torn_final = scan_boundaries(records)
        problems += b_problems
        if torn_final is not None:
            problems.append(
                f"boundary {torn_final}: torn ({len(_by[torn_final])}/"
                f"{sizes[torn_final]} member records — killed mid-journal; "
                "a --resume truncates and re-journals it)"
            )
    return problems


def result_from_record(rec: dict) -> TrialResult:
    """Reconstruct the FINAL TrialResult a trial record journals.

    Non-ok records come back through ``failed_result`` (the one
    construction point for failures), so a replayed failure is
    indistinguishable from a live one to the algorithm.
    """
    if rec["status"] != "ok":
        return failed_result(
            trial_id=int(rec["trial_id"]),
            step=int(rec["step"]),
            error=rec.get("error") or "replayed failure",
            status=rec["status"],
            wall_time=float(rec.get("wall_s") or 0.0),
        )
    return TrialResult(
        trial_id=int(rec["trial_id"]),
        score=float(rec["score"]),
        step=int(rec["step"]),
        wall_time=float(rec.get("wall_s") or 0.0),
        extra={"replayed": True},
    )


class SweepLedger:
    """One sweep's durable journal, opened for append.

    Loading truncates a torn tail line IN PLACE (so the next append
    starts on a clean line boundary) and exposes the completed records
    for replay. ``ensure_header`` writes the header on a fresh file and
    verifies identity on an existing one.

    ``read_only=True`` is the multi-process SPMD posture (rank-0-only
    journaling): non-zero ranks run the same deterministic driver loop
    over the SHARED journal — they must replay/verify it identically —
    but N ranks fsync-appending one file would interleave records and
    corrupt the stream, so only rank 0 writes. A read-only ledger keeps
    the full in-memory view (header checks, ``completed()``,
    ``record_trial`` bookkeeping) while never touching the file: no
    append handle, no torn-tail truncation (rank 0 owns repairs), no
    header/record writes.
    """

    def __init__(self, path: str, read_only: bool = False):
        self.path = os.path.abspath(path)
        self.read_only = bool(read_only)
        self.header: Optional[dict] = None
        self.records: list[dict] = []
        self.n_torn = 0
        self.n_torn_boundary = 0  # member records of a torn final boundary
        if os.path.exists(self.path) and os.path.getsize(self.path) > 0:
            self.header, self.records, self.n_torn = read_ledger(self.path)
            self._drop_torn_boundary()
            if (self.n_torn or self.n_torn_boundary) and not self.read_only:
                self._rewrite_complete_records()
        self._defer_fsync = False
        if self.read_only:
            self._file = None
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._file = open(self.path, "a")

    def _drop_torn_boundary(self) -> None:
        """Fused journals only: a partially-journaled FINAL boundary is
        the mid-journal-kill shape — drop its records so replay sees
        only complete boundaries (the interrupted boundary re-trains
        from its snapshot and re-journals identically; the ordering
        contract guarantees no snapshot covers the partial one). Any
        OTHER boundary damage cannot come from an append crash and
        refuses to load. Records are dropped from the in-memory view on
        every rank; only a writable (rank-0) ledger rewrites the file.
        """
        if not any("boundary" in r for r in self.records):
            return
        by_boundary, _sizes, problems, torn_final = scan_boundaries(self.records)
        if problems:
            raise LedgerError(
                f"{self.path}: fused boundary structure is damaged beyond "
                f"what an append crash can produce ({problems[0]}) — "
                "refusing to load"
            )
        if torn_final is None:
            return
        keep = [
            r for r in self.records
            if int(r.get("boundary", -1)) != torn_final
        ]
        self.n_torn_boundary += len(self.records) - len(keep)
        self.records = keep

    def drop_torn_boundary(self) -> int:
        """Self-heal a torn final boundary on an OPEN ledger: the
        in-process twin of the load-time truncation, for callers that
        re-enter a fused sweep with the same ledger object after an
        error escaped mid-boundary (the CLI's --retries does exactly
        this when a transient runtime failure strikes during a
        boundary's journaling) — without it, the re-run would
        misdiagnose the partial boundary as a sweep-shape divergence.
        Drops the records from memory AND rewrites the file (reopening
        the append handle — the rewrite replaces the inode). Returns
        how many records were dropped."""
        before = len(self.records)
        self._drop_torn_boundary()
        dropped = before - len(self.records)
        if dropped and not self.read_only and self._file is not None:
            self._file.close()
            self._rewrite_complete_records()
            self._file = open(self.path, "a")
        return dropped

    def _rewrite_complete_records(self) -> None:
        # keep exactly the bytes of the complete records (torn tail
        # fragment and torn-final-boundary lines dropped); the debris
        # must not prefix the next append
        good = [json.dumps(self.header)] if self.header else []
        good += [json.dumps(r) for r in self.records]
        # rewrite-then-replace, not open('w'): a second crash here must
        # not tear the GOOD records too
        tmp = f"{self.path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            f.write("".join(line + "\n" for line in good))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    # -- identity ----------------------------------------------------------

    @property
    def sweep_id(self) -> Optional[str]:
        return None if self.header is None else self.header.get("sweep_id")

    def ensure_header(self, config: dict, space_spec=None, objective_spec=None) -> None:
        """Write the header (fresh ledger) or verify it (existing one).

        ``config`` is the sweep's identity dict; on an existing ledger a
        mismatch on any shared key is refused — the caller is about to
        replay this journal through an algorithm configured differently
        than the one that wrote it.

        ``space_spec`` (``SearchSpace.spec()``) rides the header as a
        TOP-LEVEL key, deliberately outside ``config``: it is corpus
        metadata (the structural fingerprint ``corpus index`` uses for
        fuzzy matching between different-hash spaces), not identity —
        the hash in ``config`` already settles identity, and folding
        the spec into the checked dict would refuse every pre-upgrade
        ledger's resume over a key it never wrote.

        ``objective_spec`` (``ObjectiveSpec.spec()``) follows
        the same top-level pattern for multi-objective sweeps: the
        report/corpus layers read it to interpret each record's
        ``scores`` vector, while identity stays in ``config`` (the CLI
        puts the objective names there, so resuming a multi-objective
        ledger under different objectives is refused through the
        ordinary config gate). Scalar sweeps never write the key.
        """
        if self.header is not None:
            stale = {
                k: (self.header.get("config", {}).get(k), v)
                for k, v in config.items()
                if self.header.get("config", {}).get(k) != v
            }
            if stale:
                diff = ", ".join(
                    f"{k}: ledger={a!r} vs run={b!r}" for k, (a, b) in stale.items()
                )
                raise LedgerError(
                    f"ledger {self.path} was written by a different sweep "
                    f"({diff}) — resume with the original configuration or "
                    "point --ledger at a fresh path"
                )
            return
        self.header = {
            "kind": "header",
            "version": LEDGER_SCHEMA_VERSION,
            "sweep_id": uuid.uuid4().hex[:12],
            "config": dict(config),
            "created_ts": round(time.time(), 4),
        }
        if space_spec is not None:
            self.header["space_spec"] = space_spec
        if objective_spec is not None:
            self.header["objective_spec"] = objective_spec
        if not self.read_only:
            self._write_line(self.header)

    # -- append ------------------------------------------------------------

    @contextlib.contextmanager
    def batched(self):
        """Amortize the per-record fsync over a batch of appends: inside
        this block ``_write_line`` writes+flushes each record but defers
        the fsync; exit fsyncs ONCE, so the whole batch becomes durable
        together. This is the HTTP front door's journal-before-ack at
        batch granularity (the answer is published only after the block
        exits). Crash-safety shape: a kill mid-batch leaves a flushed
        prefix (page cache survives a process SIGKILL) and possibly a
        torn tail — exactly the damage the load-time torn-tail self-heal
        already recovers, and the client's idempotent retry re-journals
        whatever the prefix lost. Not reentrant; single-writer only
        (the front door's one executor thread)."""
        if self._defer_fsync:
            raise LedgerError("ledger.batched() does not nest")
        self._defer_fsync = True
        try:
            yield self
        finally:
            self._defer_fsync = False
            if self._file is not None:
                try:
                    self._file.flush()
                    os.fsync(self._file.fileno())
                except OSError as e:
                    from mpi_opt_tpu_torch.utils import resources

                    if resources.is_storage_full(e):
                        raise resources.StorageFull(
                            "ledger batch fsync hit a full disk; free "
                            "disk space and relaunch with --resume",
                            path=self.path,
                        ) from e
                    raise

    def record_trial(
        self,
        result: TrialResult,
        canonical_params: dict,
        attempts: int = 1,
        cached: bool = False,
        meta: Optional[dict] = None,
    ) -> dict:
        """Journal one FINAL result; durable (fsync) before returning,
        traced as a ``journal`` span."""
        if self.header is None:
            raise LedgerError("ledger has no header — call ensure_header first")
        score = float(result.score)
        rec = {
            "kind": "trial",
            "sweep_id": self.sweep_id,
            "trial_id": int(result.trial_id),
            "params": canonical_params,
            "status": result.status,
            # JSON has no NaN: non-finite scores journal as null, and
            # status carries the failure; result_from_record restores
            # the NaN-family score via failed_result
            "score": score if np.isfinite(score) else None,
            "step": int(result.step),
            "error": result.error,
            "attempts": int(attempts),
            "wall_s": round(float(result.wall_time), 4),
            "cached": bool(cached),
            "ts": round(time.time(), 4),
        }
        if meta:
            # extra provenance keys (the front door's idem_key/idem_op)
            # ride the record but may not shadow the trial schema
            for k, v in meta.items():
                if k not in rec:
                    rec[k] = v
        if not self.read_only:
            with trace.span("journal", n=1):
                self._write_line(rec)
        # read-only ranks still track the record in memory: completed()
        # and the dedup views must agree with rank 0's across the gang
        self.records.append(rec)
        return rec

    def record_member(
        self,
        *,
        trial_id: int,
        member: int,
        boundary: int,
        boundary_size: int,
        canonical_params: dict,
        score,
        step: int,
        scores=None,
    ) -> dict:
        """Journal one fused population member's boundary evaluation
        (``ledger/fused.py`` drives this); durable before returning.

        Status derives from the score's finiteness — the same rule the
        fused trainers' member-failure tallies apply: a non-finite
        member score is the fused divergence failure, journaled as
        ``failed`` with a null score so JSON stays strict.

        ``scores`` (optional raw objective vector): a
        non-finite value in ANY objective makes the whole record
        ``failed`` with null score/scores — the scalar ``score``
        remains authoritative (it is the spec-scalarized value), the
        vector rides beside it for the Pareto consumers. Scalar sweeps
        never pass it, so their records carry no ``scores`` key at all
        and stay byte-identical to scalar journaling.
        """
        if self.header is None:
            raise LedgerError("ledger has no header — call ensure_header first")
        score = float(score)
        finite = np.isfinite(score)
        if scores is not None:
            vec = [float(s) for s in scores]
            finite = finite and all(np.isfinite(v) for v in vec)
        rec = {
            "kind": "trial",
            "sweep_id": self.sweep_id,
            "trial_id": int(trial_id),
            "member": int(member),
            "boundary": int(boundary),
            "boundary_size": int(boundary_size),
            "params": canonical_params,
            "status": "ok" if finite else "failed",
            "score": score if finite else None,
            "step": int(step),
            "error": None
            if finite
            else (
                "non-finite member score"
                if scores is None
                else "non-finite member objective"
            ),
            "attempts": 1,
            # member evaluations share one fused boundary program; no
            # per-member wall exists (the boundary's wall lives in the
            # sweep result's launch_walls/gen_walls)
            "wall_s": 0.0,
            "cached": False,
            "ts": round(time.time(), 4),
        }
        if scores is not None:
            rec["scores"] = vec if finite else None
        if not self.read_only:
            self._write_line(rec)
        self.records.append(rec)
        return rec

    def _write_line(self, rec: dict) -> None:
        from mpi_opt_tpu_torch.utils import resources

        try:
            # chaos seam (inject_enospc): inside the append+fsync path
            # so drills strike exactly where a real full disk would
            resources.disk_fault("ledger_fsync", self.path)
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
            if not self._defer_fsync:
                os.fsync(self._file.fileno())
        except OSError as e:
            if resources.is_storage_full(e):
                # a full disk is an ANSWER, not a retryable blip: park
                # with the classified type (CLI -> EX_IOERR=74). The
                # append may have torn this line — the torn-tail
                # self-heal already recovers exactly that shape on the
                # post-free --resume
                raise resources.StorageFull(
                    "ledger journal append hit a full disk; free disk "
                    "space and relaunch with --resume",
                    path=self.path,
                ) from e
            raise

    # -- replay view -------------------------------------------------------

    def completed(self) -> dict[int, dict]:
        """trial_id -> FINAL record (ok or failed) for replay-resume."""
        return {int(r["trial_id"]): r for r in self.records}

    def ok_records(self) -> Sequence[dict]:
        return [r for r in self.records if r["status"] == "ok"]

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

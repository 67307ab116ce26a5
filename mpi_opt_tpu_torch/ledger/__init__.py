"""Durable sweep ledger (port of ``mpi_opt_tpu/ledger/``): the
append-only, fsync-per-record JSONL journal (``store``) and its
boundary-granular member view for fused sweeps (``fused``), and the
driver path's exact-match cache (``cache``); ``warmstart`` feeds a
prior sweep's ledger into a new search as observations, and ``report``
renders ledgers for operators. The journals write the JAX package's
schema byte for byte, so either package reads the other's ledgers.
``CorpusCache`` adds near-match priors for the suggestion service."""

from mpi_opt_tpu_torch.ledger.cache import CorpusCache, EvalCache
from mpi_opt_tpu_torch.ledger.fused import FusedJournal, make_journal
from mpi_opt_tpu_torch.ledger.store import (
    LEDGER_SCHEMA_VERSION,
    LedgerError,
    SweepLedger,
    read_ledger,
    scan_boundaries,
    validate_ledger,
)
from mpi_opt_tpu_torch.ledger.warmstart import warm_start

__all__ = [
    "CorpusCache",
    "EvalCache",
    "FusedJournal",
    "LEDGER_SCHEMA_VERSION",
    "LedgerError",
    "SweepLedger",
    "make_journal",
    "read_ledger",
    "scan_boundaries",
    "validate_ledger",
    "warm_start",
]

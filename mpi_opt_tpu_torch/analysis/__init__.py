"""sweeplint of the port: AST invariant checks for the sweep engine's
contracts (the port's copy of ``mpi_opt_tpu/analysis/``).

The engine's cross-cutting invariants (fsync before the report and
journal before the snapshot, rank-0-gated ledger writes, exit codes
only from ``utils/exitcodes``, atomic tmp+rename status writes, drain
exceptions that propagate, one seeded random stream, no host syncs in
the fused hot path, the event/span name registry, the lock and thread
contracts) are machine-checked here. The names, the JSON schema, the
exit codes, the directive syntax and the baseline format are the JAX
package's, so a ``sweeplint-baseline.json`` and every ``# sweeplint:``
comment mean the same thing to both tools. Three checks are the
port's own (``checkers_torch.py``, ``checkers_resources.py``): torch's
host syncs, torch's random streams and CUDA's out-of-memory errors.

Surface:

- ``mpi_opt_tpu_torch lint [PATHS] [--json] [--baseline FILE]`` (cli.py
  dispatch -> :mod:`mpi_opt_tpu_torch.analysis.cli`), exit 0/1/2;
- inline suppressions: ``# sweeplint: disable=<id>[,<id>] -- reason``
  on the finding line or the line above;
- barrier annotations for the host-sync checker:
  ``# sweeplint: barrier(reason)`` on a ``def`` line exempts that
  function's DIRECT body (nested defs are judged on their own), and on
  a call's line or the line above it exempts that one call;
- a committed baseline (``sweeplint-baseline.json``) for accepted
  legacy findings, fingerprinted by (check, file, line content) so
  line-number drift never invalidates it.

Nothing here imports torch or jax.
"""

from __future__ import annotations

from mpi_opt_tpu_torch.analysis.core import (  # noqa: F401
    Checker,
    FileContext,
    Finding,
    check_source,
    iter_python_files,
    run_paths,
)


def all_checkers():
    """One fresh instance of every registered checker (stateless between
    files by contract; a fresh set per run keeps that honest)."""
    from mpi_opt_tpu_torch.analysis.checkers_concurrency import (
        BeatPathChecker,
        FsyncBeforeRenameChecker,
        GuardedByChecker,
        LockOrderChecker,
        SignalSafetyChecker,
    )
    from mpi_opt_tpu_torch.analysis.checkers_coord import CoordWriteChecker
    from mpi_opt_tpu_torch.analysis.checkers_corpus import CorpusIndexWriteChecker
    from mpi_opt_tpu_torch.analysis.checkers_drain import DrainSwallowChecker
    from mpi_opt_tpu_torch.analysis.checkers_durability import (
        AtomicWriteChecker,
        JournalOrderChecker,
        LedgerFsyncChecker,
        LedgerGateChecker,
    )
    from mpi_opt_tpu_torch.analysis.checkers_exit import ExitCodeChecker
    from mpi_opt_tpu_torch.analysis.checkers_http import HttpHandlerChecker
    from mpi_opt_tpu_torch.analysis.checkers_lease import LeaseWriteChecker
    from mpi_opt_tpu_torch.analysis.checkers_registry import EventRegistryChecker
    from mpi_opt_tpu_torch.analysis.checkers_resources import ResourceFunnelChecker
    from mpi_opt_tpu_torch.analysis.checkers_torch import HostSyncChecker, KeyReuseChecker

    return [
        ExitCodeChecker(),
        JournalOrderChecker(),
        LedgerGateChecker(),
        AtomicWriteChecker(),
        LedgerFsyncChecker(),
        DrainSwallowChecker(),
        KeyReuseChecker(),
        HostSyncChecker(),
        EventRegistryChecker(),
        LeaseWriteChecker(),
        CoordWriteChecker(),
        CorpusIndexWriteChecker(),
        ResourceFunnelChecker(),
        FsyncBeforeRenameChecker(),
        HttpHandlerChecker(),
        # project-pass checkers (racelint): run over the
        # repo-wide symbol table after every file is parsed
        GuardedByChecker(),
        BeatPathChecker(),
        SignalSafetyChecker(),
        LockOrderChecker(),
    ]

"""Workload reuse across tenants: what a resident server saves (port of
``mpi_opt_tpu/service/programs.py``).

A CLI run builds its workload, and with it the population trainer, the
data uploaded to the card and cuDNN's algorithm choices at the run's
launch width. Inside ONE server process those can be kept:

- **shared workload instances**: one instance per registry name for
  the server's lifetime, injected into ``cli.main(_workload=...)``.
  The fused sweeps cache (trainer, space, on-card arrays) ON the
  instance (``train.common.workload_arrays``, keyed by member chunk,
  device and momentum dtype), so a second tenant with a matching key
  gets the same trainer and the same arrays: it skips the data load,
  and the convolutions it launches at the same widths reuse the plans
  cuDNN already chose.
- **hit/miss accounting** keyed by (workload, pop-shape, chunking): the
  scheduler records, per tenant, whether a slice's key was already
  built in this server, and surfaces the counters in status.json and
  the server metrics summary.

A key is a conservative superset of everything that shapes the fused
sweeps' launches (the JAX package's tuple, field for field); matching
keys therefore guarantee reuse, while a mismatched key may still reuse
in part (same trainer, other shapes).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple


def _warm_identity(path: Optional[str]):
    """Key component for --warm-start: fused TPE sizes its obs
    ring as n_trials + n_warm, where n_warm is the PRIOR ledger's record
    count — so a warm-starting tenant's programs are not the cold
    tenant's, and two priors of different length differ again. (path,
    size, mtime) is the conservative stand-in for n_warm without
    reading the file: it only ever splits keys, never aliases."""
    if path is None:
        return None
    try:
        st = os.stat(path)
        return (path, st.st_size, st.st_mtime_ns)
    except OSError:
        return (path, None, None)


def program_key(args) -> tuple:
    """The (workload, pop-shape, chunking) identity of a parsed sweep's
    launches (args: the CLI parser's namespace)."""
    return (
        args.workload,
        args.backend,
        bool(args.fused),
        args.algorithm,
        # pop-shape: which of these bind depends on the algorithm, but
        # including the superset only ever splits keys, never aliases
        args.population,
        args.trials,
        args.budget,
        args.generations,
        args.steps_per_generation,
        args.min_budget,
        args.max_budget,
        args.eta,
        # shapes the launches: PBTConfig's truncation_frac sizes the
        # exploit's n_cut, and the driver path's eval batches are shaped
        # by worker capacity
        args.truncation,
        args.workers,
        _warm_identity(args.warm_start),
        # chunking / residency: each changes the launch split
        args.member_chunk,
        args.gen_chunk,
        args.step_chunk,
        str(args.wave_size),
        # mesh shape: a different device split is a different launch
        bool(args.no_mesh),
        args.n_data,
        args.n_pop,
    )


class ProgramCache:
    def __init__(self):
        self._workloads: dict = {}
        self._seen: set = set()

    def acquire(self, argv: list) -> Tuple[Optional[tuple], bool, Optional[object]]:
        """(key, hit, workload) for one slice's argv.

        ``workload`` is the shared instance to inject into ``cli.main``
        (None when the argv doesn't parse — the slice will fail as a
        usage error on its own — or names a --chaos drill, whose
        wrapper is rebuilt per run by design). ``hit`` is whether this
        key was already built in this server process; the first slice of
        a shape is the miss that pays the set-up, and
        every later slice — same tenant resuming, or a shape-matching
        new tenant — is a hit. A key only enters the seen set via
        ``commit`` (the scheduler calls it when the slice demonstrably
        ran: completed or drained at a boundary) — a slice that died
        BEFORE its set-up finished must not make the next same-shape slice
        report a warm start that never happened."""
        import contextlib
        import io

        from mpi_opt_tpu_torch.cli import build_parser

        # probe parse (micro-cost against a multi-second slice): ALL its
        # output is suppressed — stderr (usage errors) and stdout too
        # (`--help` prints multi-KB help, and the server's stdout is its
        # JSONL metrics stream). The slice's OWN parse of the same argv
        # re-emits everything inside the tenant's log redirect, so the
        # text lands in run.log where it's attributable.
        try:
            with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(
                io.StringIO()
            ):
                args = build_parser().parse_args(list(argv))
        except SystemExit:
            return None, False, None
        if args.chaos is not None:
            # chaos wrappers are rebuilt per run by design (one tenant's
            # fault schedule must not leak into another), so a chaos
            # slice is NEVER warm: no key (a committed chaos-blind key
            # would falsely warm-start the fault-free tenant of the same
            # shape), no hit (its own resumed slices rebuild every
            # time), no shared workload
            return None, False, None
        key = program_key(args)
        # hit/miss tallies live with their consumers — per-tenant in
        # status.json and server-wide in MetricsLogger (the scheduler
        # records both from this bool); a third copy here would drift
        hit = key in self._seen
        workload = self._workloads.get(args.workload)
        if workload is None:
            from mpi_opt_tpu_torch.workloads import get_workload

            workload = get_workload(args.workload)
            self._workloads[args.workload] = workload
        return key, hit, workload

    def commit(self, key: Optional[tuple]) -> None:
        """Record that ``key``'s set-up actually ran (the slice completed
        or parked at a boundary — both are past it)."""
        if key is not None:
            self._seen.add(key)

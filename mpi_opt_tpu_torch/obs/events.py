"""The event/span name registry of the port: one table of every legal
name (the port's copy of ``mpi_opt_tpu/obs/events.py``).

The metrics stream is a schema consumed by the ``trace`` CLI, the
bench, the launch supervisor's relay and outside log aggregation, and
both packages' ``trace`` CLIs read the same streams, so the tables here
equal the JAX package's name for name, but for one named set of the
port's own spans (``PORT_SPANS``). Every ``metrics.log("name",
...)`` event, every ``integrity.notify("name", ...)``, every supervisor
``_event("name", ...)`` and every ``trace.span("name", ...)`` must use a
name registered here: the ``event-registry`` checker of ``lint``
(``analysis/checkers_registry.py``) fails on a literal call-site name
missing from the tables, so adding an event means adding one line
here: the schema change is a diff of this file.
"""

from __future__ import annotations

import ast

#: every legal ``event`` value in the JSONL metrics stream (including
#: launch.py's supervisor events and utils/integrity.py observer
#: notifications, which land in the same consumable stream shape)
EVENTS = frozenset(
    {
        # driver / sweep lifecycle
        "batch",
        "resume",
        "retry",
        "retry_exhausted",
        "summary",
        "sweep_aborted",
        "preempt_drain",
        "trial_failed",
        "trial_retry",
        "warm_start",
        "warm_start_skipped",
        # ledger layer
        "ledger_rank_gated",
        "ledger_replay",
        "ledger_replay_unconsumed",
        "ledger_torn_boundary_dropped",
        "ledger_torn_tail_dropped",
        # snapshot-integrity observer (utils/integrity.py)
        "snapshot_corrupt",
        "snapshot_io_retry",
        "snapshot_unverified",
        # resource-exhaustion observer (utils/resources.py):
        # oom_backoff = a device OOM absorbed by halving the wave and
        # re-running the generation (bit-identical); wave_resized = a
        # pre-launch headroom clamp of the wave size against the
        # measured device budget; snapshot_pruned = the ENOSPC
        # retention-prune retry deleted one superseded retained step
        "oom_backoff",
        "wave_resized",
        "snapshot_pruned",
        # launch.py supervisor events
        "launch",
        "done",
        "failed",
        "restart",
        "stall",
        "stall_restart",
        "preempted",
        "preempt_restart",
        # multi-process SPMD coordination (parallel/coord.py + the
        # supervisor's wedge classification): rank_agreed = a boundary
        # decision (drain / wave cap / OOM halving) settled unanimously
        # through the control plane; rank_wedge = a rank (or the
        # supervisor, observing dead-rank-plus-frozen-survivors)
        # concluded a peer never reached the boundary — the collective
        # is wedged and a coordinated restart is the recovery
        "rank_agreed",
        "rank_wedge",
        # sweep service (service/scheduler.py)
        "serve_start",
        "slice_start",
        "slice_end",
        "tenant_admit",
        "tenant_cancelled",
        "tenant_reject",
        # fleet federation (service/leases.py + scheduler):
        # tenant_takeover = an orphaned job claimed from a dead/expired
        # peer's lease; slice_fenced = a zombie slice's end-of-slice
        # writes refused (token mismatch); server_usurped = this
        # server's id was re-registered while it was presumed dead and
        # it stepped down (exit EX_UNAVAILABLE)
        "tenant_takeover",
        "slice_fenced",
        "server_usurped",
        # cross-sweep knowledge corpus (corpus/):
        # corpus_skip = one corpus source degraded during --warm-start
        # auto: resolution (stale index entry whose ledger was deleted/
        # rewritten, corrupt entry, unreadable ledger) — a skip, never
        # an error; the suggest_* family is the suggestion service's
        # lifecycle (serve start, one record per served request, the
        # stop/idle summary)
        "corpus_skip",
        # multi-objective search (objectives/): pareto_front =
        # a fused MO sweep's final non-dominated front (size,
        # hypervolume, selection kind); objective_degraded = a
        # constrained sweep found NOTHING feasible and typed-degraded
        # its winner to the least-violating member — an outcome to page
        # on, never a silent argmax
        "pareto_front",
        "objective_degraded",
        "suggest_serve",
        "suggest_request",
        "suggest_stop",
        # HTTP front door (service/http.py): lifecycle
        # (http_serve/http_stop), one http_request per executed batch,
        # and the overload envelope — http_shed (admission queue full,
        # typed 503), http_replayed (idempotent retry answered from the
        # dedup window), http_expired (past-deadline work expired at
        # dequeue, 504), breaker_open (per-client retry-storm breaker
        # tripped, 429s for the cooldown), http_error (a contained
        # executor fault answered as a typed 500)
        "http_serve",
        "http_request",
        "http_shed",
        "http_replayed",
        "http_expired",
        "breaker_open",
        "http_error",
        "http_stop",
        # span tracing (obs/trace.py): one event kind, span names below
        "span",
    }
)

#: the JAX package's ``span`` names (the ``span`` field of a ``span``
#: event)
_JAX_SPANS = frozenset(
    {
        "setup",  # workload data load + trainer/backend construction
        "compile",  # a program compile (the JAX package's XLA listener; read by trace)
        "train",  # one fused train launch / one driver evaluate batch
        "boundary",  # exploit / rung cut / generation-boundary op
        "stage_in",  # host->device wave upload (train/staging.py)
        "stage_out",  # device->host wave fetch + pool write
        "stage_wait",  # main-thread drain() block (un-hidden transfer)
        "save",  # snapshot save (digest + write)
        "save_wait",  # checkpointer close: async-save drain
        "restore",  # snapshot restore attempt
        "digest",  # integrity manifest build / verification
        "journal",  # ledger fsync (per final trial / per fused boundary)
        "slice",  # one service scheduling quantum (server side)
        "slice_setup",  # service program-cache acquire + log open
    }
)

#: the port's own ``span`` names: the phases of a training step and the
#: eval (``train/population.py``), which the device trace's idle gaps and
#: launches are put down to. The JAX package traces none of them
PORT_SPANS = frozenset(
    {
        "batch",  # a step's batch and augmentation draws and row gather
        "forward",  # a member chunk's parameter views, inputs, logits, loss
        "backward",  # a member chunk's gradients (and their data-mean)
        "update",  # a member chunk's per-leaf optimiser step
        "eval",  # one eval_population call
    }
)

#: every legal ``span`` name
SPANS = _JAX_SPANS | PORT_SPANS


#: every legal span ATTRIBUTE key — the kwargs of ``trace.span(...)``
#: calls plus the keys set on the yielded dict (``sp["bytes"] = n``) and
#: the compile listener's synthesized attrs. The trace CLI, the diff
#: layer, and outside aggregation key on these names, so they are
#: schema the same way event/span names are: the ``event-registry``
#: sweeplint checker rejects a literal ``span()`` keyword missing here
#: (dict-set keys are registered by convention — AST can't prove a
#: subscript target is a span dict).
SPAN_ATTRS = frozenset(
    {
        # identity / position
        "launch",  # 1-based launch ordinal (train)
        "batch",  # driver batch ordinal (train)
        "boundary",  # fused journal boundary ordinal (journal)
        "gen",  # PBT generation (boundary op=exploit)
        "gens",  # generations covered by one launch (train)
        "rung",  # SHA rung ordinal (train, boundary op=rung_cut)
        "bracket",  # hyperband/BOHB bracket (boundary op=suggest)
        "waves",  # waves per generation (train, wave mode)
        "step",  # snapshot step (save/restore)
        "job",  # service tenant job id (slice/slice_setup)
        # shape / volume
        "members",  # population members in the phase
        "steps",  # train steps in the segment
        "n",  # generic count (journal records, suggest batch)
        "items",  # manifest items (digest)
        "bytes",  # bytes moved (stage_in/stage_out; set at exit)
        "flops",  # segment FLOPs for achieved TF/s (set at exit)
        # provenance
        "op",  # boundary/digest flavor (exploit/rung_cut/suggest/...)
        "objectives",  # MO sweep: comma-joined objective names (train)
        "backend",  # driver setup backend name
        "workload",  # fused setup workload name
        "cache",  # compile: cold | persistent (listener)
        "during",  # compile: enclosing span name (listener)
        "device",  # local device kind (setup; keys the roofline cap table)
        # device-memory watermark (obs/memory.py; set at exit)
        "mem_bytes",  # steady bytes_in_use at phase exit
        "mem_peak_bytes",  # peak/watermark bytes at phase exit
        "mem_src",  # accounting source: memory_stats | live_arrays
        # staging-overlap accounting (train/staging.py; the engine's
        # CUMULATIVE counters at emit time, so a run killed
        # mid-generation still carries partial overlap evidence)
        "overlap_s",  # hidden transfer seconds (stage_out/stage_wait)
        "wait_s",  # un-hidden drain-block seconds (stage_out/stage_wait)
        # bubble/roofline layer (obs/bubbles.py): synthesized into
        # timeline-export args and budgeted by the diff gate — schema
        # the same way emitted attrs are
        "idle_gap_s",  # one device-idle gap's seconds (timeline idle track)
        "cause",  # the gap's dominant attribution (compile/staging_wait/...)
        "bound",  # verdict: compute-bound | transfer-bound | bubble-bound
        "peak_tflops",  # platform cap the verdict was judged against
        "mxu_frac",  # achieved TF/s over the platform cap
    }
)


def is_event(name: str) -> bool:
    return name in EVENTS


def is_span(name: str) -> bool:
    return name in SPANS


def is_span_attr(name: str) -> bool:
    return name in SPAN_ATTRS


# -- scanner shims ---------------------------------------------------------
#
# The AST call-site scanner lives in the lint suite
# (analysis/checkers_registry.EventRegistryChecker: one shared parse per
# file, the same suppression and baseline machinery as every other
# check). The TABLES above stay here: they are the metrics-stream
# schema's home and what a schema change must diff. These shims keep
# the JAX package's registry surface.


def scan_call_sites(root: str):
    """Yield ``(path, lineno, kind, name)`` for every registered-emitter
    call site with a literal first argument under ``root`` (tests and
    probes excluded — they fabricate names on purpose). Thin shim over
    :mod:`mpi_opt_tpu_torch.analysis.checkers_registry`; see its docstring for
    the emitter shapes gated."""
    from mpi_opt_tpu_torch.analysis.checkers_registry import call_site
    from mpi_opt_tpu_torch.analysis.core import iter_python_files

    for path in iter_python_files(root):
        try:
            with open(path) as f:
                tree = ast.parse(f.read())
        except (OSError, SyntaxError):
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                site = call_site(node)
                if site is not None:
                    yield path, node.lineno, site[0], site[1]


def lint(root: str) -> list:
    """Human-readable problems for unregistered names under ``root``
    (empty = clean). Shim over the ``event-registry`` sweeplint checker
    — the same check `mpi_opt_tpu_torch lint` runs."""
    from mpi_opt_tpu_torch.analysis.checkers_registry import EventRegistryChecker
    from mpi_opt_tpu_torch.analysis.core import run_paths

    findings, _n, errors = run_paths([root], [EventRegistryChecker()])
    return [f"{f.file}:{f.line}: {f.message}" for f in findings] + list(errors)

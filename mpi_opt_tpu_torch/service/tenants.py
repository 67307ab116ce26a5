"""Tenant state machine: what one submitted sweep is doing right now
(port of ``mpi_opt_tpu/service/tenants.py``, which imports no JAX).

States::

    queued ──admit──> (runnable) ──slice──> running
    running ──rc 0───────────────> done
    running ──rc 75 (SLICE)──────> parked      (runnable again)
    running ──rc 75 + cancel─────> cancelled
    running ──rc 75 (SIGTERM)────> parked      (server is draining)
    running ──rc 74──────────────> parked      (resource exhausted:
                                   state intact; re-picked only after a
                                   cooldown so a full disk is not spun)
    running ──rc 65──────────────> data_error  (terminal, never retried)
    running ──rc 2───────────────> failed      (usage: deterministic)
    running ──rc other───────────> failed
    queued/parked ──cancel───────> cancelled
    running + dead/expired lease─> (takeover)  (any live fleet server
                                   claims the lease and resumes it)

The rc classification is ``utils.exitcodes.classify`` — the SAME map
the launch supervisor uses, so a sweep's exit means one thing
everywhere. ``parked`` is the service's load-bearing state: by the
graceful-drain contract (health/shutdown.py) a parked tenant's ledger
and snapshot are flushed at a natural boundary, so resuming it is the
existing ``--resume`` + verified-snapshot + journal-prefix machinery —
time-slicing never invents a new recovery path.
"""

from __future__ import annotations

from mpi_opt_tpu_torch.utils.exitcodes import classify

QUEUED = "queued"
RUNNING = "running"
PARKED = "parked"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"
DATA_ERROR = "data_error"

#: states a tenant never leaves
TERMINAL = frozenset({DONE, FAILED, CANCELLED, DATA_ERROR})

#: states the scheduler may pick for the next slice
RUNNABLE = frozenset({QUEUED, PARKED})


def after_slice(rc: int, cancel_requested: bool) -> str:
    """The state a tenant lands in when its slice returns ``rc``.

    ``cancel_requested`` is whether the tenant's cancel flag was up —
    a drained (rc 75) slice with the flag up parked ON PURPOSE so the
    cancel could take effect at a boundary: the tenant is cancelled,
    with its ledger/snapshots intact and valid (nothing was killed, so
    nothing needs quarantine)."""
    outcome = classify(rc)
    if outcome == "ok":
        return DONE
    if outcome == "preempted":
        return CANCELLED if cancel_requested else PARKED
    if outcome == "io_error":
        # resource exhaustion (EX_IOERR=74, utils/resources.py): the
        # tenant's durable state is INTACT — the failed write never
        # landed and the newest verified step was never touched — so
        # this is PARKED, not terminal-failed: freeing disk + the
        # ordinary --resume slice recovers fsck-clean. The scheduler
        # stamps a cooldown so a still-full disk is re-probed, not spun.
        return CANCELLED if cancel_requested else PARKED
    if outcome == "data_error":
        return DATA_ERROR
    # "usage" and the generic "failure" are both terminal for a tenant:
    # usage is deterministic (a retry re-refuses), and a failed sweep's
    # retry policy belongs to the sweep's own --retries, which already
    # ran inside the slice
    return FAILED

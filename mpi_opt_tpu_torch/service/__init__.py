"""Sweep-as-a-service: a resident scheduler multiplexing one card (port
of ``mpi_opt_tpu/service``).

A CLI run pays its whole set-up (import, data upload, cuDNN's algorithm
choice at each launch width) for every sweep. One long-lived server
(``python -m mpi_opt_tpu_torch serve``) owns the card instead and
time-slices it across submitted sweeps at their natural drain
boundaries, so a shape-matching tenant reuses the trainer and the
on-card data of the tenant before it.

Pieces:

- ``spool``    — filesystem queue + control plane (no network needed);
  the JAX package's on-disk format, so one spool serves both packages'
  clients
- ``tenants``  — the per-job state machine over exit-code outcomes
- ``leases``   — fleet federation: per-job lease claims with fencing
  tokens, heartbeat-ridden TTL refresh, crash-safe takeover
- ``programs`` — workload-instance reuse across shape-matching tenants
- ``scheduler``— the server loop: admit, pick, slice, park
- ``client``   — ``serve`` / ``submit`` / ``status`` / ``cancel`` / ``drain``
- ``http``     — the HTTP front door of the suggestion service
  (``--suggest-serve DIR --http-port N``), which also exposes
  submit/status/cancel over this spool (``--http-state-dir``)

Every mechanism the scheduler leans on already exists for robustness:
preemption is the graceful-drain protocol, parking is exit 75, resume
is verified snapshots + ledger journal prefixes.
"""

from __future__ import annotations

#: the spool clients: no CUDA work, so ``__main__`` runs them before the
#: CLI module (and torch) loads
CLIENT_SUBCOMMANDS = ("submit", "status", "cancel", "drain")
SUBCOMMANDS = ("serve", *CLIENT_SUBCOMMANDS)


def service_main(argv) -> int:
    """Dispatch the service subcommands (see ``cli.main``). Lazy imports
    keep ``submit``/``status``/``cancel``/``drain`` free of CUDA work
    and fast to start."""
    cmd, rest = argv[0], argv[1:]
    from mpi_opt_tpu_torch.service import client

    mains = {"serve": client.serve_main, "submit": client.submit_main,
             "status": client.status_main, "cancel": client.cancel_main,
             "drain": client.drain_main}
    if cmd not in mains:
        raise ValueError(f"unknown service subcommand {cmd!r}")
    return mains[cmd](rest)

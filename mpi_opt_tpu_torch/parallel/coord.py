"""Boundary-agreement control plane for multi-process SPMD (port of
``mpi_opt_tpu/parallel/coord.py``, line for line; the file format is
the JAX package's, so ranks of both packages can vote in one directory).

The one fault-tolerance problem exit codes, heartbeats, and snapshots
cannot solve alone: under multi-process SPMD every rank runs the same
host program, but the DECISIONS that change that program's trajectory
arrive on ONE rank — the platform's SIGTERM lands on one process, a
device OOM raises in one process's wave loop, a stall verdict forms in
one watchdog. A rank that acts on such a decision alone (drains at its
next boundary, halves its wave cap) issues different collectives than
its peers and wedges the mesh forever; the reference's MPI world has
``MPI_Allreduce`` for exactly this. This module is the filesystem
equivalent: a vote/decide barrier at every launch/rung/generation
boundary, built from the same atomic primitives as the fleet spool
(``service/spool.py``: O_EXCL fsync'd creates, tmp+rename JSON,
transient-I/O retry), so every rank-divergent decision becomes
unanimous BEFORE the next collective.

Protocol (per agreement kind, per boundary ordinal):

1. every rank atomically creates its vote file
   (``<kind>.<seq>.r<rank>.vote.json``, O_EXCL — a lost race is a
   protocol error, not a retry);
2. rank 0 polls until all ``world`` votes exist, reduces them with the
   call site's pure ``decide(votes)`` function, and publishes the
   decision file (``<kind>.<seq>.decision.json``, O_EXCL — duplicate
   publication after a crash is benign: the first file wins and is
   what everyone reads);
3. every rank polls until the decision exists and returns it.

Because SPMD ranks execute identical host code, the sequence of
``agree`` calls per kind is identical on every rank — the per-kind
ordinal IS the barrier identity, no clocks involved. A rank that dies
between boundaries leaves its peers waiting in step 1/3; the waiters'
heartbeats freeze in the boundary phase, which is precisely the shape
``launch.py``'s supervisor classifies as a collective wedge (dead rank
+ survivors frozen in ``train``/``boundary:*``) and escalates. As a
belt-and-suspenders local verdict, waits are bounded by ``timeout_s``
and raise :class:`CoordWedged` (the in-rank stall verdict) so an
unsupervised job cannot hang forever.

Epoching: one plane instance namespaces all its files under
``<root>/e<epoch>/``. ``launch.py`` passes a fresh ``--coord-epoch``
per attempt (its relaunch counter), so a restarted job can never read
the killed attempt's stale votes. Reusing an epoch directory is
refused at bring-up (rank 0 finds leftover files) — wiping it in place
would race peers reading the previous attempt's READY marker.

The agreement file surface is write-exclusive to this module: the
``coord-write`` sweeplint checker flags vote/decision/coord-path
writes anywhere else, the same way ``lease-write`` fences the lease
protocol.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

from mpi_opt_tpu_torch.service.spool import _read_json, excl_write_json, retry_io
from mpi_opt_tpu_torch.utils import resources

#: marker rank 0 publishes once its epoch directory is ready; peers
#: wait for it before voting so they can never observe a half-created
#: control plane
_READY = "READY.json"


class CoordError(RuntimeError):
    """Control-plane protocol violation (reused epoch dir, duplicate
    vote) — deterministic misuse, not weather."""


class CoordWedged(CoordError):
    """The in-rank stall verdict: an agreement wait exceeded the
    plane's timeout, meaning at least one peer never reached the
    boundary (dead, or wedged in a collective). The caller's process
    should exit and let the supervisor's coordinated restart recover —
    restarting alone would desynchronize the world further."""


def _decide_drain(votes: list) -> dict:
    """Drain iff ANY rank saw a shutdown request; carry the first real
    signal name so every rank's SweepInterrupted reports the same
    cause."""
    drain = any(v.get("drain") for v in votes)
    signal = None
    for v in votes:
        if v.get("drain") and v.get("signal"):
            signal = v["signal"]
            break
    return {"drain": drain, "signal": signal}


def _decide_min_cap(votes: list) -> dict:
    """The most constrained rank wins: min over positive proposed caps
    (0 = "no local constraint" — an OOM-free rank's vote)."""
    caps = [int(v.get("cap", 0)) for v in votes]
    positive = [c for c in caps if c > 0]
    return {"cap": min(positive) if positive else 0}


class CoordPlane:
    """One rank's handle on the shared agreement directory.

    ``root`` is shared by all ranks (under the run/log dir); ``rank``/
    ``world`` come from ``torch.distributed.get_rank()``/``get_world_size()``;
    ``epoch`` namespaces one job attempt. ``timeout_s`` bounds every
    wait (the local wedge verdict); ``poll_s`` is the vote/decision
    poll interval — agreement happens at launch/rung/generation
    boundaries (seconds to minutes apart), so a coarse poll costs
    nothing and keeps a shared filesystem calm.
    """

    def __init__(
        self,
        root: str,
        rank: int,
        world: int,
        *,
        epoch: int = 0,
        timeout_s: float = 300.0,
        poll_s: float = 0.01,
    ):
        if not 0 <= rank < world:
            raise CoordError(f"rank {rank} outside world of {world}")
        self.root = os.path.abspath(root)
        self.rank = int(rank)
        self.world = int(world)
        self.epoch = int(epoch)
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s)
        self.dir = os.path.join(self.root, f"e{self.epoch:04d}")
        self._seq: dict = {}
        #: set once a drain decision came back affirmative: the gate
        #: ``train.common.launch_boundary`` consults before honoring a
        #: LOCALLY-seen shutdown request (an unagreed drain must wait
        #: for the next boundary's vote, or ranks drain split)
        self.drain_agreed = False
        self._ready()

    # -- bring-up --------------------------------------------------------

    def _ready(self) -> None:
        ready = os.path.join(self.dir, _READY)
        if self.rank == 0:
            retry_io(lambda: os.makedirs(self.dir, exist_ok=True))
            leftovers = [f for f in os.listdir(self.dir) if f != _READY]
            if leftovers or os.path.exists(ready):
                # wiping in place would race peers still reading the
                # previous attempt's READY — epochs are single-use
                raise CoordError(
                    f"coord epoch dir {self.dir} already holds "
                    f"{len(leftovers) or 1} file(s) from a previous "
                    "attempt; pass a fresh --coord-epoch (launch.py "
                    "does this per relaunch) or a clean --coord-dir"
                )
            excl_write_json(ready, {"world": self.world, "epoch": self.epoch})
            return
        self._wait(
            lambda: os.path.exists(ready),
            what=f"rank 0's {_READY} in {self.dir}",
        )
        rec = _read_json(ready) or {}
        if rec.get("world") not in (None, self.world):
            raise CoordError(
                f"coord world mismatch: rank 0 announced "
                f"{rec.get('world')} ranks, this rank was launched "
                f"into a world of {self.world}"
            )

    # -- the vote/decide barrier ----------------------------------------

    def _wait(self, done: Callable[[], bool], what: str):
        deadline = time.monotonic() + self.timeout_s
        while True:
            if done():
                return
            if time.monotonic() >= deadline:
                resources.notify(
                    "rank_wedge",
                    rank=self.rank,
                    world=self.world,
                    epoch=self.epoch,
                    waited_s=round(self.timeout_s, 3),
                    waiting_for=what,
                )
                raise CoordWedged(
                    f"rank {self.rank}: no {what} after "
                    f"{self.timeout_s}s — a peer died or wedged before "
                    "this boundary; exiting for a coordinated restart"
                )
            time.sleep(self.poll_s)

    def _vote_path(self, kind: str, seq: int, rank: int) -> str:
        return os.path.join(self.dir, f"{kind}.{seq:06d}.r{rank}.vote.json")

    def _decision_path(self, kind: str, seq: int) -> str:
        return os.path.join(self.dir, f"{kind}.{seq:06d}.decision.json")

    def agree(self, kind: str, vote: dict, decide: Callable[[list], dict]) -> dict:
        """One barrier: publish this rank's ``vote``, have rank 0 reduce
        all ``world`` votes with ``decide`` (a pure function every rank
        links identically — only rank 0 runs it), and return the
        published decision. Blocks until unanimity or ``timeout_s``."""
        seq = self._seq.get(kind, 0)
        self._seq[kind] = seq + 1
        if not excl_write_json(self._vote_path(kind, seq, self.rank), vote):
            raise CoordError(
                f"duplicate vote for {kind}#{seq} by rank {self.rank} — "
                "two planes sharing one (dir, epoch, rank) identity"
            )
        decision_path = self._decision_path(kind, seq)
        if self.rank == 0:
            peer_paths = [
                self._vote_path(kind, seq, r) for r in range(self.world)
            ]
            self._wait(
                lambda: all(os.path.exists(p) for p in peer_paths),
                what=f"all {self.world} votes for {kind}#{seq}",
            )
            votes = []
            for p in peer_paths:
                rec = _read_json(p)
                if rec is None:
                    # exists-but-unparseable: O_EXCL writes are fsync'd
                    # before visibility on a local fs, but a shared one
                    # may expose the name first — re-read briefly
                    self._wait(
                        lambda p=p: _read_json(p) is not None,
                        what=f"readable vote {os.path.basename(p)}",
                    )
                    rec = _read_json(p)
                votes.append(rec or {})
            # duplicate publication (crash between publish and use, or
            # a re-entered epoch) concedes to the first file — what
            # every peer already read
            excl_write_json(decision_path, decide(votes))
        self._wait(
            lambda: _read_json(decision_path) is not None,
            what=f"rank 0's decision for {kind}#{seq}",
        )
        return _read_json(decision_path) or {}

    # -- the three decision kinds ----------------------------------------

    def boundary_tick(self, stage: str) -> None:
        """The per-boundary drain agreement — installed as (chained
        onto) the shutdown slice hook, so every non-final
        ``launch_boundary`` runs one barrier: each rank votes whether
        IT has seen a shutdown request; if any has, every rank raises
        its own drain flag at THIS boundary and all drain together.

        May raise :class:`CoordWedged` (the sanctioned slice-hook
        exception): a peer that never arrives IS the wedge this plane
        exists to bound.
        """
        from mpi_opt_tpu_torch.health import shutdown

        vote = {
            "drain": bool(shutdown.requested()),
            "signal": shutdown.active_signal(),
            "stage": str(stage),
        }
        decision = self.agree("drain", vote, _decide_drain)
        if not decision.get("drain"):
            return
        if not self.drain_agreed:
            self.drain_agreed = True
            resources.notify(
                "rank_agreed",
                kind="drain",
                rank=self.rank,
                boundary=self._seq["drain"],
                signal=decision.get("signal"),
                stage=str(stage),
            )
        # peers that never saw the signal adopt the agreed cause; the
        # rank that did already holds it (request never overwrites a
        # real signal name)
        shutdown.request(source=decision.get("signal") or "SIGTERM")

    def agree_cap(self, kind: str, cap: int) -> int:
        """Min-reduce a proposed wave cap (``wave_cap`` at sizing time,
        ``oom`` per absorbed backoff). 0 votes "no local constraint";
        returns 0 only when NO rank proposed one."""
        decision = self.agree(kind, {"cap": int(cap)}, _decide_min_cap)
        agreed = int(decision.get("cap", 0))
        if agreed:
            resources.notify(
                "rank_agreed",
                kind=kind,
                rank=self.rank,
                boundary=self._seq[kind],
                cap=agreed,
            )
        return agreed


# -- process-wide plane + hook wiring ---------------------------------------
#
# The CLI activates ONE plane per run; the engine's sizing door and OOM
# backoff consult it through ``active_plane()`` (they have no argument
# path that every adapter threads), and ``install_hook`` chains the
# drain agreement onto the shutdown slice hook the boundaries already
# poll.

_ACTIVE: Optional[CoordPlane] = None


def activate(plane: Optional[CoordPlane]) -> None:
    global _ACTIVE
    _ACTIVE = plane


def deactivate() -> None:
    activate(None)


def active_plane() -> Optional[CoordPlane]:
    return _ACTIVE


def drain_allowed() -> bool:
    """May a locally-seen shutdown request drain at THIS boundary?
    Always, without a plane (single-process: local IS global); with one,
    only after a drain decision — ``launch_boundary`` consults this so
    a signal that lands mid-boundary on one rank waits for the next
    boundary's vote instead of splitting the world."""
    return _ACTIVE is None or _ACTIVE.drain_agreed


def install_hook(plane: CoordPlane) -> Callable[[], None]:
    """Activate ``plane`` and chain its ``boundary_tick`` onto the
    shutdown slice hook (the service scheduler's hook, when installed,
    keeps running first — its slice request then rides the SAME
    boundary's vote). Returns an uninstall closure that restores the
    prior hook and deactivates the plane — callers pair it in a
    ``finally``."""
    from mpi_opt_tpu_torch.health import shutdown

    prev = shutdown.get_slice_hook()

    def _tick(stage: str) -> None:
        if prev is not None:
            prev(stage)
        plane.boundary_tick(stage)

    activate(plane)
    shutdown.set_slice_hook(_tick)

    def uninstall() -> None:
        shutdown.set_slice_hook(prev)
        deactivate()

    return uninstall


def reset_dir(root: str) -> None:
    """Remove every epoch's agreement files under ``root`` (the
    supervisor's between-JOBS cleanup; between attempts it advances
    ``--coord-epoch`` instead — an in-place wipe would race live
    readers). Lives here so the agreement file surface keeps exactly
    one writer module (the ``coord-write`` fence)."""
    import shutil

    try:
        shutil.rmtree(root)
    except FileNotFoundError:
        pass

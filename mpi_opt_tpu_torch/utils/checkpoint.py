"""Durable snapshots of a fused sweep and of a driver-path search (port
of ``SweepCheckpointer`` and ``SearchCheckpointer`` in
``mpi_opt_tpu/utils/checkpoint.py``).

Orbax becomes the port's own step layout (``utils/integrity.py``): one
numeric directory per launch, committed by a rename, holding a
``torch.save`` of host copies of the carried tensors, the sweep's
config and curves as JSON, and a manifest of content digests. The
contract is the JAX package's:

- ``save`` writes synchronously: the host copies and the files are
  complete before the next launch updates the population in place.
  A full disk gets one retention-prune retry (the oldest retained step,
  never the newest), then raises ``StorageFull`` (``_save_storage_guard``).
- ``restore`` verifies the newest committed step's digests before any
  state is applied; a step that fails to decode or verify is
  quarantined and restore walks back to the next older one
  (``_restore_walk``). With none verified: ``NoVerifiedSnapshotError``.
- the saved config must equal the sweep's, or restore raises
  ``ValueError``;
- ``keep`` (default 3) steps are retained.

Under a multi-process mesh (``mesh=``) every rank joins the gather of
the population state, and rank 0 alone writes, prunes and quarantines
(the JAX package leaves the multi-host write to orbax): the other ranks
read the same directory on restore and keep their rows of the full
restored copy. A rank that is not the writer walks past a step that
fails to verify without renaming it, as rank 0, which does rename it,
walks past it too.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

from mpi_opt_tpu_torch.obs import memory, trace
from mpi_opt_tpu_torch.utils import integrity, resources


def _prune_superseded(ck: "SweepCheckpointer") -> Optional[int]:
    """Delete the oldest retained step (the retention-prune half of the
    ENOSPC recovery). The newest step is never touched: it is the resume
    point a parked run recovers through. Returns the pruned step, or
    None with fewer than two steps."""
    steps = ck.all_steps()
    if len(steps) < 2:
        return None
    shutil.rmtree(os.path.join(ck.directory, str(steps[0])), ignore_errors=True)
    return steps[0]


def _save_storage_guard(ck: "SweepCheckpointer", write) -> None:
    """Run ``write()`` with the storage-exhaustion lifecycle: a
    classified ENOSPC/EDQUOT gets one retention-prune retry, then parks
    by raising ``StorageFull`` (the CLI exits ``EX_IOERR``). The fault
    seam sits inside each attempt, so an injected schedule is consulted
    again on the retry. Other failures propagate raw."""

    def attempt():
        resources.disk_fault("snapshot_save", ck.directory)
        write()

    try:
        attempt()
        return
    except Exception as e:
        if not resources.is_storage_full(e):
            raise
        first = e
    victim = _prune_superseded(ck)
    if victim is None:
        raise resources.StorageFull(
            "snapshot save hit a full disk and no superseded retained step "
            "remains to prune (the newest verified step is never touched); "
            "free disk space and relaunch with --resume",
            path=ck.directory,
        ) from first
    resources.notify("snapshot_pruned", step=victim, directory=ck.directory)
    try:
        attempt()
    except Exception as e:
        if not resources.is_storage_full(e):
            raise
        raise resources.StorageFull(
            "snapshot save still hit a full disk after pruning one superseded "
            f"step ({victim}); free disk space and relaunch with --resume",
            path=ck.directory,
        ) from e


def _restore_walk(ck: "SweepCheckpointer", attempt):
    """Try committed steps newest first via ``attempt(step)``; a step
    that fails decode or verification is quarantined and the walk goes
    on to the next older one. Returns ``(step, attempt_result)``, or
    None when the directory holds no step (start fresh); raises
    ``NoVerifiedSnapshotError`` when steps existed but none verified.

    An ``OSError`` is not corruption evidence (the filesystem is sick,
    not the bytes): it gets one retry, then re-raises raw, so an intact
    tree is never renamed away for a transient outage."""
    quarantined: list = []
    skipped: set = set()
    had_any = False
    while True:
        steps = [st for st in ck.all_steps() if st not in skipped]
        if not steps:
            break
        had_any = True
        step = steps[-1]
        retried_io = False
        while True:
            try:
                return step, attempt(step)
            except OSError as e:
                if retried_io:
                    raise
                retried_io = True
                integrity.notify("snapshot_io_retry", step=step, directory=ck.directory,
                                 error=f"{type(e).__name__}: {e}"[:500])
            except Exception as e:
                if not ck.writes:
                    # rank 0 quarantines it; this rank walks on past it
                    skipped.add(step)
                    quarantined.append(os.path.join(ck.directory, str(step)))
                    break
                q = integrity.quarantine_step(ck.directory, step)
                quarantined.append(q or os.path.join(ck.directory, str(step)))
                integrity.notify(
                    "snapshot_corrupt",
                    step=step,
                    directory=ck.directory,
                    error=f"{type(e).__name__}: {e}"[:500],
                    quarantined_to=None if q is None else os.path.basename(q),
                )
                break
    if had_any or quarantined:
        raise integrity.NoVerifiedSnapshotError(ck.directory, quarantined)
    return None


class SweepCheckpointer:
    """Durable snapshots of a fused sweep, one step per completed launch.

    Items per step: ``sweep`` (host tensors: population state, unit
    hparams, generator state, scores) and ``meta`` (``{"config": ...,
    **extra}``, validated on restore), with their digests in the
    manifest."""

    def __init__(self, directory: str, config: dict, keep: int = 3, mesh=None):
        self.config = config
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.mesh = mesh
        #: rank 0 (or the one process) writes; other ranks only gather
        self.writes = mesh is None or mesh.rank == 0
        os.makedirs(self.directory, exist_ok=True)
        if not self.writes:
            return
        # a save killed before its rename leaves only its temporary
        # directory, which nothing will ever commit
        for d in os.listdir(self.directory):
            if d.startswith(".") and ".tmp" in d and d[1:].split(".tmp")[0].isdigit():
                shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)

    def all_steps(self) -> list:
        return integrity._committed_steps(self.directory)

    def save(self, step: int, sweep: dict, meta_extra: dict) -> None:
        """Commit ``sweep`` (host tensors) and the meta as ``step``, then
        drop committed steps beyond the newest ``keep``; traced as a
        ``save`` span. A rank that is not the writer returns at once."""
        if not self.writes:
            return
        with trace.span("save", step=step) as sp:
            memory.note(sp)  # snapshot-time watermark: the sweep's state resident
            meta = {"config": self.config, **meta_extra}
            manifest = integrity.build_manifest({"meta": meta}, {"sweep": sweep})
            _save_storage_guard(
                self, lambda: integrity.write_step(self.directory, step, sweep, meta, manifest)
            )
            for old in self.all_steps()[: -self.keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def restore(self):
        """(sweep, meta) of the newest verified step, or None when the
        directory holds no step. Raises ``NoVerifiedSnapshotError`` when
        none verifies and ``ValueError`` on a config mismatch."""

        def attempt(step):
            with trace.span("restore", step=step):
                manifest, meta, sweep = integrity.read_step(self.directory, step)
            problems = integrity.verify_restored(manifest, {"meta": meta}, {"sweep": sweep})
            if problems:
                raise integrity.SnapshotCorruptError("; ".join(problems))
            return sweep, meta

        res = _restore_walk(self, attempt)
        if res is None:
            return None
        _step, (sweep, meta) = res
        saved = dict(meta["config"])
        if saved != self.config:
            diffs = [
                f"{k}: snapshot={saved.get(k, '<absent>')!r} vs run={self.config.get(k, '<absent>')!r}"
                for k in sorted(set(saved) | set(self.config), key=str)
                if saved.get(k, "<absent>") != self.config.get(k, "<absent>")
            ]
            raise ValueError(
                f"checkpoint directory holds a different sweep (mismatched {'; '.join(diffs)})"
            )
        return sweep, meta

    def close(self) -> None:
        """Nothing to drain: saves are synchronous. Traced as the JAX
        package's ``save_wait`` span, which reads 0 s here."""
        with trace.span("save_wait"):
            pass

    # -- the population-sweep payload ---------------------------------------

    def save_population_sweep(self, step, state, unit, generator, scores, meta_extra):
        """Snapshot the fused-sweep payload. Device tensors come to the
        host by blocking copies and the files are written before this
        returns, so the saved bytes are this launch's although the next
        launch updates the population in place. Under a mesh the whole
        population is gathered to rank 0, the writer (every rank of its
        ``pop`` group joins)."""
        import torch

        tree = {"params": state.params, "momentum": state.momentum, "step": state.step}
        if self.mesh is not None and state.cohort:
            tree = self.mesh.gather_tree(tree, state.cohort, root=0)
        if not self.writes:
            return
        host = lambda d: {k: v.detach().to("cpu") for k, v in d.items()}
        self.save(
            step,
            sweep={
                "state": {"params": host(tree["params"]), "momentum": host(tree["momentum"]),
                          "step": tree["step"].detach().to("cpu")},
                "unit": unit.detach().to("cpu"),
                # a CPU generator's Mersenne state; a CUDA one's seed and
                # Philox offset
                "rng_state": generator.get_state(),
                "scores": torch.as_tensor(scores),
            },
            meta_extra=meta_extra,
        )

    def restore_wave_sweep(self):
        """(sweep, meta) of a wave-scheduled sweep's newest verified
        step, or None. The sweep holds host tensors, discriminated by
        ``meta["waves_done"]``:

        - a generation boundary (``waves_done == 0``): ``front`` (the
          pool after the generation's training), ``perm`` (the exploit
          source map the next stage-in applies), ``unit``,
          ``rng_state`` (the next generation's start) and ``scores``
          (post-exploit);
        - between waves (``waves_done == k``): also ``back`` (the pool
          written through wave k); ``rng_state`` is the generation's
          start and ``scores`` the pre-exploit scores, NaN past the
          completed waves.
        """
        return self.restore()

    def restore_population_sweep(self):
        """(PopState on the host, unit, generator state, scores, meta)
        from the newest verified step, or None."""
        from mpi_opt_tpu_torch.train.population import PopState

        r = self.restore()
        if r is None:
            return None
        sweep, meta = r
        st = sweep["state"]
        state = PopState(params=st["params"], momentum=st["momentum"], step=st["step"])
        return state, sweep["unit"], sweep["rng_state"], sweep["scores"].numpy(), meta


class SearchCheckpointer:
    """Durable snapshots of a driver-path search (port of
    ``SearchCheckpointer`` in ``mpi_opt_tpu/utils/checkpoint.py``): the
    algorithm's state and the backend's host state (JSON, in the step's
    meta) and the backend's device pool (host tensors), every ``every``
    completed batches, through ``SweepCheckpointer``'s verified steps,
    retention and last-good walk-back. A directory of a fused sweep is
    refused as a config mismatch.

    ``step`` is the driver's batch count of this process; after
    ``restore_into`` the restored snapshot's batch is added to it, so a
    resumed search numbers its snapshots on from where it left off."""

    CONFIG = {"kind": "search"}

    def __init__(self, directory: str, every: int = 1, keep: int = 3, mesh=None):
        if every < 1:
            raise ValueError(f"checkpoint every must be >= 1, got {every}")
        self.every = every
        self._ck = SweepCheckpointer(directory, dict(self.CONFIG), keep=keep, mesh=mesh)
        self.directory = self._ck.directory
        self._base = 0  # the restored snapshot's batch

    def maybe_save(self, step: int, algorithm, backend) -> bool:
        """Save if ``step`` is on the cadence; returns whether it saved."""
        if (self._base + step) % self.every:
            return False
        self.save(step, algorithm, backend)
        return True

    def save(self, step: int, algorithm, backend) -> None:
        """Commit batch ``step``: the pool comes to the host by blocking
        copies before the files are written (under a mesh every rank
        joins the pool's gather; rank 0 writes)."""
        step = self._base + step
        search = {"algorithm": algorithm.state_dict(), "backend": backend.host_state_dict()}
        pool = backend.device_state()  # None on a rank that does not write
        sweep = {}
        if pool is not None:
            host = lambda d: {k: v.detach().to("cpu") for k, v in d.items()}
            sweep["pool"] = {"params": host(pool.params), "momentum": host(pool.momentum),
                             "step": pool.step.detach().to("cpu")}
        self._ck.save(step, sweep, {"search": search, "batch": int(step)})

    def latest_step(self) -> Optional[int]:
        steps = self._ck.all_steps()
        return steps[-1] if steps else None

    def restore_into(self, algorithm, backend) -> Optional[int]:
        """Load the newest verified snapshot into a fresh algorithm and
        backend; returns its batch, or None when the directory holds no
        snapshot. Corrupt steps are quarantined and the walk goes back
        (``NoVerifiedSnapshotError`` when none verifies); the state is
        applied only after the step verified."""
        r = self._ck.restore()
        if r is None:
            return None
        sweep, meta = r
        algorithm.load_state_dict(meta["search"]["algorithm"])
        backend.load_host_state_dict(meta["search"]["backend"])
        if "pool" in sweep:
            backend.load_device_state(sweep["pool"])
        self._base = int(meta["batch"])
        return self._base

    def close(self) -> None:
        self._ck.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

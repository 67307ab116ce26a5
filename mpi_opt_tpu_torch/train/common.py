"""Pieces shared by the fused sweeps (port of parts of ``mpi_opt_tpu/train/common.py``)."""

from __future__ import annotations

import numpy as np
import torch

from mpi_opt_tpu_torch.obs import trace


def finite_winner(scores, ok=None):
    """(best_i, diverged) for a host score vector: the argmax over finite
    (and ``ok``-masked) entries. An all-diverged set returns (0, True)."""
    scores = np.asarray(scores)
    mask = np.isfinite(scores) if ok is None else (np.asarray(ok) & np.isfinite(scores))
    diverged = not bool(mask.any())
    best_i = 0 if diverged else int(np.where(mask, scores, -np.inf).argmax())
    return best_i, diverged


def seed_warm_row(unit: torch.Tensor, warm_obs) -> torch.Tensor:
    """The sampler-family warm start of the fused sweeps: row 0 of a
    freshly sampled unit matrix becomes the best fully finite prior
    point (``ledger.warmstart.best_observation``); the matrix comes
    back unchanged without a usable prior. It consumes no draw, so the
    other rows are the cold sweep's."""
    if not warm_obs:
        return unit
    from mpi_opt_tpu_torch.ledger.warmstart import best_observation

    bo = best_observation(warm_obs)
    if bo is not None:
        unit[0] = torch.as_tensor(np.asarray(bo.unit, dtype=np.float32), device=unit.device)
    return unit


def workload_arrays(workload, member_chunk: int, dev, mesh=None):
    """(trainer, space, train_x, train_y, val_x, val_y) of a population
    workload, the data on ``dev`` (labels as int64), cached on the
    workload instance as the JAX package caches them: the brackets of a
    Hyperband sweep, or a bench's warm-up and measured run, upload the
    data once. The key holds what shapes the trainer (member chunk,
    device, momentum dtype). A miss is traced as the ``setup`` span,
    with the device kind the roofline's cap is looked up by. ``mesh``
    gives the trainer over that mesh (``PopulationTrainer.on_mesh``)."""
    from mpi_opt_tpu_torch.workloads.base import resolve_momentum_dtype

    key = (member_chunk, str(dev), resolve_momentum_dtype())
    cache = getattr(workload, "_fused_cache", None)
    if cache is None or cache[0] != key:
        with trace.span("setup", workload=getattr(workload, "name", None)) as sp:
            trace.note_device(sp, dev)
            trainer = workload.make_trainer(member_chunk=member_chunk, device=dev,
                                            momentum_dtype=key[2])
            d = workload.data()
            train_x, train_y, val_x, val_y = (
                torch.from_numpy(d[k]).to(dev) for k in ("train_x", "train_y", "val_x", "val_y")
            )
            workload._fused_cache = (key, trainer, workload.default_space(), train_x,
                                     train_y.long(), val_x, val_y.long())
    trainer, *rest = workload._fused_cache[1:]
    return (trainer if mesh is None else trainer.on_mesh(mesh), *rest)


def journal_boundary(journal, b_local: int, members, units, scores, step: int,
                     scores_mo=None) -> None:
    """Journal (or, on a resume, verify) one boundary's member records
    before its snapshot, as a ``journal`` span; no-op without a
    journal. One span a boundary, not a record, so the trace grows with
    boundaries, not members. ``scores_mo`` (a multi-objective sweep's
    raw ``[n, m]`` matrix) rides each record as its ``scores`` vector;
    ``scores`` stays the scalarized primary."""
    if journal is None:
        return
    with trace.span("journal", boundary=int(b_local), n=len(members)):
        journal.record_boundary(b_local, members, units, scores, step=step, scores_mo=scores_mo)


#: the objective metrics the population eval path gives; the names of a
#: fused multi-objective sweep's ObjectiveSpec come from this set
POPULATION_METRICS = ("accuracy", "params", "latency")


def eval_population_objectives(trainer, state, val_x, val_y, names) -> torch.Tensor:
    """Raw objective matrix ``float32[P, m]``, one column per name, on
    the population's device: nothing is read back to the host. Under a
    mesh every column covers the whole population."""
    cols = []
    for name in names:
        if name == "accuracy":
            cols.append(trainer.eval_population(state, val_x, val_y))
        elif name == "params":
            cols.append(trainer.gather_rows(trainer.member_effective_params(state), state))
        elif name == "latency":
            cols.append(trainer.gather_rows(trainer.member_latency_proxy(state), state))
        else:
            raise ValueError(
                f"unknown population objective {name!r}; supported: {POPULATION_METRICS}"
            )
    return torch.stack(cols, dim=-1)


def check_objectives(workload, objectives) -> None:
    """Refuse objective names the workload cannot evaluate (``ValueError``)."""
    supported = tuple(workload.objective_metrics())
    missing = [n for n in objectives.names if n not in supported]
    if missing:
        raise ValueError(
            f"workload {getattr(workload, 'name', type(workload).__name__)!r} cannot evaluate "
            f"objectives {missing}; supported: {supported}"
        )


def pareto_summary(final_mo, objectives, members=None):
    """(winner row or None, the result's ``pareto`` block) of a final
    raw objective matrix: the constraint-aware winner (``select_best``)
    and the non-dominated front with its hypervolume. ``members`` maps
    rows to member identities (a SHA rung's surviving trials)."""
    from mpi_opt_tpu_torch.objectives import hypervolume, pareto_front_mask, select_best

    sel = select_best(final_mo, objectives)
    norm = objectives.normalize(final_mo)
    mask = pareto_front_mask(norm)
    rows = [int(i) for i in np.flatnonzero(mask)]
    return sel["index"], {
        "front_size": len(rows),
        "front_members": rows if members is None else [int(members[i]) for i in rows],
        "front_scores": [[float(v) for v in final_mo[i]] for i in rows],
        "hypervolume": float(hypervolume(norm[mask])) if rows else 0.0,
        "selection": sel["kind"],
        "violation": sel["violation"],
    }


def segment_flops_hint(workload, population: int, steps: int):
    """FLOPs of one boundary (``steps`` training steps of ``population``
    members and one eval), for the ``flops`` attr of ``train`` spans, so
    the trace reports achieved TF/s. Paid only when tracing is on;
    cached per (population, steps) on the workload instance, and its
    own time is traced as ``setup`` (op ``flops_probe``) with anything
    inside suppressed. None untraced."""
    if not trace.enabled():
        return None
    cache = getattr(workload, "_flops_hint_cache", None)
    if cache is None:
        cache = workload._flops_hint_cache = {}
    key = (int(population), int(steps))
    if key not in cache:
        from mpi_opt_tpu_torch.utils.flops import population_sweep_flops

        with trace.span("setup", op="flops_probe", members=int(population)):
            with trace.suppressed():
                cache[key] = population_sweep_flops(workload, int(population), 1, int(steps),
                                                    n_evals=1)
    return cache[key]


def hparams_fn(space, workload):
    """unit matrix [P, d] -> the workload's ``OptHParams``."""
    return lambda unit: workload.make_hparams(space.from_unit(unit))


def momentum_dtype_str() -> str:
    """Checkpoint-config form of the momentum storage dtype ('float32'
    by default). The dtype is part of the carried state's structure, so
    resuming a bf16-momentum snapshot into an f32 trainer is refused as
    a config mismatch."""
    from mpi_opt_tpu_torch.workloads.base import resolve_momentum_dtype

    return resolve_momentum_dtype() or "float32"


def launch_boundary(stage: str, *, final: bool, snapshot=None, **progress) -> None:
    """The fused host loop's per-launch service point, called once at
    the end of every launch, after its results were fetched and
    journaled: the span records held in memory are written
    (``trace.flush``), then the ``boundary_fault`` seam, the heartbeat, then a
    pending graceful-shutdown request is honoured by flushing the
    boundary snapshot via ``snapshot()`` (None when the cadence save
    already ran or the sweep does not checkpoint) and raising
    ``SweepInterrupted``, so the CLI exits ``EX_TEMPFAIL``.
    ``final=True`` (the last boundary) suppresses the drain: completing
    a finished sweep beats preempting it.

    Under multi-process SPMD the coord plane (``parallel/coord.py``)
    chains its drain agreement onto the shutdown slice hook: the tick
    votes this rank's shutdown flag into the boundary's barrier, and
    the drain additionally requires the AGREED verdict
    (``coord.drain_allowed``), so a signal that lands on one rank after
    this boundary's vote closed waits for the next boundary's vote
    instead of draining half the world. The stage is then labelled
    ``boundary:<stage>``: a rank frozen here waits in the agreement
    barrier, the last-beat shape ``launch.py`` reads as a collective
    wedge. The sweep service's slice hook (``service/scheduler.py``)
    is the hook's other user: it counts the boundaries of a tenant's
    slice and requests the drain at the slice's budget."""
    from mpi_opt_tpu_torch.health import heartbeat, shutdown
    from mpi_opt_tpu_torch.parallel import coord
    from mpi_opt_tpu_torch.utils import resources

    # the spans held in memory reach the sink before any hook runs: a
    # slice hook's reader sees the slice's spans
    trace.flush()
    if coord.active_plane() is not None:
        stage = f"boundary:{stage}"
    resources.boundary_fault(stage)
    heartbeat.beat(stage=stage, **progress)
    if not final:
        shutdown.poll_slice(stage)
    if final or not shutdown.requested():
        return
    if not coord.drain_allowed():
        return
    if snapshot is not None:
        snapshot()
    raise shutdown.SweepInterrupted(shutdown.active_signal(), at=stage)

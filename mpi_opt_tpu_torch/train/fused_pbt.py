"""Fused PBT (port of ``mpi_opt_tpu/train/fused_pbt.py``).

Each generation trains the population, evaluates it, runs
exploit/explore, and gathers the winners' states, all on the device;
the host reads back only the small per-generation curves, once per
launch. One ``torch.Generator`` carries every draw through the sweep,
so splitting it into launches (``gen_chunk``) or a generation's
training into sub-launches (``step_chunk``) gives exactly the result of
one launch.

A population larger than the card holds runs in WAVES
(``wave_size``, ``_fused_pbt_waves``): its state lives in host pools
and each generation trains waves of W members through the wave engine
(``train/engine.py``), while the exploit still ranks the whole
population. Wave mode gives the resident sweep's result bit for bit on
the CPU.

Durability follows the JAX package's resident loop: launch-granular
verified snapshots (``checkpoint_dir``, ``utils/checkpoint.py``) that a
call with the same arguments resumes from, a member-granular ledger
journal (``ledger``) written before each snapshot and verified on
resume, a graceful drain at every launch boundary (and between waves),
and typed device OOM, which wave mode absorbs by halving its wave cap
(``oom_backoff``).

``objectives`` (an ``ObjectiveSpec``) makes a resident sweep
multi-objective: each generation evaluates the objective matrix on the
device, the exploit ranks by Pareto score (``pbt_exploit_explore_mo``),
the journal records each member's vector, and the winner is the best
feasible member (``objectives.select_best``). As in the JAX package it
runs resident only, without ``step_chunk``.

``mesh`` (``parallel/mesh.py``) shards the population over ranks: each
rank trains and scores its rows, every rank computes the same exploit
from the gathered scores, and only the rows the exploit copies move
between ranks. A pop-sharded sweep gives the bits of a one-process
sweep launched at the same width (``member_chunk = P / n_pop``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from mpi_opt_tpu_torch.device import resolve_device
from mpi_opt_tpu_torch.ledger.fused import make_journal
from mpi_opt_tpu_torch.obs import memory, trace
from mpi_opt_tpu_torch.ops.pbt import PBTConfig, pbt_exploit_explore, pbt_exploit_explore_mo
from mpi_opt_tpu_torch.train.common import (
    check_objectives,
    eval_population_objectives,
    finite_winner,
    hparams_fn,
    journal_boundary,
    launch_boundary,
    momentum_dtype_str,
    pareto_summary,
    seed_warm_row,
    segment_flops_hint,
    workload_arrays,
)
from mpi_opt_tpu_torch.train.engine import (
    WaveRunner,
    balanced_split,
    boundary_span,
    launch_chunk,
    resolve_wave_size,
    wave_layout,
)
from mpi_opt_tpu_torch.train.engine import run_wave as _run_wave
from mpi_opt_tpu_torch.train.population import PopState
from mpi_opt_tpu_torch.utils import profiling, resources


def finish_generation(trainer, state, unit, generator, val_x, val_y, disc, cfg: PBTConfig,
                      objectives=None, norm_bounds=None):
    """The generation boundary: eval the population, exploit/explore,
    gather the winners' states. Returns (state, new_unit, best, mean,
    n_fail, post-exploit scores, pre-exploit scores, the unit matrix
    the generation trained with, pre-exploit objective matrix,
    post-exploit objective matrix); the pre-exploit values are what the
    ledger journals. The post-exploit values are the gathered
    pre-exploit ones: weights are copied verbatim.

    With ``objectives`` the raw ``[P, m]`` matrix is evaluated, its
    scalarized primary is the generation's score, the exploit ranks by
    Pareto score under the maximize-form ``norm_bounds`` (a tensor on
    the device, or None), and a member fails when any of its objectives
    is non-finite; a scalar sweep's matrices are None."""
    if objectives is None:
        scores = trainer.eval_population(state, val_x, val_y)
        new_unit, src_idx, best, mean, n_fail, post = _wave_exploit(generator, unit, scores, disc, cfg)
        return (trainer.gather_members(state, src_idx), new_unit, best, mean, n_fail, post, scores,
                unit, None, None)
    mo = eval_population_objectives(trainer, state, val_x, val_y, objectives.names)
    scores = objectives.scalarize(mo)
    new_unit, src_idx, _, _ = pbt_exploit_explore_mo(generator, unit, objectives.normalize(mo), disc,
                                                     cfg, norm_bounds=norm_bounds)
    n_fail = (~torch.isfinite(mo).all(dim=-1)).sum()
    return (trainer.gather_members(state, src_idx), new_unit, scores.max(), scores.mean(), n_fail,
            scores[src_idx], scores, unit, mo, mo[src_idx])


def _run_stepped_generation(trainer, state, unit, to_hparams, train_x, train_y, val_x, val_y,
                            generator, disc, steps: int, step_chunk: int, cfg: PBTConfig,
                            objectives=None, norm_bounds=None):
    """One generation: its training as ceil(steps/step_chunk) sub-launches
    (one when step_chunk is 0), each closed by a heartbeat when chunked,
    then the boundary. The generator is threaded through the
    sub-launches, so a chunked generation equals the unchunked one bit
    for bit."""
    from mpi_opt_tpu_torch.health import heartbeat

    hp = to_hparams(unit)
    sub_lens = balanced_split(steps, step_chunk) if step_chunk > 0 else [steps]
    for i, s in enumerate(sub_lens):
        trainer.train_segment(state, hp, train_x, train_y, generator, s)
        if step_chunk > 0:
            heartbeat.beat(stage=f"pbt train sub-launch {i + 1}/{len(sub_lens)}")
    return finish_generation(trainer, state, unit, generator, val_x, val_y, disc, cfg,
                             objectives, norm_bounds)


def fused_pbt(  # sweeplint: barrier(resident host loop: launch boundaries, exploit, journal, snapshot)
    workload,
    population: int,
    generations: int,
    steps_per_gen: int,
    seed: int = 0,
    cfg: PBTConfig = PBTConfig(),
    member_chunk: int = 0,
    gen_chunk: int = 0,
    step_chunk: int = 0,
    checkpoint_dir: str | None = None,
    snapshot_every: int = 1,
    snapshot_last: bool = True,
    ledger=None,
    oom_backoff: int = 2,
    wave_size=0,
    device=None,
    objectives=None,
    warm_obs=None,
    mesh=None,
):
    """Run a whole PBT sweep of a population workload.

    ``gen_chunk`` splits the sweep into ceil(G/gen_chunk) launches
    (0 = one launch); the host syncs once per launch, to fetch that
    launch's curves and time it. ``step_chunk`` splits each generation's
    training into ceil(steps_per_gen/step_chunk) sub-launches (one
    generation a launch; it cannot be combined with ``gen_chunk > 1``).
    It is recorded in the checkpoint config, as in the JAX package, so
    a resume under another value is refused.

    ``checkpoint_dir`` makes the sweep crash-recoverable: after every
    ``snapshot_every`` launches (and after the last unless
    ``snapshot_last`` is False) the population state, unit matrix,
    generator state and scores are saved with the sweep's config and
    curves; a call with the same arguments and directory resumes at the
    newest verified snapshot and finishes with the result the unkilled
    sweep gives. A snapshot of another config (the device type
    included: a CPU snapshot continues another random stream than a
    CUDA one) raises ``ValueError``.

    ``ledger`` (an open ``ledger.SweepLedger`` with its header written)
    journals every generation's member records before that launch's
    snapshot; on resume, generations already journaled are verified
    against their records (``LedgerError`` on divergence).

    ``wave_size`` (an int or ``'auto'``, resolved by
    ``engine.resolve_wave_size``): with ``0 < wave_size < population``
    the sweep runs in waves through host pools (``_fused_pbt_waves``);
    it cannot be combined with ``gen_chunk``/``step_chunk``. A cap at or
    above the population runs resident. ``oom_backoff`` is how many
    times wave mode halves its cap on a device OOM and re-runs the
    generation; a resident sweep's device OOM raises ``DeviceOOM``.

    ``objectives`` (an ``ObjectiveSpec`` over the workload's
    ``objective_metrics()``) runs the multi-objective sweep; it refuses
    ``step_chunk`` and ``wave_size`` (``ValueError``), as the JAX
    package does, and is part of the snapshot config, so a scalar call
    does not resume a multi-objective snapshot (nor the reverse).

    ``warm_obs`` (prior-ledger ``Observation``s, cross-mode) seeds the
    initial population's row 0 with the best fully finite prior point
    (``ledger.warmstart.best_observation``) when no snapshot was
    restored: the sampler-family warm start of driver random/ASHA.

    Returns the result dict of the JAX package's ``fused_pbt``:
    best_score, best_params, diverged, best_curve, mean_curve,
    member_failures, state, unit, launch_gens, launch_walls (the
    completed launches' walls, from the snapshot on a resume), journal
    ({"written", "verified"} member records, None without a ledger),
    objectives (the names, or None) and pareto (the final population's
    front: front_size, front_members, front_scores, hypervolume,
    selection, violation; None on a scalar sweep, or on a resume that
    restarted past the last launch); in wave mode also ``WaveRunner.result_extras()``, and ``state`` is
    on the host.

    ``mesh`` (a ``parallel.mesh.Mesh``) runs the sweep sharded over the
    ranks' ``pop`` axis and splits each batch over ``data``; every rank
    calls ``fused_pbt`` with the same arguments and gets the same
    result, except ``state``: this rank's rows (all of them in wave
    mode, where the pools are host copies every rank holds).
    """
    if generations < 1:
        raise ValueError(f"generations must be >= 1, got {generations}")
    if step_chunk > 0 and gen_chunk > 1:
        raise ValueError(
            "step_chunk splits within generations; combining it with "
            f"gen_chunk={gen_chunk} (grouping whole generations) is ambiguous"
        )
    if objectives is not None:
        if step_chunk > 0:
            raise ValueError(
                "step_chunk is not supported with multi-objective sweeps "
                "(the sub-segment boundary program is scalar); use gen_chunk"
            )
        if wave_size:
            raise ValueError(
                "wave scheduling is not supported with multi-objective sweeps yet; "
                "run resident (wave_size=0)"
            )
        check_objectives(workload, objectives)
    dev = resolve_device(device)

    trainer, space, train_x, train_y, val_x, val_y = workload_arrays(workload, member_chunk, dev,
                                                                     mesh)
    if wave_size:
        wave_size = resolve_wave_size(trainer, population, wave_size=wave_size,
                                      oom_backoff=oom_backoff, mesh=mesh)
        if 0 < wave_size < population:
            if step_chunk > 0 or gen_chunk > 1:
                raise ValueError(
                    "wave_size schedules whole generations as resident waves; combining "
                    "it with gen_chunk/step_chunk launch splitting is ambiguous"
                )
            return _fused_pbt_waves(
                workload, trainer, space, (train_x, train_y, val_x, val_y), population,
                generations, steps_per_gen, seed, cfg, member_chunk, wave_size,
                checkpoint_dir, snapshot_every, snapshot_last, ledger, oom_backoff, dev, warm_obs,
                mesh)
    disc = space.discrete_mask()
    to_hparams = hparams_fn(space, workload)

    if step_chunk > 0:
        gen_chunk = 1  # every launch is exactly one generation
    launch_lens = balanced_split(generations, generations if gen_chunk <= 0 else min(gen_chunk, generations))
    n_launches = len(launch_lens)

    # restore BEFORE initialising: a resumed sweep must not pay for (or
    # hold the memory of) an init it discards
    gen = torch.Generator(device=dev)
    snap = restored = None
    start_launch = 0
    best_parts, mean_parts, fail_parts, launch_walls = [], [], [], []
    scores_np = None
    if checkpoint_dir is not None:
        from mpi_opt_tpu_torch.utils.checkpoint import SweepCheckpointer

        ck_config = {
            "workload": getattr(workload, "name", type(workload).__name__),
            "population": population,
            "generations": generations,
            "steps_per_gen": steps_per_gen,
            "seed": seed,
            "launch_lens": launch_lens,
            "member_chunk": member_chunk,
            "cfg": dataclasses.asdict(cfg),
            "step_chunk": step_chunk,
            "momentum_dtype": momentum_dtype_str(),
            "wave_size": 0,
            # the generator's state is per device type: a CPU snapshot
            # resumed on CUDA (or the reverse) would continue another
            # random stream
            "device": dev.type,
        }
        if objectives is not None:
            # the selection rule is part of the trajectory; a scalar
            # sweep writes no key, so its snapshots resume as before
            ck_config["objectives"] = objectives.spec()
        snap = SweepCheckpointer(checkpoint_dir, ck_config, mesh=mesh)
        restored = snap.restore_population_sweep()
    if restored is not None:
        host_state, unit, rng_state, scores_np, meta = restored
        # this rank's rows of the full restored copy under a mesh
        state = trainer.place(host_state)
        unit = unit.to(dev)
        gen.set_state(rng_state)
        best_parts = [np.asarray(v, dtype=np.float32) for v in meta["best"]]
        mean_parts = [np.asarray(v, dtype=np.float32) for v in meta["mean"]]
        fail_parts = [np.asarray(v, dtype=np.int64) for v in meta["member_fail"]]
        launch_walls = [float(w) for w in meta["launch_walls"]]
        start_launch = int(meta["launches_done"])
    journal = make_journal(ledger, space)
    if journal is not None:
        # every generation the snapshot records complete must already be
        # journaled (journal-before-snapshot); generations re-trained past
        # the snapshot verify against their records instead of re-writing
        journal.require_prefix(sum(launch_lens[:start_launch]))
    if restored is None:
        gen.manual_seed(seed)
        unit = seed_warm_row(space.sample_unit(gen, population), warm_obs)
        state = trainer.init_population(gen, population)

    snapshot_every = max(1, snapshot_every)
    # the maximize-form bounds on the device once, not a copy a generation
    norm_bounds = (torch.as_tensor(objectives.norm_bounds(), device=dev)
                   if objectives is not None and objectives.has_bounds else None)
    final_mo = None  # the last launch's post-exploit objective matrix (host)
    # a generation's FLOPs for the trace's achieved TF/s (None untraced)
    flops_gen = segment_flops_hint(workload, population, steps_per_gen)
    try:
        for i in range(start_launch, n_launches):
            profiling.launch_tick()
            t0 = time.perf_counter()
            best, mean, fails, pre_s, pre_u, pre_mo = [], [], [], [], [], []
            # a resident sweep has no wave to halve: a CUDA OOM leaves as
            # DeviceOOM, which the CLI exits 74 on. The launch's train span
            # ends after the curve fetch, its completion barrier
            with resources.oom_funnel(), trace.span("train", launch=i + 1, gens=launch_lens[i]) as sp:
                if objectives is not None:
                    sp["objectives"] = ",".join(objectives.names)
                resources.launch_fault("launch")
                for _ in range(launch_lens[i]):
                    state, unit, b, m, f, scores, s_pre, u_pre, mo_pre, mo_post = _run_stepped_generation(
                        trainer, state, unit, to_hparams, train_x, train_y, val_x, val_y, gen, disc,
                        steps_per_gen, step_chunk, cfg, objectives, norm_bounds)
                    best.append(b)
                    mean.append(m)
                    fails.append(f)
                    pre_s.append(s_pre)
                    pre_u.append(u_pre)
                    pre_mo.append(mo_pre)
                # the fetch is the launch's completion barrier
                best_parts.append(torch.stack(best).cpu().numpy())
                mean_parts.append(torch.stack(mean).cpu().numpy())
                fail_parts.append(torch.stack(fails).cpu().numpy())
                scores_np = scores.cpu().numpy()
                if objectives is not None:
                    final_mo = mo_post.cpu().numpy()
                # after the barrier: a launch that raised reports its
                # partial wall without FLOPs
                if flops_gen:
                    sp["flops"] = flops_gen * launch_lens[i]
                memory.note(sp, dev)
            launch_walls.append(time.perf_counter() - t0)
            g0 = sum(launch_lens[:i])
            if journal is not None:
                # journal this launch's generations (their pre-exploit
                # scores and units) BEFORE its snapshot, so the journal
                # never lags it; a generation re-computed on resume
                # verifies instead
                for j, (s_j, u_j, mo_j) in enumerate(zip(pre_s, pre_u, pre_mo)):
                    g = g0 + j
                    journal_boundary(journal, g, np.arange(population), u_j.cpu().numpy(),
                                     s_j.cpu().numpy(), step=(g + 1) * steps_per_gen,
                                     scores_mo=None if mo_j is None else mo_j.cpu().numpy())
            is_last = i + 1 == n_launches
            due = (i + 1) % snapshot_every == 0

            def save_now(i=i):  # sweeplint: barrier(snapshot save: the host curves and the population's state go to disk)
                snap.save_population_sweep(
                    i + 1, state, unit, gen, scores_np,
                    meta_extra={
                        "launches_done": i + 1,
                        # the ledger cross-check unit: generations complete
                        "boundaries_done": sum(launch_lens[: i + 1]),
                        "best": [v.tolist() for v in best_parts],
                        "mean": [v.tolist() for v in mean_parts],
                        "member_fail": [v.tolist() for v in fail_parts],
                        "launch_walls": [float(w) for w in launch_walls],
                    },
                )

            saved = False
            if snap is not None and ((due and not is_last) or (is_last and snapshot_last)):
                save_now()
                saved = True
            # heartbeat + graceful drain: a pending shutdown flushes an
            # off-cadence snapshot (unless one was just saved), then raises
            launch_boundary(
                f"pbt launch {i + 1}/{n_launches}",
                final=is_last,
                snapshot=None if (snap is None or saved) else save_now,
                launch=i + 1,
                of=n_launches,
            )
    finally:
        if snap is not None:
            snap.close()

    best_i, diverged = finite_winner(scores_np)
    pareto = None
    if final_mo is not None:
        # the best FEASIBLE member under the objectives (the least
        # violating one when none is), not the argmax of the primary
        best_i, pareto = pareto_summary(final_mo, objectives)
        diverged = best_i is None
        best_i = 0 if diverged else best_i
    np_unit = unit.cpu().numpy()
    return {
        "best_score": float("nan") if diverged else float(scores_np[best_i]),
        "best_params": None if diverged else space.materialize_row(np_unit[best_i]),
        "diverged": diverged,
        "best_curve": np.concatenate(best_parts),
        "mean_curve": np.concatenate(mean_parts),
        "member_failures": [int(v) for v in np.concatenate(fail_parts)],
        "state": state,
        "unit": np_unit,
        "launch_gens": launch_lens,
        "launch_walls": [float(w) for w in launch_walls],
        "journal": None if journal is None else {"written": journal.written, "verified": journal.verified},
        "objectives": None if objectives is None else list(objectives.names),
        "pareto": pareto,
    }


def _wave_exploit(generator, unit, scores, disc, cfg: PBTConfig):
    """The generation boundary's decision over the whole population's
    scores: exploit/explore, without the eval and the state gather. The
    wave path's boundary is this alone (each wave evaluated itself, and
    the next generation's stage-in reads the pool through ``src_idx``).
    Returns (new_unit, src_idx, best, mean, n_fail, post-exploit scores)."""
    new_unit, src_idx, _ = pbt_exploit_explore(generator, unit, scores, disc, cfg)
    n_fail = (~torch.isfinite(scores)).sum()
    return new_unit, src_idx, scores.max(), scores.mean(), n_fail, scores[src_idx]


def _fused_pbt_waves(  # sweeplint: barrier(wave host loop: stages pools, gathers scores, exploits at generation boundaries)
    workload, trainer, space, data, population: int, generations: int, steps_per_gen: int,
    seed: int, cfg: PBTConfig, member_chunk: int, wave_size: int, checkpoint_dir,
    snapshot_every: int, snapshot_last: bool, ledger, oom_backoff: int, dev, warm_obs=None,
    mesh=None,
):
    """Fused PBT over a population held in host pools, ``ceil(P/W)``
    waves a generation (``engine.WaveRunner``), with the exploit over the
    whole population and the winners' states reaching the next
    generation through the stage-in row map (``perm``).

    Bit-identical to the resident sweep on the CPU for any wave size:
    the pool is initialised with the resident init's draws
    (``init_population_into``), every wave restarts the generator at the
    generation's start and makes the whole population's draws
    (``train_segment_window``), and the exploit sees the same generator,
    unit matrix and scores. cuDNN (and oneDNN) choose algorithms by the
    member count of a launch, so the convolutional models hold identity
    through ``member_chunk``: every launch runs one chunk's members and
    waves hold whole chunks (``engine.wave_layout``).

    ``oom_backoff``: a device OOM in a generation's waves halves the cap
    and re-runs the generation from its first wave, bit-identically. The
    settled cap is recorded in every snapshot (``wave_size_run``) and
    adopted on resume; the requested cap stays the config's identity.

    Snapshots: at generation boundaries on the ``snapshot_every``
    cadence (the front pool, ``perm``, unit, generator state,
    post-exploit scores), and BETWEEN waves when a graceful drain is
    pending (both pools, the scores so far, the generator state at the
    generation's start), so a preempted sweep resumes without
    re-training completed waves.

    Under a mesh each wave splits over the ranks (``run_wave``), every
    rank holds the full pools, and only rank 0 writes snapshots."""
    from mpi_opt_tpu_torch.train.staging import nan_scores, pool_copy, pool_rows, population_pool

    train_x, train_y, val_x, val_y = data
    req_wave_size = wave_size
    wave_lens, _, _ = wave_layout(population, wave_size,
                                  launch_chunk(population, wave_size, member_chunk, oom_backoff))
    disc = space.discrete_mask()
    to_hparams = hparams_fn(space, workload)
    gen = torch.Generator(device=dev)

    best_list, mean_list, fail_list, gen_walls = [], [], [], []
    start_gen = start_wave = 0
    scores_host = nan_scores(population, dev)
    post_scores = None
    pool_front = pool_back = perm = unit = None
    rng_start = None  # the generator state at the current generation's start
    snap = restored = None
    if checkpoint_dir is not None:
        from mpi_opt_tpu_torch.utils.checkpoint import SweepCheckpointer

        snap = SweepCheckpointer(checkpoint_dir, {
            "workload": getattr(workload, "name", type(workload).__name__),
            "population": population,
            "generations": generations,
            "steps_per_gen": steps_per_gen,
            "seed": seed,
            "member_chunk": member_chunk,
            "cfg": dataclasses.asdict(cfg),
            "momentum_dtype": momentum_dtype_str(),
            # the REQUESTED cap: the snapshot holds pools shaped by the
            # wave split, so a resident run must not resume it (and the
            # reverse); an OOM backoff's smaller cap lives in meta
            "wave_size": req_wave_size,
            "wave_lens": list(wave_lens),
            "device": dev.type,
        }, mesh=mesh)
        restored = snap.restore_wave_sweep()
    if restored is not None:
        sweep, meta = restored
        best_list = [float(v) for v in meta["best"]]
        mean_list = [float(v) for v in meta["mean"]]
        fail_list = [int(v) for v in meta["member_fail"]]
        gen_walls = [float(v) for v in meta["gen_walls"]]
        start_gen, start_wave = int(meta["gen"]), int(meta["waves_done"])
        wave_size = int(meta.get("wave_size_run", wave_size))
        pool_front = pool_copy(trainer, sweep["front"])
        perm = sweep["perm"].numpy()
        unit = sweep["unit"].to(dev)
        gen.set_state(sweep["rng_state"])
        if start_wave:
            # mid-generation: the state saved is the generation's start
            rng_start = sweep["rng_state"]
            pool_back = pool_copy(trainer, sweep["back"])
            scores_host.copy_(sweep["scores"])
        else:
            post_scores = sweep["scores"].numpy()
    journal = make_journal(ledger, space)
    if journal is not None:
        journal.require_prefix(start_gen)
    # the pinned pools and the initial population written into them:
    # set-up a resident sweep does not pay
    with trace.span("setup", op="pools", members=population):
        if restored is None:
            gen.manual_seed(seed)
            unit = seed_warm_row(space.sample_unit(gen, population), warm_obs)
            perm = np.arange(population)
            pool_front = population_pool(trainer, population)
            trainer.init_population_into(gen, pool_front["params"])
        if pool_back is None:
            pool_back = population_pool(trainer, population)

    snapshot_every = max(1, snapshot_every)
    flops_gen = segment_flops_hint(workload, population, steps_per_gen)
    runner = WaveRunner(population, wave_size, member_chunk=member_chunk,
                         oom_backoff=oom_backoff, device=dev, requested=req_wave_size)
    try:
        for g in range(start_gen, generations):
            t_gen = time.perf_counter()
            resumed_mid = g == start_gen and start_wave > 0
            gen_partial0 = float(restored[1].get("wall_partial", 0.0)) if resumed_mid else 0.0
            if not resumed_mid:
                rng_start = gen.get_state()
                scores_host.fill_(float("nan"))
            # the whole population's hyperparameters, mapped eagerly as
            # the resident generation maps them; each wave trains its rows
            hp = to_hparams(unit)

            def dispatch(w, off, wl, eng, hp=hp, pool_front=pool_front, perm=perm, rng_start=rng_start):
                return _run_wave(trainer, pool_front, perm[off:off + wl], off, hp, train_x, train_y,
                                 val_x, val_y, gen, rng_start, steps_per_gen, eng,
                                 launch_width=runner.chunk, mesh=mesh)

            def dst(off, wl, pool_back=pool_back):
                return {"state": pool_rows(pool_back, off, wl), "scores": scores_host[off:off + wl]}

            def label(w, nw, g=g):
                return f"pbt gen {g + 1}/{generations} wave {w + 1}/{nw}"

            def midgen_snapshot(w, nw, g=g, t_gen=t_gen, gen_partial0=gen_partial0,
                                pool_front=pool_front, pool_back=pool_back, perm=perm,
                                unit=unit, rng_start=rng_start):
                def save_midgen():  # sweeplint: barrier(between-waves drain snapshot: the pools must hold every completed wave)
                    runner.engine.drain()
                    snap.save(g * nw + w + 1, sweep={
                        "front": pool_front, "back": pool_back,
                        "perm": torch.as_tensor(perm), "unit": unit.cpu(),
                        "rng_state": rng_start, "scores": scores_host.clone(),
                    }, meta_extra={
                        "gen": g,
                        "waves_done": w + 1,
                        # a mid-generation snapshot completes no boundary
                        "boundaries_done": g,
                        "wave_size_run": runner.wave_size,
                        "best": best_list, "mean": mean_list,
                        "member_fail": fail_list, "gen_walls": gen_walls,
                        "wall_partial": time.perf_counter() - t_gen + gen_partial0,
                    })

                return save_midgen

            wave_scores = runner.run_interval(
                n=population,
                run_wave_fn=dispatch,
                dst_fn=dst,
                scores_host=scores_host,
                stage_label=label,
                boundary_kwargs=lambda w, nw, g=g: {"launch": g * nw + w + 1, "of": generations * nw},
                midpoint_snapshot=None if snap is None else midgen_snapshot,
                start_wave=start_wave if resumed_mid else 0,
                notify_fields=(("gen", g + 1),),
                span_attrs=lambda nw, g=g: {"launch": g + 1, "gens": 1, "waves": nw},
                flops=flops_gen,
            )
            n_waves = runner.n_waves
            if journal is not None:
                # the generation's members (pre-exploit scores, the units
                # they trained with) BEFORE its snapshot
                journal_boundary(journal, g, np.arange(population), unit.cpu().numpy(),
                                 scores_host.numpy(), step=(g + 1) * steps_per_gen)
            with boundary_span("exploit", gen=g + 1):
                unit, src_idx, best, mean, n_fail, post = _wave_exploit(
                    gen, unit, torch.cat(wave_scores), disc, cfg)
                best_list.append(float(best))
                mean_list.append(float(mean))
                fail_list.append(int(n_fail))
                perm = src_idx.cpu().numpy()
                post_scores = post.cpu().numpy()
            del wave_scores
            pool_front, pool_back = pool_back, pool_front
            gen_walls.append(time.perf_counter() - t_gen + gen_partial0)
            is_last = g + 1 == generations
            due = (g + 1) % snapshot_every == 0

            def save_boundary(g=g, n_waves=n_waves):  # sweeplint: barrier(generation-boundary snapshot: the unit goes to disk)
                snap.save((g + 1) * n_waves, sweep={
                    "front": pool_front, "perm": torch.as_tensor(perm), "unit": unit.cpu(),
                    "rng_state": gen.get_state(), "scores": torch.as_tensor(post_scores),
                }, meta_extra={
                    "gen": g + 1,
                    "waves_done": 0,
                    "boundaries_done": g + 1,
                    "wave_size_run": runner.wave_size,
                    "best": best_list, "mean": mean_list,
                    "member_fail": fail_list, "gen_walls": gen_walls,
                })

            saved = False
            if snap is not None and ((due and not is_last) or (is_last and snapshot_last)):
                save_boundary()
                saved = True
            launch_boundary(
                f"pbt gen {g + 1}/{generations} wave {n_waves}/{n_waves}",
                final=is_last,
                snapshot=None if (snap is None or saved) else save_boundary,
                launch=(g + 1) * n_waves,
                of=generations * n_waves,
            )
    finally:
        runner.close()
        if snap is not None:
            snap.close()

    best_i, diverged = finite_winner(post_scores)
    np_unit = unit.cpu().numpy()
    # the post-exploit population, on the host where it lives: the
    # winners' rows through the perm
    idx = torch.as_tensor(perm)
    take = lambda d: {k: v.index_select(0, idx) for k, v in d.items()}
    state = PopState(take(pool_front["params"]), take(pool_front["momentum"]),
                     pool_front["step"].index_select(0, idx))
    return {
        "best_score": float("nan") if diverged else float(post_scores[best_i]),
        "best_params": None if diverged else space.materialize_row(np_unit[best_i]),
        "diverged": diverged,
        "best_curve": np.asarray(best_list, dtype=np.float32),
        "mean_curve": np.asarray(mean_list, dtype=np.float32),
        "member_failures": [int(v) for v in fail_list],
        "state": state,
        "unit": np_unit,
        "launch_gens": [1] * generations,
        "launch_walls": [float(v) for v in gen_walls],
        **runner.result_extras(),
        "journal": None if journal is None else {"written": journal.written, "verified": journal.verified},
    }


"""Fused successive halving (port of ``mpi_opt_tpu/train/fused_asha.py``).

The whole rung cohort trains in lockstep as one population, so the
synchronous variant of ASHA is the natural one: train every member to
the rung's budget, evaluate, keep the top 1/eta (``ops.asha.asha_cut``),
gather the survivors into a smaller population, go on. Random search is
the one-rung case.

A cohort larger than the card holds trains in waves through the wave
engine (``train/engine.py``): each rung gets a fresh host pool sized to
its cohort, and the cut's survivor gather is the next rung's stage-in
row map. Bit-identical to the resident sweep on the CPU for any wave
size. The resident sweep without snapshot or journal fetches nothing
until its last rung (one fetch replays the per-rung records).

``fused_hyperband`` runs one ``fused_sha`` a bracket, each journaling
under its bracket's boundary/trial/member offsets, so one ledger spans
the whole sweep as one contiguous boundary sequence.

``init_unit`` replaces a sweep's uniform initial cohort, and
``fused_hyperband``'s ``cohort_fn``/``observe_fn`` hooks let fused BOHB
(``train/fused_bohb.py``) sample each bracket's cohort from its model
and feed every rung back. ``objectives`` makes a resident ``fused_sha``
multi-objective: each rung evaluates the objective matrix on the
device, the cut ranks by Pareto score (``ops.asha.asha_cut_mo``), the
journal records each member's vector, and the winner is the last rung's
best feasible survivor. ``warm_obs`` (prior-ledger observations)
starts one cohort row at the prior best.

``mesh`` shards every rung's cohort over the ranks' ``pop`` axis, and
``round_to`` (``mesh.shape["pop"]`` by default under a mesh) rounds the
survivor counts up to a multiple of it, so every rung after the first
shards; the cut moves only the survivors another rank holds.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from mpi_opt_tpu_torch.device import resolve_device
from mpi_opt_tpu_torch.ledger.fused import make_journal
from mpi_opt_tpu_torch.obs import memory, trace
from mpi_opt_tpu_torch.ops.asha import asha_cut, asha_cut_mo, asha_rungs
from mpi_opt_tpu_torch.train.common import (
    check_objectives,
    eval_population_objectives,
    finite_winner,
    journal_boundary,
    launch_boundary,
    momentum_dtype_str,
    pareto_summary,
    seed_warm_row,
    segment_flops_hint,
    workload_arrays,
)
from mpi_opt_tpu_torch.train.engine import WaveRunner, boundary_span, resolve_wave_size
from mpi_opt_tpu_torch.train.engine import run_wave as _run_wave
from mpi_opt_tpu_torch.train.population import PopState
from mpi_opt_tpu_torch.utils import profiling

def _cut_and_gather(trainer, state, unit, scores, eta: int, k: int, norm_bounds=None):
    """One rung reduction: rank, keep the top ``k`` (the rung's known
    survivor count), gather their states. ``scores`` is the cohort's
    scalar scores ``[n]``, or its maximize-form objective matrix ``[n,
    m]``, ranked by Pareto score under ``norm_bounds`` (``asha_cut_mo``).
    Returns (survivor state, survivor unit, keep indices, promote mask)."""
    if scores.dim() == 2:
        promote, order, _eff = asha_cut_mo(scores, eta, norm_bounds=norm_bounds)
    else:
        promote, order = asha_cut(scores, eta)
    keep = order[:k]
    return trainer.gather_members(state, keep), unit[keep], keep, promote


def _wave_cut(unit, scores, eta: int, k: int):
    """The rung cut of a wave-scheduled cohort: ``_cut_and_gather``
    without the state gather (the next rung's stage-in reads the pool
    through ``keep``). Returns (survivor unit, keep indices)."""
    _promote, order = asha_cut(scores, eta)
    keep = order[:k]
    return unit[keep], keep


def sha_cohort_sizes(n_trials: int, n_rungs: int, eta: int, round_to: int = 1) -> list[int]:
    """Population at each rung: n, ceil(n/eta), ... (>= 1), survivor
    counts rounded up to a multiple of ``round_to``."""
    sizes = [n_trials]
    for _ in range(n_rungs - 1):
        k = -(-sizes[-1] // eta)  # ceil
        k = min(sizes[-1], -(-k // round_to) * round_to)
        sizes.append(max(k, 1))
    return sizes


def fused_sha(  # sweeplint: barrier(rung host loop: gathers cohort scores for the rung cut + journal)
    workload,
    n_trials: int,
    min_budget: int = 10,
    max_budget: int = 270,
    eta: int = 3,
    seed: int = 0,
    member_chunk: int = 0,
    checkpoint_dir: str | None = None,
    ledger=None,
    wave_size=0,
    oom_backoff: int = 2,
    device=None,
    boundary_offset: int = 0,
    trial_offset: int = 0,
    member_offset: int = 0,
    init_unit=None,
    objectives=None,
    warm_obs=None,
    mesh=None,
    round_to: int = 1,
):
    """Run a whole successive-halving sweep with on-device rung cuts.

    ``wave_size`` (an int or ``'auto'``): with ``0 < wave_size <
    n_trials`` every rung's cohort trains in waves through a host pool
    (``oom_backoff`` halvings of the cap on a device OOM, each re-running
    the rung bit-identically). ``checkpoint_dir`` snapshots the surviving
    cohort, its unit rows, the generator and the trial records after
    every rung; a call with the same arguments resumes at the next rung
    with the unkilled sweep's result, and a snapshot of another config
    (wave and resident sweeps refuse each other) raises ``ValueError``.
    ``ledger`` journals one record per cohort member per rung (its
    pre-cut score at the rung's budget) before the rung's snapshot;
    ``boundary_offset``/``trial_offset``/``member_offset`` shift its
    boundaries, trial ids and members (``fused_hyperband``'s brackets).
    ``init_unit`` (float ``[n_trials, dim]`` in the unit cube) replaces
    the uniform initial cohort (fused BOHB's model draws); its SHA-1 is
    part of the snapshot's identity, so a resume under other initial
    configurations is refused. ``objectives`` (an ``ObjectiveSpec``)
    runs a resident multi-objective sweep (waves refuse it with
    ``ValueError``, as in the JAX package); the spec is part of the
    snapshot's identity. ``warm_obs`` (prior-ledger observations,
    cross-mode) starts row 0 of the uniform initial cohort at the best
    fully finite prior point when no snapshot was restored (the
    sampler-family warm start of driver ASHA); ``init_unit`` takes
    precedence.

    Returns the JAX package's result: best_score, best_params,
    best_trial, diverged, rung_budgets, rung_sizes, stop_rung,
    last_score, rung_history, member_failures, n_trials, journal,
    objectives and pareto (the last rung's front, as ``fused_pbt``'s;
    None on a scalar sweep or a resume past the last rung), and in wave
    mode ``WaveRunner.result_extras()``.

    ``mesh`` (a ``parallel.mesh.Mesh``): every rank calls with the same
    arguments; each trains and scores its rows of every rung, and all
    return the same result. ``round_to`` rounds the rung sizes up to a
    multiple (``sha_cohort_sizes``); under a mesh it defaults to the
    ``pop`` axis, so only a first cohort that the axis does not divide
    runs replicated (with a warning).
    """
    if mesh is not None and round_to == 1:
        round_to = mesh.shape["pop"]
    dev = resolve_device(device)
    trainer, space, train_x, train_y, val_x, val_y = workload_arrays(workload, member_chunk, dev,
                                                                     mesh)
    wave_size = resolve_wave_size(trainer, n_trials, wave_size=wave_size, oom_backoff=oom_backoff,
                                  mesh=mesh)
    waves = 0 < wave_size < n_trials
    norm_bounds = None
    if objectives is not None:
        if waves:
            raise ValueError(
                "wave scheduling is not supported with multi-objective sweeps yet; "
                "run resident (wave_size=0)"
            )
        check_objectives(workload, objectives)
        if objectives.has_bounds:
            # on the device once, not a copy a rung
            norm_bounds = torch.as_tensor(objectives.norm_bounds(), device=dev)
    rungs = asha_rungs(min_budget, max_budget, eta)
    sizes = sha_cohort_sizes(n_trials, len(rungs), eta, round_to)
    if init_unit is not None:
        init_unit = np.asarray(init_unit, dtype=np.float32)
        if init_unit.shape != (n_trials, space.dim):
            raise ValueError(f"init_unit shape {init_unit.shape} != ({n_trials}, {space.dim})")

    # which original trial occupies each cohort row, and the trial records
    alive = np.arange(n_trials)
    stop_rung = np.zeros(n_trials, dtype=np.int32)
    last_score = np.full(n_trials, np.nan, dtype=np.float32)
    rung_history: list = []
    gen = torch.Generator(device=dev)
    state = pool_front = perm = None
    run_wave_size = wave_size
    snap = restored = None
    start_rung = 0
    np_scores = None
    if checkpoint_dir is not None:
        from mpi_opt_tpu_torch.utils.checkpoint import SweepCheckpointer

        ck_config = {
            "workload": getattr(workload, "name", type(workload).__name__),
            "n_trials": n_trials,
            "rungs": rungs,
            "sizes": sizes,
            "eta": eta,
            "seed": seed,
            "member_chunk": member_chunk,
            "momentum_dtype": momentum_dtype_str(),
            # the requested (resolved) cap: a wave snapshot holds a pool,
            # and wave and resident sweeps refuse each other's snapshots
            "wave_size": wave_size if waves else 0,
            "device": dev.type,
            # the initial cohort defines the sweep
            "init_unit_digest": (None if init_unit is None
                                 else hashlib.sha1(init_unit.tobytes()).hexdigest()),
        }
        if objectives is not None:
            # the selection rule shapes every cut; a scalar sweep writes
            # no key, so its snapshots resume as before
            ck_config["objectives"] = objectives.spec()
        snap = SweepCheckpointer(checkpoint_dir, ck_config, mesh=mesh)
        restored = snap.restore_population_sweep()
    if restored is not None:
        host_state, unit, rng_state, np_scores, meta = restored
        alive = np.asarray(meta["alive"], dtype=np.int64)
        stop_rung = np.asarray(meta["stop_rung"], dtype=np.int32)
        last_score = np.asarray(meta["last_score"], dtype=np.float32)
        start_rung = int(meta["rungs_done"])
        rung_history = list(meta["rung_history"])
        unit = unit.to(dev)
        gen.set_state(rng_state)
        if waves:
            # the saved survivors become the next rung's pool, in cohort order
            run_wave_size = int(meta.get("wave_size_run", wave_size))
            from mpi_opt_tpu_torch.train.staging import pool_copy

            pool_front = pool_copy(trainer, {"params": host_state.params,
                                             "momentum": host_state.momentum,
                                             "step": host_state.step})
            perm = np.arange(len(alive))
        else:
            # this rank's rows of the full restored copy under a mesh
            state = trainer.place(host_state)
    journal = make_journal(ledger, space, boundary_offset=boundary_offset,
                           trial_offset=trial_offset, member_offset=member_offset)
    if journal is not None:
        journal.require_prefix(start_rung)
    if restored is None:
        gen.manual_seed(seed)
        if init_unit is not None:
            unit = torch.from_numpy(init_unit).to(dev)
        else:
            unit = seed_warm_row(space.sample_unit(gen, n_trials), warm_obs)
        if waves:
            from mpi_opt_tpu_torch.train.staging import population_pool

            with trace.span("setup", op="pools", members=n_trials):
                pool_front = population_pool(trainer, n_trials)
                trainer.init_population_into(gen, pool_front["params"])
            perm = np.arange(n_trials)
        else:
            state = trainer.init_population(gen, n_trials)

    def record_rung(r: int, np_scores_r) -> None:
        """The trial records of one rung's pre-cut cohort (the eager and
        the deferred paths both write them here)."""
        stop_rung[alive] = r
        last_score[alive] = np_scores_r
        rung_history.append({
            "budget": int(rungs[r]),
            "trials": [int(i) for i in alive],
            "scores": [float(v) for v in np_scores_r],
        })

    # without snapshot, journal or waves nothing on the host needs a
    # rung's scores before the sweep ends: one fetch after the last rung
    defer = snap is None and journal is None and not waves
    runner = None
    if waves:
        runner = WaveRunner(n_trials, run_wave_size, member_chunk=member_chunk,
                            oom_backoff=oom_backoff, device=dev, requested=wave_size)
    rung_scores_dev: list = []
    rung_keep_dev: list = []
    mo = np_mo = None  # a rung's raw objective matrix, on the device and the host
    try:
        for r in range(start_rung, len(rungs)):
            budget = rungs[r]
            steps = budget - (rungs[r - 1] if r > 0 else 0)
            # a rung is a launch, as the JAX package ticks it: in waves
            # the runner's interval ticks once more
            profiling.launch_tick()
            # the rung's FLOPs for the trace (None untraced), probed
            # before its span; a deferred rung's span times dispatch only
            # and carries none
            f = None if defer else segment_flops_hint(workload, sizes[r], steps)
            # the cohort's hyperparameters, mapped eagerly (a wave trains
            # its rows of them)
            hp = workload.make_hparams(space.from_unit(unit))
            if waves:
                from mpi_opt_tpu_torch.train.staging import nan_scores, pool_rows, population_pool

                n_r = sizes[r]
                with trace.span("setup", op="pools", members=n_r):
                    pool_back = population_pool(trainer, n_r)
                scores_host = nan_scores(n_r, dev)
                rng_start = gen.get_state()

                def dispatch(w, off, wl, eng, hp=hp, pool_front=pool_front, perm=perm,
                             rng_start=rng_start, steps=steps):
                    return _run_wave(trainer, pool_front, perm[off:off + wl], off, hp, train_x,
                                     train_y, val_x, val_y, gen, rng_start, steps, eng,
                                     launch_width=runner.chunk, mesh=mesh)

                wave_scores = runner.run_interval(
                    n=n_r,
                    run_wave_fn=dispatch,
                    dst_fn=lambda off, wl, pool_back=pool_back, scores_host=scores_host: {
                        "state": pool_rows(pool_back, off, wl), "scores": scores_host[off:off + wl]},
                    scores_host=scores_host,
                    stage_label=lambda w, nw, r=r: f"sha rung {r + 1}/{len(rungs)} wave {w + 1}/{nw}",
                    boundary_kwargs=lambda w, nw, r=r: {"rung": r + 1, "of": len(rungs)},
                    # SHA snapshots at rung granularity: a resume re-trains
                    # the interrupted rung
                    midpoint_snapshot=None,
                    notify_fields=(("rung", r + 1),),
                    span_attrs=lambda nw, r=r, n_r=n_r, steps=steps: {
                        "launch": boundary_offset + r + 1, "rung": r + 1, "members": n_r,
                        "steps": steps, "waves": nw},
                    flops=f,
                )
                scores = torch.cat(wave_scores)
                del wave_scores
                np_scores = scores_host.numpy().copy()
                record_rung(r, np_scores)
            else:
                with trace.span("train", launch=boundary_offset + r + 1, rung=r + 1,
                                members=sizes[r], steps=steps) as sp:
                    if objectives is not None:
                        sp["objectives"] = ",".join(objectives.names)
                    trainer.train_segment(state, hp, train_x, train_y, gen, steps)
                    if objectives is None:
                        scores = trainer.eval_population(state, val_x, val_y)
                    else:
                        mo = eval_population_objectives(trainer, state, val_x, val_y,
                                                        objectives.names)
                        scores = objectives.scalarize(mo)
                    if defer:
                        rung_scores_dev.append(scores)
                    else:
                        # the fetch is the rung's completion barrier
                        np_scores = scores.cpu().numpy()
                        np_mo = None if mo is None else mo.cpu().numpy()
                        if f:
                            sp["flops"] = f
                        memory.note(sp, dev)
                if not defer:
                    record_rung(r, np_scores)
            if journal is not None:
                # one record per pre-cut member at the rung's budget,
                # before the rung's snapshot
                journal_boundary(journal, r, alive, unit.cpu().numpy(), np_scores, step=budget,
                                 scores_mo=np_mo)
            if r < len(rungs) - 1:
                with boundary_span("rung_cut", rung=r + 1):
                    if waves:
                        unit, keep = _wave_cut(unit, scores, eta, sizes[r + 1])
                        perm = keep.cpu().numpy()
                        alive = alive[perm]
                        np_scores = np_scores[perm]
                    else:
                        ranked = scores if objectives is None else objectives.normalize(mo)
                        state, unit, keep, _ = _cut_and_gather(trainer, state, unit, ranked, eta,
                                                               sizes[r + 1], norm_bounds)
                        if defer:
                            rung_keep_dev.append(keep)
                        else:
                            np_keep = keep.cpu().numpy()
                            alive = alive[np_keep]
                            np_scores = np_scores[np_keep]
            if waves:
                # this rung's trained cohort is the next rung's stage-in
                # source, read through ``perm``
                pool_front = pool_back
            if snap is not None:
                save_state = state
                if waves:
                    # the current cohort (post-cut survivors; the whole
                    # final cohort at the last rung) out of the pool
                    sel = torch.as_tensor(perm if r < len(rungs) - 1 else np.arange(sizes[r]))
                    take = lambda d, sel=sel: {k: v.index_select(0, sel) for k, v in d.items()}
                    save_state = PopState(take(pool_back["params"]), take(pool_back["momentum"]),
                                          pool_back["step"].index_select(0, sel))
                meta_extra = {
                    "rungs_done": r + 1,
                    # the ledger cross-check's unit (fsck, the resume
                    # gate): the GLOBAL boundary count this snapshot
                    # has complete
                    "boundaries_done": boundary_offset + r + 1,
                    "alive": alive.tolist(),
                    "stop_rung": stop_rung.tolist(),
                    "last_score": [float(v) for v in last_score],
                    "rung_history": rung_history,
                }
                if waves:
                    meta_extra["wave_size_run"] = runner.wave_size
                snap.save_population_sweep(r + 1, save_state, unit, gen, np_scores,
                                           meta_extra=meta_extra)
            # checkpointed sweeps snapshot every rung, so a drain flushes
            # nothing more
            launch_boundary(f"sha rung {r + 1}/{len(rungs)}", final=r + 1 == len(rungs),
                            rung=r + 1, of=len(rungs))
    finally:
        if runner is not None:
            runner.close()
        if snap is not None:
            snap.close()

    if defer and rung_scores_dev:
        # the one fetch: every rung's scores and cuts, replayed into the
        # trial records as the eager path wrote them
        fetched = [t.cpu().numpy() for t in rung_scores_dev + rung_keep_dev]
        np_rung_scores, np_keeps = fetched[:len(rung_scores_dev)], fetched[len(rung_scores_dev):]
        for i, s_r in enumerate(np_rung_scores):
            record_rung(start_rung + i, s_r)
            if start_rung + i < len(rungs) - 1:
                alive = alive[np_keeps[i]]
        np_scores = np_rung_scores[-1]
        if mo is not None:
            np_mo = mo.cpu().numpy()  # the last rung's matrix
    np_unit = unit.cpu().numpy()
    best_row, diverged = finite_winner(np_scores)
    pareto = None
    if np_mo is not None:
        # the last rung's best FEASIBLE survivor (the least violating
        # one when none is), not the argmax of the primary
        best_row, pareto = pareto_summary(np_mo, objectives, members=alive)
        diverged = best_row is None
        best_row = 0 if diverged else best_row
    return {
        "best_score": float("nan") if diverged else float(np_scores[best_row]),
        "best_params": None if diverged else space.materialize_row(np_unit[best_row]),
        "best_trial": None if diverged else int(alive[best_row]),
        "diverged": diverged,
        "rung_budgets": rungs,
        "rung_sizes": sizes,
        "stop_rung": stop_rung,
        "last_score": last_score,
        "rung_history": rung_history,
        "member_failures": [
            int(np.sum(~np.isfinite(np.asarray(rh["scores"], dtype=np.float64))))
            for rh in rung_history
        ],
        "n_trials": n_trials,
        "journal": None if journal is None else {"written": journal.written, "verified": journal.verified},
        "objectives": None if objectives is None else list(objectives.names),
        "pareto": pareto,
        **({} if runner is None else runner.result_extras()),
    }


def _bracket_cohort(checkpoint_dir, b: int, n: int, tag: str, cohort_fn):  # sweeplint: barrier(bracket cohort cache: materializes suggested units to disk)
    """Bracket ``b``'s initial cohort ``(unit [n, dim], n_model)`` from
    ``cohort_fn``, persisted as ``cohort_{b}.npz`` beside the bracket
    snapshots when the sweep checkpoints, and REUSED on resume: resume
    correctness never depends on the model drawing the same bits again.
    The file carries the sweep's identity (``tag``: workload, plan,
    seed) and row count, checked here, since a crash before the
    bracket's first snapshot leaves no snapshot to refuse a reused
    directory: a cohort of another sweep raises ``ValueError``."""
    import os

    path = None
    if checkpoint_dir:
        path = os.path.join(checkpoint_dir, f"cohort_{b}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                cohort, n_model, saved_tag = np.array(z["cohort"]), int(z["n_model"]), str(z["tag"])
            if cohort.shape[0] != n or saved_tag != tag:
                raise ValueError(
                    f"persisted cohort for bracket {b} is from a different sweep "
                    f"({cohort.shape[0]} rows, tag {saved_tag!r}; expected {n} rows, tag "
                    f"{tag!r}): use a fresh checkpoint dir")
            return cohort, n_model
    cohort, n_model = cohort_fn(b, n)
    if path is not None:
        import torch.distributed as dist

        os.makedirs(checkpoint_dir, exist_ok=True)
        # write, then rename: a crash mid-write leaves no torn cohort.
        # The temporary name is the rank's: under multi-process SPMD
        # every rank writes the same bytes to the shared directory, and
        # two ranks sharing one temporary file would race
        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        tmp = f"{path}.tmp{rank}"
        with open(tmp, "wb") as f:
            np.savez(f, cohort=cohort, n_model=n_model, tag=np.asarray(tag))
        os.replace(tmp, path)
    return cohort, n_model


def fused_hyperband(
    workload,
    max_budget: int = 270,
    eta: int = 3,
    seed: int = 0,
    member_chunk: int = 0,
    checkpoint_dir: str | None = None,
    ledger=None,
    wave_size=0,
    oom_backoff: int = 2,
    device=None,
    cohort_fn=None,
    observe_fn=None,
    warm_obs=None,
    mesh=None,
    round_to: int = 1,
):
    """Hyperband with every bracket a fused SHA sweep (port of the JAX
    package's ``fused_hyperband``).

    Brackets (``algorithms.hyperband.bracket_plan``) run one after the
    other, bracket b as ``fused_sha`` with seed ``seed + 7919*b`` (the
    host Hyperband's seeds). ``wave_size``/``oom_backoff`` pass through,
    and each bracket resolves the cap against its own cohort: a bracket
    that fits runs resident. One ledger spans the brackets: each
    journals under its bracket's boundary, trial and member offsets, so
    the sweep reads as one contiguous boundary sequence.

    ``checkpoint_dir`` gives bracket b its own rung-snapshotted
    directory ``bracket_{b}``: a resume restarts inside the interrupted
    bracket, and completed brackets replay from their final snapshot. A
    ``launch_boundary`` between brackets lets a drain land there (each
    bracket's last rung suppresses its own).

    ``cohort_fn(b, n) -> (unit [n, dim], n_model)`` and ``observe_fn(b,
    cohort, res)`` are fused BOHB's model hooks: sample bracket b's
    initial cohort (``init_unit``; persisted by ``_bracket_cohort``
    under ``checkpoint_dir``), feed its results back. Plain Hyperband is
    the hookless case of the same loop. ``warm_obs`` reaches every
    bracket's ``fused_sha`` (row 0 of each uniform cohort starts at the
    prior best) only without ``cohort_fn``: a model-drawn cohort is
    BOHB's, which files the priors into its model instead. ``mesh`` and
    ``round_to`` reach every bracket's ``fused_sha``.

    Returns the JAX package's result: best_score and best_params (the
    best finite bracket's, ``best_finite``), the per-bracket summaries
    (``brackets``), member_failures flattened over brackets, n_trials,
    journal totals (None without a ledger), and, when any bracket ran in
    waves, the wave fields summed over brackets (``wave_size`` the
    largest settled cap).
    """
    import os

    from mpi_opt_tpu_torch.algorithms.base import best_finite
    from mpi_opt_tpu_torch.algorithms.hyperband import bracket_plan

    best = None
    brackets = []
    n_total = 0
    journal_totals = {"written": 0, "verified": 0}
    # wave fields over the brackets: counters sum, the cap is the
    # largest any bracket settled at
    wave_totals = {"wave_size": 0, "n_waves": 0, "waves_run": 0, "oom_backoffs": 0,
                   "staged_bytes": 0, "stage_transfer_s": 0.0, "stage_wait_s": 0.0,
                   "stage_overlap_s": 0.0}
    any_waves = False
    # the persisted cohorts' identity: what decides which search they
    # belong to
    tag = f"{getattr(workload, 'name', type(workload).__name__)}|R={max_budget}|eta={eta}|seed={seed}"
    plan = bracket_plan(max_budget, eta)
    boundary_off = trial_off = member_off = 0
    for b, (n, r) in enumerate(plan):
        cohort = n_model = None
        if cohort_fn is not None:
            cohort, n_model = _bracket_cohort(checkpoint_dir, b, n, tag, cohort_fn)
        res = fused_sha(
            workload,
            n_trials=n,
            min_budget=r,
            max_budget=max_budget,
            eta=eta,
            seed=seed + 7919 * b,
            member_chunk=member_chunk,
            checkpoint_dir=os.path.join(checkpoint_dir, f"bracket_{b}") if checkpoint_dir else None,
            ledger=ledger,
            wave_size=wave_size,
            oom_backoff=oom_backoff,
            device=device,
            boundary_offset=boundary_off,
            trial_offset=trial_off,
            member_offset=member_off,
            init_unit=cohort,
            warm_obs=warm_obs if cohort_fn is None else None,
            mesh=mesh,
            round_to=round_to,
        )
        boundary_off += len(res["rung_budgets"])
        trial_off += sum(res["rung_sizes"])
        member_off += n
        if observe_fn is not None:
            observe_fn(b, cohort, res)
        n_total += n
        if res["journal"]:
            journal_totals["written"] += res["journal"]["written"]
            journal_totals["verified"] += res["journal"]["verified"]
        summary = {
            "bracket": b,
            "n_trials": n,
            "start_budget": r,
            "rung_sizes": res["rung_sizes"],
            "rung_budgets": res["rung_budgets"],
            "member_failures": res["member_failures"],
            "best_score": res["best_score"],
        }
        if cohort_fn is not None:
            summary["n_model_sampled"] = n_model
        if res.get("wave_size"):
            any_waves = True
            wave_totals["wave_size"] = max(wave_totals["wave_size"], res["wave_size"])
            for k in ("n_waves", "waves_run", "oom_backoffs", "staged_bytes", "stage_transfer_s",
                      "stage_wait_s", "stage_overlap_s"):
                wave_totals[k] += res[k]
            summary.update(wave_size=res["wave_size"], n_waves=res["n_waves"],
                           oom_backoffs=res["oom_backoffs"])
        brackets.append(summary)
        launch_boundary(f"hyperband bracket {b + 1}/{len(plan)}", final=b + 1 == len(plan),
                        bracket=b + 1, of=len(plan))
        # a diverged bracket never sticks as the winner; the first
        # bracket stands when all diverged
        best = res if best is None else best_finite([best, res], key=lambda x: x["best_score"])
    return {
        "best_score": best["best_score"],
        "best_params": best["best_params"],
        "brackets": brackets,
        "member_failures": [m for s in brackets for m in s["member_failures"]],
        "n_trials": n_total,
        "journal": journal_totals if ledger is not None else None,
        **(wave_totals if any_waves else {}),
    }

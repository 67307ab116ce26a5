"""Fused generational TPE (port of ``mpi_opt_tpu/train/fused_tpe.py``):
suggest, train and report on the device.

The ring buffer of observations (``obs_unit [M, d]``, ``obs_scores [M]``,
``valid [M]``, M = n_trials + n_warm) is device state; its first
``n_warm`` rows hold a prior sweep's finite observations (``warm_obs``),
which the acquisition reads and the best pick, the curve and the
returned history leave out. Each generation draws a
batch of suggestions from it (``ops.tpe.tpe_suggest``, the diversified
batched top-k), initialises that many FRESH members, trains them for the
trial budget, evaluates them, and writes (units, scores) back into the
ring at its write position. Every trial trains from scratch (TPE
carries no population between generations), so a snapshot is the ring,
the generator state and the curves.

One ``torch.Generator`` threads every draw of a generation in order:
the suggestion's draws, the cohort's initial weights, the training
batches. Wave mode (a batch larger than the card holds) runs the same
draws: the suggestion as its own boundary op, the cohort's initial
weights drawn once into a host pool (``init_population_into``, the
draws of ``init_population``), then the waves, each restarting the
generator at the training's start and making the whole cohort's draws,
and the ring update once every wave's scores landed. An OOM re-run
replays the generation from the drawn suggestions and the pool, so
waves equal the resident sweep on the CPU.

Under a ``mesh`` every rank holds the ring and runs the same
acquisition from the same generator; each trains and scores its rows of
the generation's cohort (``Mesh.rows``' slice, made by
``init_population``), and the scores come back gathered, so every
rank writes the same ring.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpi_opt_tpu_torch.device import resolve_device
from mpi_opt_tpu_torch.ledger.fused import make_journal
from mpi_opt_tpu_torch.obs import memory, trace
from mpi_opt_tpu_torch.ops.tpe import TPEConfig, tpe_suggest
from mpi_opt_tpu_torch.train.common import (
    finite_winner,
    hparams_fn,
    journal_boundary,
    launch_boundary,
    momentum_dtype_str,
    segment_flops_hint,
    workload_arrays,
)
from mpi_opt_tpu_torch.train.engine import WaveRunner, boundary_span, resolve_wave_size
from mpi_opt_tpu_torch.train.engine import run_wave as _run_wave
from mpi_opt_tpu_torch.utils import profiling

def _tpe_ring_update(obs_unit, obs_scores, valid, sugg, scores, write_pos: int) -> None:
    """Write a completed batch's (units, scores) into the ring at
    ``write_pos``, in place."""
    n = sugg.shape[0]
    obs_unit[write_pos:write_pos + n] = sugg
    obs_scores[write_pos:write_pos + n] = scores
    valid[write_pos:write_pos + n] = True


def _tpe_suggest_program(generator, obs_unit, obs_scores, valid, n_suggest: int, cfg: TPEConfig):
    """A generation's suggestions ``[n_suggest, d]``: the first draws of
    the generation, as ``tpe_generation`` makes them (wave mode's
    ``suggest`` boundary op)."""
    sugg, _ = tpe_suggest(generator, obs_unit, obs_scores, valid, n_suggest, cfg)
    return sugg


def tpe_generation(trainer, obs_unit, obs_scores, valid, to_hparams, train_x, train_y, val_x,
                   val_y, generator, write_pos: int, n_suggest: int, budget: int, cfg: TPEConfig):
    """One fused generation: suggest (a ``suggest`` boundary span: the
    acquisition's dispatch, which the card runs behind it), init a fresh
    cohort, train ``budget`` steps, eval, write into the ring at
    ``write_pos`` (in place). Returns (scores [n_suggest], suggestions
    [n_suggest, d])."""
    with boundary_span("suggest", n=n_suggest):
        sugg = _tpe_suggest_program(generator, obs_unit, obs_scores, valid, n_suggest, cfg)
    state = trainer.init_population(generator, n_suggest)
    trainer.train_segment(state, to_hparams(sugg), train_x, train_y, generator, budget)
    scores = trainer.eval_population(state, val_x, val_y)
    _tpe_ring_update(obs_unit, obs_scores, valid, sugg, scores, write_pos)
    return scores, sugg


def _running_best(obs_scores, valid, live):
    """The best finite valid score of this sweep's rows (``live``: the
    warm prefix excluded) in the ring (a device scalar)."""
    return torch.where(valid & torch.isfinite(obs_scores) & live, obs_scores, -torch.inf).max()


def fused_tpe(  # sweeplint: barrier(batch host loop: fetches obs ring for snapshot/journal at batch boundaries)
    workload,
    n_trials: int,
    batch: int = 32,
    budget: int = 100,
    seed: int = 0,
    cfg: TPEConfig = TPEConfig(),
    member_chunk: int = 0,
    wave_size=0,
    oom_backoff: int = 2,
    checkpoint_dir: str | None = None,
    ledger=None,
    device=None,
    warm_obs=None,
    mesh=None,
):
    """Run an ``n_trials`` TPE sweep as ceil(n_trials/batch) fused
    generations, the last one sized to the remainder.

    ``wave_size`` (an int or ``'auto'``): a batch larger than the cap
    trains in waves through the wave engine (scores-only stage-out),
    equal to the resident sweep on the CPU; ``oom_backoff`` halvings of
    the cap on a device OOM replay the generation from its drawn
    suggestions. ``checkpoint_dir`` snapshots the ring, the generator
    and the curves after every generation; a call with the same
    arguments resumes at the next one and ends with the unkilled
    sweep's result, and a snapshot of another config (another ``cfg``,
    a wave cap against a resident sweep) raises ``ValueError``.
    ``ledger`` journals one record per suggestion per generation (its
    unit row and its score at the trial budget) before the snapshot.
    Without a snapshot or a journal, a resident sweep fetches its curve
    once, after the last generation.

    ``warm_obs`` (prior-ledger observations, cross-mode) pre-fills the
    ring: its ``n_warm`` finite-scored observations take rows ``[0,
    n_warm)``, valid, and the sweep's trials are written after them.
    Warm rows are facts, not trials: they are barred from the best pick
    and the curve and sliced off the returned history, and ``n_warm`` is
    part of the snapshot's identity (it shifts every write position), so
    a resume under another prior set raises ``ValueError``.

    Returns the JAX package's result: best_score, best_params, diverged,
    best_curve (the running best after each generation),
    member_failures (diverged suggestions a generation), obs_unit and
    obs_scores (this sweep's ``n_trials`` rows), n_trials, n_warm,
    journal, and in wave mode ``WaveRunner.result_extras()``. ``mesh``
    (a ``parallel.mesh.Mesh``): every rank calls with the same arguments
    and gets the same result."""
    if n_trials < 1:
        raise ValueError(f"n_trials must be >= 1, got {n_trials}")
    dev = resolve_device(device)
    trainer, space, train_x, train_y, val_x, val_y = workload_arrays(workload, member_chunk, dev,
                                                                     mesh)
    d = space.dim
    sizes = [batch] * (n_trials // batch)
    if n_trials % batch:
        sizes.append(n_trials % batch)
    # the residency question is about the largest generation cohort
    wave_size = resolve_wave_size(trainer, max(sizes), wave_size=wave_size, oom_backoff=oom_backoff,
                                  mesh=mesh)
    waves = 0 < wave_size < max(sizes)
    # finite-scored priors only: a diverged prior point carries no
    # evidence the model should build on (the driver's ingest rule)
    warm = [o for o in (warm_obs or []) if np.isfinite(float(o.score))]
    n_warm = len(warm)
    M = n_trials + n_warm  # the sweep's trials after the priors
    to_hparams = hparams_fn(space, workload)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    obs_unit = torch.zeros((M, d), dtype=torch.float32, device=dev)
    obs_scores = torch.zeros((M,), dtype=torch.float32, device=dev)
    valid = torch.zeros((M,), dtype=torch.bool, device=dev)
    if n_warm:
        obs_unit[:n_warm] = torch.from_numpy(
            np.stack([np.asarray(o.unit, np.float32) for o in warm])).to(dev)
        obs_scores[:n_warm] = torch.tensor([float(o.score) for o in warm],
                                           dtype=torch.float32, device=dev)
        valid[:n_warm] = True
    start_gen = 0
    run_wave_size = wave_size
    best_curve: list = []
    member_fail: list = []
    snap = None
    if checkpoint_dir is not None:
        from mpi_opt_tpu_torch.utils.checkpoint import SweepCheckpointer

        snap = SweepCheckpointer(checkpoint_dir, {
            "workload": getattr(workload, "name", type(workload).__name__),
            "n_trials": n_trials,
            "batch": batch,
            "budget": budget,
            "seed": seed,
            "member_chunk": member_chunk,
            # the acquisition's knobs shape every suggestion: a resume
            # continues under the same cfg
            "cfg": dataclasses.asdict(cfg),
            "momentum_dtype": momentum_dtype_str(),
            # the warm prefix shifts every write position: a resume
            # under another prior set refuses
            "n_warm": n_warm,
            # the requested (resolved) cap; the OOM-settled one is meta
            "wave_size": wave_size if waves else 0,
            "device": dev.type,
        }, mesh=mesh)
        restored = snap.restore()
        if restored is not None:
            sweep, meta = restored
            obs_unit = sweep["obs_unit"].to(dev)
            obs_scores = sweep["obs_scores"].to(dev)
            valid = sweep["valid"].to(dev)
            gen.set_state(sweep["rng_state"])
            start_gen = int(meta["gens_done"])
            best_curve = [float(v) for v in meta["best_curve"]]
            member_fail = [int(v) for v in meta["member_fail"]]
            if waves:
                run_wave_size = int(meta.get("wave_size_run", wave_size))
    done = n_warm + sum(sizes[:start_gen])  # the ring's write position
    journal = make_journal(ledger, space)
    if journal is not None:
        journal.require_prefix(start_gen)
    # the journal and the snapshot need each generation's results on the
    # host; a wave sweep's scores land there anyway
    defer = snap is None and journal is None and not waves
    runner = pool = None
    if waves:
        from mpi_opt_tpu_torch.train.staging import nan_scores, population_pool

        runner = WaveRunner(max(sizes), run_wave_size, member_chunk=member_chunk,
                            oom_backoff=oom_backoff, device=dev, requested=wave_size)
        # one pool for every generation's cohort: its params are redrawn
        # each generation, its momentum and step stay zero (nothing is
        # staged back into it)
        with trace.span("setup", op="pools", members=max(sizes)):
            pool = population_pool(trainer, max(sizes))
    # warm rows are facts, not trials of this sweep: barred from the
    # running-best curve and the winner pick
    live = torch.arange(M, device=dev) >= n_warm
    curve_dev: list = []
    fail_dev: list = []
    try:
        for g in range(start_gen, len(sizes)):
            n_g = sizes[g]
            if waves:
                with boundary_span("suggest", generation=g + 1, n=n_g):
                    sugg = _tpe_suggest_program(gen, obs_unit, obs_scores, valid, n_g, cfg)
                with trace.span("setup", op="pools", members=n_g):
                    trainer.init_population_into(gen, {k: v[:n_g] for k, v in pool["params"].items()})
                hp = to_hparams(sugg)
                rng_start = gen.get_state()
                scores_host = nan_scores(n_g, dev)

                def dispatch(w, off, wl, eng, hp=hp, rng_start=rng_start):
                    return _run_wave(trainer, pool, np.arange(off, off + wl), off, hp, train_x,
                                     train_y, val_x, val_y, gen, rng_start, budget, eng,
                                     launch_width=runner.chunk, mesh=mesh, keep_state=False)

                wave_scores = runner.run_interval(
                    n=n_g,
                    run_wave_fn=dispatch,
                    dst_fn=lambda off, wl, scores_host=scores_host: {
                        "scores": scores_host[off:off + wl]},
                    scores_host=scores_host,
                    stage_label=lambda w, nw, g=g: (
                        f"tpe generation {g + 1}/{len(sizes)} wave {w + 1}/{nw}"),
                    boundary_kwargs=lambda w, nw, g=g: {"generation": g + 1, "of": len(sizes)},
                    notify_fields=(("generation", g + 1),),
                    span_attrs=lambda nw, g=g, n_g=n_g: {
                        "launch": g + 1, "members": n_g, "steps": budget, "waves": nw},
                    flops=segment_flops_hint(workload, n_g, budget),
                )
                scores = torch.cat(wave_scores)
                del wave_scores
                with boundary_span("observe", generation=g + 1):
                    _tpe_ring_update(obs_unit, obs_scores, valid, sugg, scores, done)
                best_curve.append(float(_running_best(obs_scores, valid, live)))
                member_fail.append(int((~torch.isfinite(scores)).sum()))
            else:
                # a generation is a launch (in waves the runner ticks)
                profiling.launch_tick()
                # the curve fetch is the generation's completion barrier;
                # a deferred generation's span times its dispatch and
                # carries no FLOPs
                f = None if defer else segment_flops_hint(workload, n_g, budget)
                with trace.span("train", launch=g + 1, members=n_g, steps=budget) as sp:
                    scores, sugg = tpe_generation(
                        trainer, obs_unit, obs_scores, valid, to_hparams, train_x, train_y,
                        val_x, val_y, gen, done, n_g, budget, cfg)
                    running = _running_best(obs_scores, valid, live)
                    n_fail = (~torch.isfinite(scores)).sum()
                    if defer:
                        curve_dev.append(running)
                        fail_dev.append(n_fail)
                    else:
                        best_curve.append(float(running))
                        member_fail.append(int(n_fail))
                        if f:
                            sp["flops"] = f
                        memory.note(sp, dev)
            first = done - n_warm  # the members are the sweep's trial indices
            done += n_g
            if journal is not None:
                # one record per suggestion (members are the sweep's
                # trial indices), before the generation's snapshot
                journal_boundary(journal, g, np.arange(first, first + n_g), sugg.cpu().numpy(),
                                 scores.cpu().numpy(), step=budget)
            if snap is not None:
                snap.save(g + 1, sweep={
                    "obs_unit": obs_unit.cpu(), "obs_scores": obs_scores.cpu(),
                    "valid": valid.cpu(), "rng_state": gen.get_state(),
                }, meta_extra={
                    "gens_done": g + 1,
                    "boundaries_done": g + 1,
                    "best_curve": best_curve,
                    "member_fail": member_fail,
                    # the OOM-settled cap: a resume adopts it
                    **({"wave_size_run": runner.wave_size} if waves else {}),
                })
            # checkpointed sweeps snapshot every generation, so a drain
            # here resumes at exactly the next one
            launch_boundary(f"tpe generation {g + 1}/{len(sizes)}", final=g + 1 == len(sizes),
                            generation=g + 1, of=len(sizes))
    finally:
        if runner is not None:
            runner.close()
        if snap is not None:
            snap.close()

    if curve_dev:
        # the one fetch of a deferred sweep
        fetched = torch.stack(curve_dev + [v.float() for v in fail_dev]).cpu().tolist()
        best_curve.extend(fetched[:len(curve_dev)])
        member_fail.extend(int(v) for v in fetched[len(curve_dev):])
    # the warm rows are sliced off: callers get exactly this sweep's
    # n_trials observations, warm-started or not
    np_unit = obs_unit.cpu().numpy()[n_warm:]
    np_scores = obs_scores.cpu().numpy()[n_warm:]
    best_i, diverged = finite_winner(np_scores, ok=valid.cpu().numpy()[n_warm:])
    return {
        "best_score": float("nan") if diverged else float(np_scores[best_i]),
        "best_params": None if diverged else space.materialize_row(np_unit[best_i]),
        "diverged": diverged,
        "best_curve": np.asarray(best_curve, dtype=np.float32),
        "member_failures": member_fail,
        "obs_unit": np_unit,
        "obs_scores": np_scores,
        "n_trials": n_trials,
        "n_warm": n_warm,
        "journal": None if journal is None else {"written": journal.written,
                                                 "verified": journal.verified},
        **({} if runner is None else runner.result_extras()),
    }

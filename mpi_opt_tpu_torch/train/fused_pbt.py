"""Fused PBT over a resident population (port of ``mpi_opt_tpu/train/fused_pbt.py``).

Each generation trains the population, evaluates it, runs
exploit/explore, and gathers the winners' states, all on the device;
the host reads back only the small per-generation curves, once per
launch. One ``torch.Generator`` carries every draw through the sweep,
so splitting it into launches (``gen_chunk``) or a generation's
training into sub-launches (``step_chunk``) gives exactly the result of
one launch.

Durability follows the JAX package's resident loop: launch-granular
verified snapshots (``checkpoint_dir``, ``utils/checkpoint.py``) that a
call with the same arguments resumes from, a member-granular ledger
journal (``ledger``) written before each snapshot and verified on
resume, a graceful drain at every launch boundary, and typed device
OOM.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from mpi_opt_tpu_torch.device import resolve_device
from mpi_opt_tpu_torch.ledger.fused import make_journal
from mpi_opt_tpu_torch.ops.pbt import PBTConfig, pbt_exploit_explore
from mpi_opt_tpu_torch.train.common import (
    finite_winner,
    hparams_fn,
    launch_boundary,
    momentum_dtype_str,
)
from mpi_opt_tpu_torch.train.population import PopState
from mpi_opt_tpu_torch.utils import resources

# arguments of the JAX package's fused_pbt that the port does not take
# yet, with their defaults: a non-default value raises
_NOT_PORTED = {
    "mesh": None,
    "wave_size": 0,
    "warm_obs": None,
    "objectives": None,
}


def balanced_split(total: int, chunk: int) -> list[int]:
    """Split ``total`` into ceil(total/chunk) near-equal parts (G=7,
    chunk=3 -> [3, 2, 2]); total=0 gives [0], one empty part."""
    if total <= 0:
        return [0]
    n = -(-total // chunk)
    base, extra = divmod(total, n)
    return [base + 1] * extra + [base] * (n - extra)


def finish_generation(trainer, state, unit, generator, val_x, val_y, disc, cfg: PBTConfig):
    """The generation boundary: eval the population, exploit/explore,
    gather the winners' states. Returns (state, new_unit, best, mean,
    n_fail, post-exploit scores, pre-exploit scores, the unit matrix
    the generation trained with); the last two are what the ledger
    journals. The post-exploit scores are the gathered pre-exploit
    ones: weights are copied verbatim."""
    scores = trainer.eval_population(state, val_x, val_y)
    new_unit, src_idx, _ = pbt_exploit_explore(generator, unit, scores, disc, cfg)
    state = trainer.gather_members(state, src_idx)
    n_fail = (~torch.isfinite(scores)).sum()
    return state, new_unit, scores.max(), scores.mean(), n_fail, scores[src_idx], scores, unit


def _run_stepped_generation(trainer, state, unit, to_hparams, train_x, train_y, val_x, val_y,
                            generator, disc, steps: int, step_chunk: int, cfg: PBTConfig):
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
    return finish_generation(trainer, state, unit, generator, val_x, val_y, disc, cfg)


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
    device=None,
    **not_ported,
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

    ``oom_backoff`` is accepted for the JAX signature: it only acts in
    wave mode, which is not ported, so a resident sweep's device OOM
    raises ``DeviceOOM`` either way.

    Returns the result dict of the JAX package's ``fused_pbt``:
    best_score, best_params, diverged, best_curve, mean_curve,
    member_failures, state, unit, launch_gens, launch_walls (the
    completed launches' walls, from the snapshot on a resume), journal
    ({"written", "verified"} member records, None without a ledger).
    """
    for name, value in not_ported.items():
        if name not in _NOT_PORTED:
            raise TypeError(f"fused_pbt() got an unexpected keyword argument {name!r}")
        if value != _NOT_PORTED[name]:
            raise NotImplementedError(f"fused_pbt({name}=...) is not ported yet")
    if generations < 1:
        raise ValueError(f"generations must be >= 1, got {generations}")
    if step_chunk > 0 and gen_chunk > 1:
        raise ValueError(
            "step_chunk splits within generations; combining it with "
            f"gen_chunk={gen_chunk} (grouping whole generations) is ambiguous"
        )
    dev = resolve_device(device)

    trainer = workload.make_trainer(member_chunk=member_chunk, device=dev)
    space = workload.default_space()
    d = workload.data()
    train_x, train_y, val_x, val_y = (
        torch.from_numpy(d[k]).to(dev) for k in ("train_x", "train_y", "val_x", "val_y")
    )
    train_y, val_y = train_y.long(), val_y.long()
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
        snap = SweepCheckpointer(checkpoint_dir, ck_config)
        restored = snap.restore_population_sweep()
    if restored is not None:
        host_state, unit, rng_state, scores_np, meta = restored
        state = PopState(
            params={k: v.to(dev) for k, v in host_state.params.items()},
            momentum={k: v.to(dev) for k, v in host_state.momentum.items()},
            step=host_state.step.to(dev),
        )
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
        unit = space.sample_unit(gen, population)
        state = trainer.init_population(gen, population)

    snapshot_every = max(1, snapshot_every)
    for i in range(start_launch, n_launches):
        t0 = time.perf_counter()
        best, mean, fails, pre_s, pre_u = [], [], [], [], []
        # a resident sweep has no wave to halve: a CUDA OOM leaves as
        # DeviceOOM, which the CLI exits 74 on
        with resources.oom_funnel():
            resources.launch_fault("launch")
            for _ in range(launch_lens[i]):
                state, unit, b, m, f, scores, s_pre, u_pre = _run_stepped_generation(
                    trainer, state, unit, to_hparams, train_x, train_y, val_x, val_y, gen, disc,
                    steps_per_gen, step_chunk, cfg)
                best.append(b)
                mean.append(m)
                fails.append(f)
                pre_s.append(s_pre)
                pre_u.append(u_pre)
            # the fetch is the launch's completion barrier
            best_parts.append(torch.stack(best).cpu().numpy())
            mean_parts.append(torch.stack(mean).cpu().numpy())
            fail_parts.append(torch.stack(fails).cpu().numpy())
            scores_np = scores.cpu().numpy()
        launch_walls.append(time.perf_counter() - t0)
        g0 = sum(launch_lens[:i])
        if journal is not None:
            # journal this launch's generations (their pre-exploit scores
            # and units) BEFORE its snapshot, so the journal never lags it;
            # a generation re-computed on resume verifies instead
            for j, (s_j, u_j) in enumerate(zip(pre_s, pre_u)):
                g = g0 + j
                journal.record_boundary(g, np.arange(population), u_j.cpu().numpy(),
                                        s_j.cpu().numpy(), step=(g + 1) * steps_per_gen)
        is_last = i + 1 == n_launches
        due = (i + 1) % snapshot_every == 0

        def save_now(i=i):
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

    best_i, diverged = finite_winner(scores_np)
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
    }

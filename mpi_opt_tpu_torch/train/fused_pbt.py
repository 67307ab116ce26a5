"""Fused PBT over a resident population (port of ``mpi_opt_tpu/train/fused_pbt.py``).

Each generation trains the population, evaluates it, runs
exploit/explore, and gathers the winners' states, all on the device;
the host reads back only the small per-generation curves, once per
launch. One ``torch.Generator`` carries every draw through the sweep,
so splitting it into launches (``gen_chunk``) gives exactly the result
of one launch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mpi_opt_tpu_torch.device import resolve_device
from mpi_opt_tpu_torch.ops.pbt import PBTConfig, pbt_exploit_explore
from mpi_opt_tpu_torch.train.common import finite_winner, hparams_fn

# arguments of the JAX package's fused_pbt that the port does not take
# yet, with their defaults: a non-default value raises
_NOT_PORTED = {
    "mesh": None,
    "step_chunk": 0,
    "wave_size": 0,
    "checkpoint_dir": None,
    "ledger": None,
    "warm_obs": None,
    "objectives": None,
    "oom_backoff": 2,
}


def balanced_split(total: int, chunk: int) -> list[int]:
    """Split ``total`` into ceil(total/chunk) near-equal parts (G=7,
    chunk=3 -> [3, 2, 2])."""
    n = -(-total // chunk)
    base, extra = divmod(total, n)
    return [base + 1] * extra + [base] * (n - extra)


def fused_pbt(
    workload,
    population: int,
    generations: int,
    steps_per_gen: int,
    seed: int = 0,
    cfg: PBTConfig = PBTConfig(),
    member_chunk: int = 0,
    gen_chunk: int = 0,
    device=None,
    **not_ported,
):
    """Run a whole PBT sweep of a population workload.

    ``gen_chunk`` splits the sweep into ceil(G/gen_chunk) launches
    (0 = one launch); the host syncs once per launch, to fetch that
    launch's curves and time it. Returns the result dict of the JAX
    package's ``fused_pbt`` (best_score, best_params, diverged,
    best_curve, mean_curve, member_failures, state, unit, launch_gens,
    launch_walls).
    """
    for name, value in not_ported.items():
        if name not in _NOT_PORTED:
            raise TypeError(f"fused_pbt() got an unexpected keyword argument {name!r}")
        if value != _NOT_PORTED[name]:
            raise NotImplementedError(f"fused_pbt({name}=...) is not ported yet")
    if generations < 1:
        raise ValueError(f"generations must be >= 1, got {generations}")
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

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    unit = space.sample_unit(gen, population)
    state = trainer.init_population(gen, population)

    launch_lens = balanced_split(generations, generations if gen_chunk <= 0 else min(gen_chunk, generations))
    best_parts, mean_parts, fail_parts, launch_walls = [], [], [], []
    scores = None
    for n_gens in launch_lens:
        t0 = time.perf_counter()
        best, mean, fails = [], [], []
        for _ in range(n_gens):
            trainer.train_segment(state, to_hparams(unit), train_x, train_y, gen, steps_per_gen)
            pre = trainer.eval_population(state, val_x, val_y)
            unit, src_idx, _ = pbt_exploit_explore(gen, unit, pre, disc, cfg)
            state = trainer.gather_members(state, src_idx)
            best.append(pre.max())
            mean.append(pre.mean())
            fails.append((~torch.isfinite(pre)).sum())
            # the post-exploit population's scores are the gathered
            # pre-exploit scores: weights are copied verbatim
            scores = pre[src_idx]
        # the fetch is the launch's completion barrier
        best_parts.append(torch.stack(best).cpu().numpy())
        mean_parts.append(torch.stack(mean).cpu().numpy())
        fail_parts.append(torch.stack(fails).cpu().numpy())
        scores_np = scores.cpu().numpy()
        launch_walls.append(time.perf_counter() - t0)

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
    }

"""PBT exploit/explore over a population axis (port of ``mpi_opt_tpu/ops/pbt.py``).

The decision is a source-index map ``src_idx[n]``: member i continues
from member ``src_idx[i]``'s state (itself for survivors), realised by
the trainer as one gather. Explore perturbs in unit-cube space:
continuous dims get clipped Gaussian noise, discrete dims resample with
probability ``resample_prob``.

Randomness is split into a draw (``draw_exploit_explore``, from a
``torch.Generator``) and an apply (``apply_exploit_explore``), so the
tests can hand the JAX package's own draws to the apply and require the
same decision.
"""

from __future__ import annotations

import dataclasses

import torch

from mpi_opt_tpu_torch.objectives.pareto import pareto_score
from mpi_opt_tpu_torch.ops.common import rank_descending


@dataclasses.dataclass(frozen=True)
class PBTConfig:
    truncation_frac: float = 0.25  # bottom frac exploits, top frac is source pool
    perturb_scale: float = 0.15  # stddev of unit-space Gaussian perturbation
    resample_prob: float = 0.1  # per-discrete-dim chance to resample on explore


def n_cut(n: int, cfg: PBTConfig) -> int:
    # Python's round (half to even) on a Python float, as in the JAX package
    return max(1, int(round(n * cfg.truncation_frac)))


def draw_exploit_explore(generator: torch.Generator, n: int, d: int, cfg: PBTConfig):
    """(src_pick int64[n] in [0, n_cut), noise f32[n, d] standard normal,
    resample_u f32[n, d], fresh f32[n, d]) on the generator's device."""
    dev = generator.device
    src_pick = torch.randint(0, n_cut(n, cfg), (n,), generator=generator, device=dev)
    noise = torch.randn((n, d), generator=generator, device=dev)
    resample_u = torch.rand((n, d), generator=generator, device=dev)
    fresh = torch.rand((n, d), generator=generator, device=dev)
    return src_pick, noise, resample_u, fresh


def apply_exploit_explore(unit, scores, discrete_mask, cfg: PBTConfig, draws):
    """One PBT generation decision from given draws.

    Returns (new_unit f32[n, d], src_idx int64[n], bottom bool[n]).
    """
    src_pick, noise, resample_u, fresh = draws
    n = unit.shape[0]
    rank, order = rank_descending(scores)
    bottom = rank >= (n - n_cut(n, cfg))  # losers: exploit
    src_idx = torch.where(bottom, order[src_pick], torch.arange(n, device=unit.device))
    copied = unit[src_idx]
    perturbed = torch.clamp(copied + noise * cfg.perturb_scale, 0.0, 1.0)
    disc = torch.where(resample_u < cfg.resample_prob, fresh, copied)
    disc_mask = torch.as_tensor(discrete_mask, dtype=torch.bool, device=unit.device)
    explored = torch.where(disc_mask[None, :], disc, perturbed)
    new_unit = torch.where(bottom[:, None], explored, unit)
    return new_unit, src_idx, bottom


def pbt_exploit_explore(generator, unit, scores, discrete_mask, cfg: PBTConfig = PBTConfig()):
    """Draw, then apply: (new_unit, src_idx, bottom)."""
    n, d = unit.shape
    draws = draw_exploit_explore(generator, n, d, cfg)
    return apply_exploit_explore(unit, scores, discrete_mask, cfg, draws)


def pbt_exploit_explore_mo(generator, unit, norm_scores, discrete_mask,
                           cfg: PBTConfig = PBTConfig(), norm_bounds=None):
    """Multi-objective PBT decision: truncation exploit by Pareto rank.

    ``norm_scores`` is the maximize-form ``[n, m]`` objective matrix,
    ``norm_bounds`` its maximize-form bounds (or None). The population is
    ranked by ``objectives.pareto.pareto_score`` (front, then crowding,
    infeasible members below by violation), then the scalar decision
    runs on that effective score with the same draws in the same order.
    Returns (new_unit, src_idx, bottom, eff f32[n]).
    """
    eff = pareto_score(norm_scores, norm_bounds=norm_bounds)
    new_unit, src_idx, bottom = pbt_exploit_explore(generator, unit, eff, discrete_mask, cfg)
    return new_unit, src_idx, bottom, eff

"""Tree-structured Parzen Estimator with a vectorized acquisition (port
of ``mpi_opt_tpu/ops/tpe.py``).

The observations live in a fixed-shape ring buffer (``obs_unit [M, d]``,
``obs_scores [M]``, ``valid [M]``) on the device. A suggestion splits
the valid observations into good (the top ``gamma`` quantile) and bad,
fits a Gaussian mixture plus a uniform prior to each (Silverman
bandwidths per dimension, floored), draws ``n_candidates`` candidates
from the good mixture (the first ``uniform_frac`` of them uniform in
the cube), scores all of them by log l(x) - log g(x) in one ``[C, M,
d]`` broadcast and a ``logsumexp``, and keeps the best ``n_suggest``
(greedy with repulsion when ``diversify_bw > 0``).

Random draws are split from the math, as everywhere in the port:
``draw_tpe`` makes every draw from an explicit ``torch.Generator``
(uniforms for the component picks, the normal jitter, the uniform
candidates), ``pick_components`` turns the pick uniforms into
components under the good mixture's weights (the inverse CDF
``jax.random.choice`` uses), and ``tpe_apply`` takes the picks, the
jitter and the uniform candidates. Tests feed JAX's own draws to
``tpe_apply``.

The acquisition is the reference's XLA work (not Pallas), so it runs as
stock torch ops.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from mpi_opt_tpu_torch.ops.common import rank_descending


@dataclasses.dataclass(frozen=True)
class TPEConfig:
    gamma: float = 0.25  # top quantile regarded as "good"
    n_candidates: int = 1024  # candidates scored per suggest call
    # minimum KDE bandwidth in unit space: a collapsed good mixture
    # could never propose outside the incumbent cluster
    bw_floor: float = 0.15
    bw_scale: float = 1.06  # Silverman factor
    prior_weight: float = 1.0  # weight of the uniform prior component
    # the first uniform_frac of the candidates are uniform in the cube,
    # so unexplored regions are scored at all
    uniform_frac: float = 0.1
    # batched suggestions: after each pick, candidates within ~diversify_bw
    # lose a Gaussian bump of height diversify_weight (log units), so
    # later picks come from other modes; n_suggest=1 is unaffected
    diversify_bw: float = 0.1
    diversify_weight: float = 5.0


class TPEDraws(NamedTuple):
    """One suggestion's draws: ``u_pick [C]`` uniforms for the component
    picks, ``jitter [C, d]`` standard normals, ``uni [C, d]`` uniform
    candidates."""

    u_pick: torch.Tensor
    jitter: torch.Tensor
    uni: torch.Tensor


class TPEModel(NamedTuple):
    """The good/bad split of a buffer: weights ``[M]``, bandwidths
    ``[d]``, and the component probabilities ``[M+1]`` (the good
    observations, then the prior)."""

    good_w: torch.Tensor
    bad_w: torch.Tensor
    bw_g: torch.Tensor
    bw_b: torch.Tensor
    probs: torch.Tensor


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as an f32 scalar on ``like``'s device: the constant
    math (logs of constants) then rounds as jnp's f32 does."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _masked_moments(x: torch.Tensor, w: torch.Tensor):
    """Weighted mean/std along axis 0. w: [M] nonneg, x: [M, d]."""
    wsum = torch.clamp(w.sum(), min=1e-9)
    mean = (w[:, None] * x).sum(0) / wsum
    var = (w[:, None] * (x - mean) ** 2).sum(0) / wsum
    return mean, torch.sqrt(var)


def _log_mixture(x, centers, w, bw, prior_weight: float):
    """log density of x under the masked Gaussian mixture plus a uniform
    prior component of weight ``prior_weight`` (log-density 0 on the
    cube). x: [C, d]; centers: [M, d]; w: [M] (0 for invalid); bw: [d].
    Returns [C]."""
    z = (x[:, None, :] - centers[None, :, :]) / bw[None, None, :]
    log_comp = (-0.5 * z**2 - torch.log(bw)[None, None, :]
                - 0.5 * torch.log(_f32(2 * math.pi, x))).sum(-1)
    logw = torch.where(w > 0, torch.log(torch.clamp(w, min=1e-30)), -torch.inf)
    total = w.sum() + prior_weight
    prior = torch.log(_f32(prior_weight + 1e-30, x)).expand(x.shape[0], 1)
    stacked = torch.cat([log_comp + logw[None, :], prior], dim=1)
    return torch.logsumexp(stacked, dim=1) - torch.log(total)


def draw_tpe(generator: torch.Generator, M: int, d: int, cfg: TPEConfig) -> TPEDraws:
    """Every draw of one suggestion over an ``M``-row, ``d``-dim buffer
    (``M`` does not shape them: the picks are uniforms until
    ``pick_components`` reads the mixture's weights), on the generator's
    device."""
    dev = generator.device
    c = cfg.n_candidates
    u_pick = torch.rand((c,), generator=generator, device=dev)
    jitter = torch.randn((c, d), generator=generator, device=dev)
    uni = torch.rand((c, d), generator=generator, device=dev)
    return TPEDraws(u_pick, jitter, uni)


def pick_components(u: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Component indices ``[C]`` in [0, M] for uniforms ``u`` under
    ``probs [M+1]``: the inverse CDF of ``jax.random.choice`` with ``p``
    (the first index whose cumulative weight reaches
    ``total * (1 - u)``)."""
    cum = torch.cumsum(probs, 0)
    r = cum[-1] * (1 - u)
    return torch.searchsorted(cum, r).clamp_(max=probs.shape[0] - 1)


def tpe_fit(obs_unit, obs_scores, valid, cfg: TPEConfig) -> TPEModel:
    """The good/bad split of the buffer and its bandwidths."""
    d = obs_unit.shape[1]
    n_valid = valid.sum()
    n_good = torch.clamp(torch.ceil(cfg.gamma * n_valid.float()), min=1).to(torch.int64)
    rank, _ = rank_descending(obs_scores, valid)
    good_w = ((rank < n_good) & valid).float()
    bad_w = ((rank >= n_good) & valid).float()

    def bw_of(w):
        m = torch.clamp(w.sum(), min=1.0)
        _, std = _masked_moments(obs_unit, w)
        return torch.clamp(cfg.bw_scale * std * m ** (-1.0 / (d + 4)), cfg.bw_floor, 1.0)

    total_g = good_w.sum() + cfg.prior_weight
    probs = torch.cat([good_w, _f32(cfg.prior_weight, good_w)[None]]) / total_g
    return TPEModel(good_w, bad_w, bw_of(good_w), bw_of(bad_w), probs)


def tpe_apply(obs_unit, model: TPEModel, comp, jitter, uni, n_suggest: int, cfg: TPEConfig):
    """The acquisition for given draws: candidates from the good mixture
    at components ``comp [C]`` (M: the prior, centred at 0.5 with width
    0.5) with ``jitter [C, d]``, the first ``round(C * uniform_frac)``
    replaced by ``uni``, clipped to the cube, scored, and the best
    ``n_suggest`` kept. Returns (suggestions [n_suggest, d], acq
    [n_suggest])."""
    M, d = obs_unit.shape
    c = cfg.n_candidates
    comp = comp.long()
    centers = torch.cat([obs_unit, obs_unit.new_full((1, d), 0.5)])[comp]
    widths = torch.where((comp < M)[:, None], model.bw_g[None, :], 0.5)
    cand = centers + jitter * widths
    n_uni = int(round(c * cfg.uniform_frac))
    is_uni = (torch.arange(c, device=cand.device) < n_uni)[:, None]
    cand = torch.clamp(torch.where(is_uni, uni, cand), 0.0, 1.0)
    acq = (_log_mixture(cand, obs_unit, model.good_w, model.bw_g, cfg.prior_weight)
           - _log_mixture(cand, obs_unit, model.bad_w, model.bw_b, cfg.prior_weight))
    if n_suggest > 1 and cfg.diversify_bw > 0:
        idx = _diverse_top_k(cand, acq, n_suggest, cfg.diversify_bw, cfg.diversify_weight)
        return cand[idx], acq[idx]
    # jax.lax.top_k puts the lower index first on ties: a stable sort
    top_acq, idx = torch.sort(acq, descending=True, stable=True)
    return cand[idx[:n_suggest]], top_acq[:n_suggest]


def tpe_suggest(generator: torch.Generator, obs_unit, obs_scores, valid, n_suggest: int,
                cfg: TPEConfig = TPEConfig()):
    """Suggest ``n_suggest`` unit-cube points maximising l(x)/g(x): the
    draws from ``generator``, then the fit, the picks and the apply. An
    empty buffer degrades to uniform sampling through the prior.

    Returns (suggestions float32[n_suggest, d], acq float32[n_suggest])."""
    M, d = obs_unit.shape
    draws = draw_tpe(generator, M, d, cfg)
    model = tpe_fit(obs_unit, obs_scores, valid, cfg)
    comp = pick_components(draws.u_pick, model.probs)
    return tpe_apply(obs_unit, model, comp, draws.jitter, draws.uni, n_suggest, cfg)


def _diverse_top_k(cand, acq, k: int, bw: float, weight: float):
    """Greedy diversified selection: argmax (the first maximum, as
    ``jnp.argmax``), subtract a Gaussian repulsion of height ``weight``
    and width ``bw`` around the pick, bar the pick, repeat ``k`` times.
    Returns int64[k] candidate indices (the first is the plain argmax).
    Nothing leaves the device: the picks index on the card."""
    acq_cur = acq.clone()
    idx = []
    for _ in range(k):
        i = torch.argmax(acq_cur)
        d2 = ((cand - cand[i]) ** 2).sum(-1)
        acq_cur = acq_cur - weight * torch.exp(-0.5 * d2 / (bw * bw))
        acq_cur[i] = -torch.inf
        idx.append(i)
    return torch.stack(idx)

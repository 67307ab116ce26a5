"""The random draws of a fused PBT sweep, made again from its seed.

The program states its random stream (``fused_pbt``, ``population.py``,
``ops/pbt.py``, ``space.py`` of the port): one ``torch.Generator`` on the
sweep's device, seeded with the sweep's seed, draws in this order:

1. the unit matrix, ``rand(P, d)``;
2. each layer's weight in module order, a truncated normal on
   [-2 std, 2 std] at the population's shape, std = sqrt(1/fan_in) /
   0.8796... (flax's ``lecun_normal``); biases, GroupNorm scales and
   shifts are constants and draw nothing;
3. for each training step: the shared minibatch ``randint(0, N, (B,))``,
   then the augmentation, ``rand(P, B)`` against each member's flip
   probability and ``rand(2, P)`` for its two shifts;
4. at each generation's end, the exploit: ``randint(0, n_cut, (P,))``,
   ``randn(P, d)``, ``rand(P, d)``, ``rand(P, d)``.

This module makes the same calls on a generator of its own. It imports
nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from benchmark.reference.models import layer_shapes

# flax's lecun_normal: the truncated normal's std correction
_TRUNC_STD = 0.87962566103423978


def from_unit(space: dict, unit: torch.Tensor) -> dict:
    """Hyperparameter values of unit-cube rows, as the search space maps
    them (log-uniform bounds enter as float32 scalars)."""
    out = {}
    for j, (name, (kind, lo, hi)) in enumerate(space.items()):
        u = unit[:, j]
        if kind == "uniform":
            out[name] = lo + (hi - lo) * u
        elif kind == "log_uniform":
            a, b = np.log(lo), np.log(hi)
            out[name] = torch.exp(float(np.float32(a)) + float(np.float32(b - a)) * u)
        else:
            raise ValueError(f"unknown domain {kind!r}")
    return out


def n_cut(n: int, pbt: dict) -> int:
    return max(1, int(round(n * pbt["truncation_frac"])))


class Replay:
    """The sweep's draws, generation by generation.

    ``unit0`` and ``init`` (the population's initial parameters, name ->
    ``[P, ...]``) are made on construction; ``step_draws()`` gives the
    next step's (batch indices, flip mask ``[P, B]``, shifts ``(dy, dx)``)
    under the hyperparameters of ``unit0``, or of the generation's own
    rows where given; ``exploit_draws()`` the generation end's four
    draws."""

    def __init__(self, cfg: dict, population: int, seed: int, device):
        self.cfg, self.p = cfg, population
        self.g = torch.Generator(device=device)
        self.g.manual_seed(seed)
        self.device = torch.device(device)
        d = len(cfg["space"])
        self.unit0 = torch.rand((population, d), generator=self.g, dtype=torch.float32,
                                device=self.device)
        self.init = {}
        for name, shape, kind in layer_shapes(cfg):
            t = torch.empty((population,) + tuple(shape), device=self.device)
            if kind in ("conv", "dense"):
                fan_in = math.prod(shape[1:])
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(t, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std,
                                      generator=self.g)
            elif kind == "ones":
                t.fill_(1.0)
            else:
                t.zero_()
            self.init[name] = t
        self.hp = from_unit(cfg["space"], self.unit0)
        self._after_init = self.g.get_state()

    def restart(self) -> None:
        """Back to the point after the initial population: the first
        step's draws come next, as in a sweep started anew."""
        self.g.set_state(self._after_init)

    def step_draws(self, hp: dict | None = None):
        hp = self.hp if hp is None else hp
        b = self.cfg["batch_size"]
        idx = torch.randint(0, self.cfg["n_train"], (b,), generator=self.g, device=self.device)
        if not self.cfg["augment"]:
            return idx, None
        do_flip = torch.rand((self.p, b), generator=self.g, device=self.device) < hp["flip_prob"][:, None]
        max_s = torch.clamp(hp["shift"], min=0.0)
        u = torch.rand((2, self.p), generator=self.g, device=self.device)
        dy, dx = torch.round(-max_s + 2.0 * max_s * u).long()
        return idx, (do_flip, dy, dx)

    def exploit_draws(self, generator=None):
        g = self.g if generator is None else generator
        n, d = self.unit0.shape
        src_pick = torch.randint(0, n_cut(n, self.cfg["pbt"]), (n,), generator=g, device=self.device)
        noise = torch.randn((n, d), generator=g, device=self.device)
        resample_u = torch.rand((n, d), generator=g, device=self.device)
        fresh = torch.rand((n, d), generator=g, device=self.device)
        return src_pick, noise, resample_u, fresh

    def fork(self) -> torch.Generator:
        """A generator at this replay's point (to draw a generation end
        that the sweep took here, without moving this one)."""
        g = torch.Generator(device=self.device)
        g.set_state(self.g.get_state())
        return g

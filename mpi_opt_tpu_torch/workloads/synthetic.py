"""Synthetic analytic workload for tests and algorithm benchmarks (a
copy of ``mpi_opt_tpu/workloads/synthetic.py``, numpy only).

Gradient descent on the quadratic loss 0.5*||w||^2 has the closed form
w_t = w_0 * (1 - lr)^t — convergent for lr in (0, 2), optimal at lr=1.
Training ``steps`` is therefore O(1) regardless of budget, which makes
this workload ideal for exercising ASHA budget ladders, PBT inheritance
and TPE convergence without any real compute. Score = -loss (higher is
better), with a mild penalty making ``reg`` matter too.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mpi_opt_tpu_torch.space import LogUniform, SearchSpace, Uniform
from mpi_opt_tpu_torch.workloads import register
from mpi_opt_tpu_torch.workloads.base import Workload


@dataclasses.dataclass
class QuadState:
    w: np.ndarray
    steps: int = 0


@register
class Quadratic(Workload):
    name = "quadratic"

    def __init__(self, dim: int = 8):
        self.dim = dim

    def default_space(self) -> SearchSpace:
        return SearchSpace(
            {
                "lr": LogUniform(1e-3, 4.0),  # upper range diverges: real failure mode
                "reg": Uniform(0.0, 1.0),
            }
        )

    def init_state(self, params: dict, seed: int) -> QuadState:
        rng = np.random.default_rng(seed)
        return QuadState(w=rng.normal(size=self.dim).astype(np.float64))

    def train(self, state: QuadState, params: dict, steps: int, seed: int):
        lr = float(params["lr"])
        reg = float(params["reg"])
        factor = (1.0 - lr) ** steps  # may exceed 1 in magnitude: divergence
        # cap to keep scores finite even for wildly divergent members
        w = np.clip(state.w * factor, -1e6, 1e6)
        new = QuadState(w=w, steps=state.steps + steps)
        loss = 0.5 * float(np.sum(w**2)) + 0.1 * (reg - 0.3) ** 2
        return new, -loss

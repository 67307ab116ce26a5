"""Two-layer MLP in population form (port of ``mpi_opt_tpu/models/mlp.py``).

Each member's image flattened in H, W, C order, fc1 -> ReLU -> fc2 in
bf16, f32 logits. Input ``[B, P*C, H, W]`` (channels_last, members
folded into channels as in ``models/resnet.py``), output ``[P, B, K]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mpi_opt_tpu_torch.models.resnet import Dense, flatten_members, init_params


class MLP(nn.Module):
    def __init__(
        self,
        n_in: int,
        hidden: int = 128,
        n_classes: int = 10,
        dtype=torch.bfloat16,
        population: int = 1,
        device=None,
    ):
        super().__init__()
        self.dtype = dtype
        kw = dict(population=population, dtype=dtype, device=device)
        self.fc1 = Dense(n_in, hidden, **kw)
        self.fc2 = Dense(hidden, n_classes, **kw)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator):
        """flax's default initialisers, drawn from ``generator``."""
        init_params(self, generator)

    def forward(self, x):
        x = flatten_members(x.to(self.dtype), self.fc1.weight.shape[0])
        return self.fc2(F.relu(self.fc1(x))).float()

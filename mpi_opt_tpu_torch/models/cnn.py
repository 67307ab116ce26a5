"""SmallCNN in population form (port of ``mpi_opt_tpu/models/cnn.py``).

conv32-conv32-pool-conv64-conv64-pool-dense128-dense: four 3x3 SAME
convs with bias, each followed by GroupNorm(8) and ReLU through the
fused kernel (``ops/group_norm.py``, eps 1e-6), a 2x2 stride-2 max-pool
after the second and the fourth, then each member's activations
flattened in H, W, C order (flax flattens NHWC) into two dense layers.
bf16 compute, f32 parameters, f32 logits.

Members are folded into channels as in ``models/resnet.py``: input and
activations are ``[B, P*C, H, W]`` in ``torch.channels_last`` memory.
The max-pool is ``F.max_pool2d`` on that layout; its gradient goes to
one element a window, the first maximum in row-major order, as XLA's
select-and-scatter sends it. Parameter names follow flax's
(``conv{i}``, ``gn{i}``, ``fc1``, ``fc2``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mpi_opt_tpu_torch.models.resnet import Conv, Dense, GroupNorm, flatten_members, init_params


class SmallCNN(nn.Module):
    """Input ``[B, P*3, H, W]`` (channels_last, RGB), output logits
    ``[P, B, n_classes]`` f32. Width 32 on 32x32x3 images at 10 classes
    has 591,658 parameters a member. ``image_size`` is 32 for CIFAR; the
    parity tests against flax take 16 to keep the JAX side small."""

    def __init__(
        self,
        n_classes: int = 10,
        width: int = 32,
        dtype=torch.bfloat16,
        population: int = 1,
        image_size: int = 32,
        device=None,
    ):
        super().__init__()
        self.dtype = dtype
        kw = dict(population=population, dtype=dtype, device=device)
        cin = 3
        for i, ch in enumerate((width, width, 2 * width, 2 * width)):
            self.add_module(f"conv{i}", Conv(cin, ch, 3, 1, bias=True, **kw))
            self.add_module(f"gn{i}", GroupNorm(ch, 8, relu=True, **kw))
            cin = ch
        side = image_size // 2 // 2
        self.fc1 = Dense(side * side * cin, 4 * width, **kw)
        self.fc2 = Dense(4 * width, n_classes, **kw)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator):
        """flax's default initialisers, drawn from ``generator``."""
        init_params(self, generator)

    def forward(self, x):
        x = x.to(self.dtype)
        for i in range(4):
            x = getattr(self, f"gn{i}")(getattr(self, f"conv{i}")(x))
            if i % 2 == 1:
                x = F.max_pool2d(x, 2, 2)
        x = flatten_members(x, self.fc1.weight.shape[0])
        return self.fc2(F.relu(self.fc1(x))).float()

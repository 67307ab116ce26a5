"""The yardstick's counts: FLOPs of a member's step and eval, bytes of a
GroupNorm launch.

FLOPs are counted on the reference model (``reference/models.py``) on
the meta device with ``torch.utils.flop_counter``: matrix products and
convolutions, forward and the gradients a training step asks for. The
count depends on the shapes alone, whatever implements them.

A GroupNorm launch's least traffic (bf16 activations, f32 statistics):
forward reads x and writes y (2 activations), plus gamma and beta and
the per-sample mean and rstd; backward reads x and dy and writes dx (3
activations), plus those and the per-sample dgamma and dbeta partials.
Every byte is counted once. The same sums as the kernel table of the
port's bring-up script.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.models import forward, gn_groups, gn_sites, layer_shapes
from benchmark.reference.precision import exact

# data sheet, NVIDIA H100 SXM (dense, at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def member_flops(cfg: dict) -> tuple[int, int]:
    """(FLOPs of one member's training step on one minibatch, FLOPs of
    one member's eval of the whole validation set)."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = torch.device("meta")
    params = {n: torch.zeros(s, device=meta, requires_grad=True) for n, s, _ in layer_shapes(cfg)}
    side, ch = cfg["image_size"], cfg["channels"]

    def step():
        x = torch.zeros((cfg["batch_size"], side, side, ch), device=meta)
        y = torch.zeros(cfg["batch_size"], dtype=torch.long, device=meta)
        loss = F.cross_entropy(forward(cfg, params, x, exact), y)
        torch.autograd.grad(loss, list(params.values()))

    def evaluate():
        with torch.no_grad():
            forward(cfg, params, torch.zeros((cfg["n_val"], side, side, ch), device=meta), exact)

    counts = []
    for fn in (step, evaluate):
        with FlopCounterMode(display=False) as counter:
            fn()
        counts.append(int(counter.get_total_flops()))
    return counts[0], counts[1]


def gn_launch_bytes(n: int, s: int, c: int, groups: int, backward: bool, act_bytes: int = 2) -> int:
    """Least bytes of one GroupNorm launch over ``[n, s, c]``."""
    act = n * s * c * act_bytes
    small = 2 * c * 4 + 2 * n * groups * 4
    return 3 * act + small + 2 * n * c * 4 if backward else 2 * act + small


def gn_step_launches(cfg: dict, width: int) -> list:
    """(bytes, backward) of each GroupNorm launch of one training step
    of ``width`` members in one launch (members folded into channels),
    forward then backward."""
    out = []
    for backward in (False, True):
        for s, c, _ in gn_sites(cfg):
            out.append((gn_launch_bytes(cfg["batch_size"], s, width * c, width * gn_groups(cfg, c),
                                        backward), backward))
    return out

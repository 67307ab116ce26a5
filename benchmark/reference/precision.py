"""Roundings for the reference and its control.

The reference computes in float32 with TF32 off (``exact``). The
control is the same reference computed one precision below the
configuration's bfloat16: float8 with a per-tensor scale, E4M3 for
values on the way forward and E5M2 for gradients on the way back (the
usual recipe for float8 training), through ``Float8``.
"""

from __future__ import annotations

import contextlib

import torch

_F8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _scaled_round(x: torch.Tensor, dtype) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, _F8_MAX[dtype] / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _RoundF8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _scaled_round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _scaled_round(g, torch.float8_e5m2)


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def float8(x: torch.Tensor) -> torch.Tensor:
    return _RoundF8.apply(x)


ROUNDINGS = {"float32": exact, "float8": float8}


@contextlib.contextmanager
def float32_math():
    """TF32 off for matrix products and convolutions inside the block."""
    prior = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prior

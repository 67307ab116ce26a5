"""ResNet-18 in population form (port of ``mpi_opt_tpu/models/resnet.py``).

CIFAR-style ResNet: 3x3 stem, no max-pool, 4 stages of basic blocks,
GroupNorm with ``min(32, channels)`` groups and eps 1e-6, bf16 compute
with f32 parameters and f32 logits. Every GroupNorm goes through the
fused kernel (``ops/group_norm.py``).

The JAX package ``vmap``s one member's model over the population; here
the member axis is written out. Every parameter carries a leading member
axis ``[P, ...]``, and the activations of P members are folded into
channels: ``[B, P*C, H, W]`` in ``torch.channels_last`` memory, which is
physically ``[B, H, W, P, C]``. A conv is one ``F.conv2d(groups=P)``
over the members' stacked weights, a GroupNorm is one kernel call on
``[B, H*W, P*C]`` with ``P*G`` groups, and the head is a ``torch.bmm``
over members. P is read from the parameters at call time, so one module
serves any slice of members (``torch.func.functional_call``).

Parameter names follow flax's module names (``stem``, ``gn_stem``,
``stage{s}_block{b}.{conv1,gn1,conv2,gn2,proj,gn_proj}``, ``head``);
``models/convert.py`` carries a flax parameter tree across.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mpi_opt_tpu_torch.ops.group_norm import group_norm_relu

# flax's lecun_normal: truncated normal on [-2, 2] scaled so that the
# truncated distribution has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """flax/XLA "SAME" padding (low, high) of one spatial dim: a 3x3
    stride-2 conv on 32 pixels pads (0, 1), where torch's padding=1
    would pad (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def fold_members(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, P, C]`` (contiguous) -> ``[B, P*C, H, W]`` channels_last view."""
    b, h, w, p, c = x.shape
    return x.reshape(b, h, w, p * c).permute(0, 3, 1, 2)


def flatten_members(x: torch.Tensor, population: int) -> torch.Tensor:
    """``[B, P*C, H, W]`` (channels_last) -> ``[P, B, H*W*C]``: each
    member's activations flattened in H, W, C order, as flax flattens NHWC."""
    b, pc, h, w = x.shape
    c = pc // population
    x = x.permute(0, 2, 3, 1).reshape(b, h, w, population, c)
    return x.permute(3, 0, 1, 2, 4).reshape(population, b, h * w * c)


class Dense(nn.Module):
    """Population dense layer, a ``torch.bmm`` over members: weight
    ``[P, out, in]`` (flax's kernel transposed), bias ``[P, out]``."""

    def __init__(self, cin, cout, population=1, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(population, cout, cin, device=device))
        self.bias = nn.Parameter(torch.empty(population, cout, device=device))

    def init_params(self, generator):
        _lecun_normal_(self.weight, self.weight.shape[-1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        """``[P, B, in]`` -> ``[P, B, out]`` in ``dtype``. The weight is
        cast into a contiguous ``[P, in, out]`` copy (one copy, as the
        cast alone makes): with a transposed operand, the CPU's bf16
        ``bmm`` takes another kernel at 1 or 2 members than at more, and
        a member's result would depend on how many members run with it."""
        w = self.weight.transpose(1, 2).to(self.dtype, memory_format=torch.contiguous_format)
        return torch.bmm(x.to(self.dtype), w) + self.bias.to(self.dtype)[:, None, :]


class Conv(nn.Module):
    """Population conv; weight ``[P, Cout, Cin, k, k]``, and with
    ``bias`` a ``[P, Cout]`` bias (flax's ``use_bias``, zeros at init)."""

    def __init__(self, cin, cout, k, stride=1, population=1, dtype=torch.bfloat16, device=None,
                 bias: bool = False):
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        self.weight = nn.Parameter(torch.empty(population, cout, cin, k, k, device=device))
        self.bias = nn.Parameter(torch.empty(population, cout, device=device)) if bias else None

    def init_params(self, generator):
        _, _, cin, k, _ = self.weight.shape
        _lecun_normal_(self.weight, cin * k * k, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        p, cout, cin, k, _ = self.weight.shape
        (ht, hb), (wl, wr) = (same_padding(s, k, self.stride) for s in x.shape[2:])
        x = x.to(self.dtype)
        if (ht, wl) == (hb, wr):
            pad = (ht, wl)
        else:
            x = F.pad(x, (wl, wr, ht, hb)).contiguous(memory_format=torch.channels_last)
            pad = (0, 0)
        w = self.weight.reshape(p * cout, cin, k, k).to(self.dtype)
        b = None if self.bias is None else self.bias.reshape(p * cout).to(self.dtype)
        return F.conv2d(x, w, b, stride=self.stride, padding=pad, groups=p)


class GroupNorm(nn.Module):
    """Population GroupNorm(+ReLU) through the fused kernel; gamma/beta
    ``[P, C]`` (flax's ``scale``/``bias``)."""

    def __init__(self, channels, groups, relu=False, population=1, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.groups, self.relu, self.dtype = groups, relu, dtype
        self.gamma = nn.Parameter(torch.empty(population, channels, device=device))
        self.beta = nn.Parameter(torch.empty(population, channels, device=device))

    def init_params(self, generator):
        nn.init.ones_(self.gamma)
        nn.init.zeros_(self.beta)

    def forward(self, x):
        p, c = self.gamma.shape
        xl = x.to(self.dtype).permute(0, 2, 3, 1)  # channels_last -> contiguous [B,H,W,P*C]
        if not xl.is_contiguous():
            xl = xl.contiguous()
        y = group_norm_relu(
            xl, self.gamma.reshape(p * c), self.beta.reshape(p * c),
            p * self.groups, 1e-6, self.relu,
        )
        return y.permute(0, 3, 1, 2)


def init_layers(model: nn.Module) -> list:
    """(name prefix, module) of every population layer, in the order
    ``init_params`` draws them."""
    return [(n, m) for n, m in model.named_modules() if isinstance(m, (Conv, GroupNorm, Dense))]


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every population layer's parameters from ``generator``, in
    module order (flax's default initialisers)."""
    for _, m in init_layers(model):
        m.init_params(generator)


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity/projection shortcut."""

    def __init__(self, cin, channels, stride=1, population=1, dtype=torch.bfloat16, device=None):
        super().__init__()
        groups = min(32, channels)
        kw = dict(population=population, dtype=dtype, device=device)
        self.conv1 = Conv(cin, channels, 3, stride, **kw)
        self.gn1 = GroupNorm(channels, groups, relu=True, **kw)
        self.conv2 = Conv(channels, channels, 3, 1, **kw)
        self.gn2 = GroupNorm(channels, groups, **kw)
        if cin != channels or stride != 1:
            self.proj = Conv(cin, channels, 1, stride, **kw)
            self.gn_proj = GroupNorm(channels, groups, **kw)
        else:
            self.proj = None

    def forward(self, x):
        y = self.gn2(self.conv2(self.gn1(self.conv1(x))))
        if self.proj is not None:
            x = self.gn_proj(self.proj(x))
        return F.relu(x + y)


class ResNet(nn.Module):
    """CIFAR-style ResNet; ResNet-18 = stage_sizes (2, 2, 2, 2).

    Input ``[B, P*in_channels, H, W]`` (channels_last; member p's image
    in channels p*in_channels...), output logits ``[P, B, n_classes]`` f32.
    """

    def __init__(
        self,
        n_classes: int = 100,
        stage_sizes: Sequence[int] = (2, 2, 2, 2),
        width: int = 64,
        dtype=torch.bfloat16,
        population: int = 1,
        in_channels: int = 3,
        device=None,
    ):
        super().__init__()
        self.dtype = dtype
        kw = dict(population=population, dtype=dtype, device=device)
        self.stem = Conv(in_channels, width, 3, 1, **kw)
        self.gn_stem = GroupNorm(width, min(32, width), relu=True, **kw)
        self.block_names = []
        cin = width
        for stage, n_blocks in enumerate(stage_sizes):
            channels = width * 2**stage
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                name = f"stage{stage}_block{b}"
                self.add_module(name, BasicBlock(cin, channels, stride, **kw))
                self.block_names.append(name)
                cin = channels
        self.head = Dense(cin, n_classes, **kw)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator):
        """flax's default initialisers, drawn from ``generator``."""
        init_params(self, generator)

    def forward(self, x):
        x = self.gn_stem(self.stem(x.to(self.dtype)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        b = x.shape[0]
        p = self.head.weight.shape[0]
        x = x.mean(dim=(2, 3)).reshape(b, p, -1).transpose(0, 1)  # global pool -> [P, B, C]
        return self.head(x).float()


def ResNet18(n_classes: int = 100, width: int = 64, **kw) -> ResNet:
    return ResNet(n_classes=n_classes, stage_sizes=(2, 2, 2, 2), width=width, **kw)

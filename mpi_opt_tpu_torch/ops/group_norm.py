"""Fused GroupNorm(+ReLU) with its gradient: hand-written CUDA kernels.

Port of ``mpi_opt_tpu/ops/pallas_gn.py``. ``group_norm_relu`` is a
``torch.autograd.Function`` over channel-last ``[B, ..., C]`` input:

- a CUDA tensor goes to the kernels of ``csrc/group_norm.cu`` (forward:
  ``gn_fwd``; backward: ``gn_bwd``), launched as ``gn_plan`` cuts the
  shape, or the call raises;
- a CPU tensor goes to the plain versions in this module
  (``group_norm_relu_plain`` / ``group_norm_relu_bwd_plain``), which do
  the same arithmetic in torch ops. The tests run them against the JAX
  package; ``chip_smoke.py`` holds the kernels against them on the card;
- a meta tensor (shapes only, as the trainer's ``member_flops`` counts a step)
  goes through the plain versions too, uncounted: nothing is computed.

Statistics are f32 whatever the activation dtype, var is
``E[x^2] - mean^2`` clamped at 0 (as flax's ``nn.GroupNorm``: rounding
can make it negative at a large mean, and ``rsqrt`` of a negative
``var + eps`` is NaN), eps sits inside the rsqrt, and the backward
recomputes the ReLU mask from x and the saved statistics. dgamma/dbeta
come out of the kernel as per-sample partials ``[N, C]`` and are summed
over N here, as the JAX package leaves that sum to XLA.

A population folded into channels (member p's channel c at p*C + c,
``P*G`` groups, gamma/beta flattened to ``[P*C]``) is exactly per-member
GroupNorm, because each member's groups are a contiguous run of
channels; its dgamma/dbeta stay per member since they sum over N only.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

# launches of each kernel, and calls of the plain versions on CPU tensors
# (forward or backward); ``chip_smoke.py`` zeroes them around the main path
LAUNCHES = {"gn_fwd": 0, "gn_bwd": 0, "plain": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "gn_fwd": [_P] * 6 + [_I] * 7 + [ctypes.c_float, _I, _I, _P],
    "gn_bwd": [_P] * 9 + [_I] * 9 + [_P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int):
    if x.dim() < 2:
        raise ValueError(f"group_norm_relu takes [B, ..., C], got shape {tuple(x.shape)}")
    c = x.shape[-1]
    if c % groups:
        raise ValueError(
            f"number of channels ({c}) must be divisible by num_groups ({groups})"
        )
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"group_norm_relu takes float32 or bfloat16 x, got {x.dtype}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.shape != (c,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{c}], got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"group_norm_relu runs on cuda, cpu or meta, not {x.device}")


# -- plain versions (the CPU path, and the kernels' yardstick) -----------


def group_norm_relu_plain(x, gamma, beta, groups: int, eps: float = 1e-6, relu: bool = True):
    """(y [N,S,C] in x's dtype, mean [N,G] f32, rstd [N,G] f32) for x [N,S,C]."""
    n, s, c = x.shape
    xg = x.float().reshape(n, s, groups, c // groups)
    mean = xg.mean(dim=(1, 3))
    var = ((xg * xg).mean(dim=(1, 3)) - mean * mean).clamp(min=0.0)  # NaN passes
    rstd = torch.rsqrt(var + eps)
    xhat = ((xg - mean[:, None, :, None]) * rstd[:, None, :, None]).reshape(n, s, c)
    y = xhat * gamma + beta
    if relu:
        y = torch.where(y < 0, torch.zeros_like(y), y)  # NaN passes, as jnp.maximum
    return y.to(x.dtype), mean, rstd


def group_norm_relu_bwd_plain(x, dy, gamma, beta, mean, rstd, groups: int, relu: bool = True):
    """(dx [N,S,C] in x's dtype, dgamma, dbeta partials [N,C] f32)."""
    n, s, c = x.shape
    gs = c // groups
    expand = lambda t: t.repeat_interleave(gs, dim=1)[:, None, :]  # [N,G] -> [N,1,C]
    xhat = (x.float() - expand(mean)) * expand(rstd)
    d = dy.float()
    if relu:
        d = torch.where(xhat * gamma + beta > 0, d, torch.zeros_like(d))
    dgamma = (d * xhat).sum(dim=1)
    dbeta = d.sum(dim=1)
    dz = d * gamma
    m1 = dz.reshape(n, s, groups, gs).mean(dim=(1, 3))
    m2 = (dz * xhat).reshape(n, s, groups, gs).mean(dim=(1, 3))
    dx = expand(rstd) * (dz - expand(m1) - xhat * expand(m2))
    return dx.to(x.dtype), dgamma, dbeta


# -- kernels --------------------------------------------------------------

SMEM_MAX = 232448  # dynamic shared memory one block may use on sm_90
MAX_THREADS = 256
MAX_CLUSTER = 8  # the portable cluster size
TILE_BYTES = 32 << 10  # target bytes of each staged tensor a block
MIN_ROW_BYTES = 128  # a block's slice of a row: at least one 128-byte line


@dataclasses.dataclass(frozen=True)
class GNPlan:
    """How a kernel launch cuts ``[N, S, C]``: the grid is
    ``(cluster, C // cb, N)``, and the ``cluster`` blocks of one slice
    split its S rows, ``rb`` each. The kernels take ``cb``, ``rb`` and
    ``cluster``; ``rl``, ``threads`` and ``smem`` are what the C side
    derives from them (``Geom``, ``smem_bytes``), kept here to check the
    plan against the card's limits and to report it."""

    cb: int  # channels a block: whole groups, a multiple of 16 bytes
    rb: int  # rows a block
    rl: int  # row lanes: threads that share a 16-byte column of the slice
    cluster: int  # blocks a cluster
    threads: int  # threads a block
    smem: int  # dynamic shared memory a block, bytes


@functools.lru_cache(maxsize=None)
def gn_plan(n: int, s: int, c: int, groups: int, dtype: torch.dtype, backward: bool) -> GNPlan:
    """The launch plan of ``gn_fwd`` (``backward=False``) or ``gn_bwd``
    on ``[n, s, c]`` with ``groups`` groups; raises ``ValueError`` for a
    shape that no plan holds.

    Sized by bytes: a block's channel slice holds whole groups, is a
    multiple of 16 bytes and spans at least 128 bytes of a row where C
    allows; it widens while all S rows of it stay within ``TILE_BYTES``
    a staged tensor, and where they do not, a cluster of up to 8 blocks
    splits the rows. ``threads`` and ``smem`` follow ``Geom`` and
    ``smem_bytes`` in ``csrc/group_norm.cu``, which derive them again
    and refuse a plan over the card's limits.
    """
    elt = torch.empty((), dtype=dtype).element_size()
    shape = (
        f"[{n}, {s}, {c}] with {groups} groups in {dtype}, "
        f"{'backward' if backward else 'forward'}"
    )
    if groups < 1 or c % groups or not 1 <= n <= 65535 or s < 1 or elt not in (2, 4):
        raise ValueError(f"no GroupNorm plan holds {shape}")
    vec = 16 // elt
    gs = c // groups
    quantum = math.lcm(gs, vec)
    cands = [cb for cb in range(quantum, c + 1, quantum) if c % cb == 0 and cb // vec <= MAX_THREADS]
    if not cands:
        raise ValueError(
            f"no GroupNorm plan holds {shape}: no slice of whole groups is a multiple of "
            f"16 bytes within {MAX_THREADS} 16-byte columns"
        )
    narrow = next((cb for cb in cands if cb * elt >= MIN_ROW_BYTES), cands[-1])
    if s * narrow * elt <= TILE_BYTES:
        cb = max(cb for cb in cands if cb >= narrow and s * cb * elt <= TILE_BYTES)
        cluster = 1
    else:
        cb = narrow
        cluster = min(MAX_CLUSTER, -(-s * cb * elt // TILE_BYTES))
    rb = -(-s // cluster)
    v = cb // vec
    rl = max(1, MAX_THREADS // v)
    threads = -(-v * rl // 32) * 32
    slots = threads // 32 if v < 32 and 32 % v == 0 else rl
    gib = cb // gs
    floats = 2 * slots * cb + (2 * cb if backward else 2 * cluster * gib) + 2 * gib
    smem = (2 if backward else 1) * rb * cb * elt + 4 * floats
    if smem > SMEM_MAX:
        raise ValueError(
            f"no GroupNorm plan holds {shape}: a block would need {smem} bytes of shared "
            f"memory, over {SMEM_MAX}"
        )
    return GNPlan(cb, rb, rl, cluster, threads, smem)


def _lib():
    from mpi_opt_tpu_torch.ops import _build

    return _build.load("group_norm", _SIGNATURES)


def _check_launch(name: str, vectors, scalars) -> None:
    """The kernels move ``vectors`` (x, dy) 16 bytes at a time and read
    ``scalars`` (gamma, beta, statistics) one float at a time."""
    if not all(t.is_contiguous() for t in (*vectors, *scalars)):
        raise ValueError(f"{name} takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in vectors):
        raise ValueError(f"{name} takes activations aligned to 16 bytes")


def gn_fwd(x, gamma, beta, groups: int, eps: float, relu: bool):
    """Forward on x [N,S,C]: the kernel for a CUDA tensor, the plain
    version for a CPU one. Returns (y, mean [N,G], rstd [N,G])."""
    _check(x, gamma, beta, groups)
    if x.device.type != "cuda":
        # meta carries shapes only (the FLOP count) and is never on the
        # card; no other device type gets this far
        if x.device.type == "cpu":
            LAUNCHES["plain"] += 1
        return group_norm_relu_plain(x, gamma, beta, groups, eps, relu)
    _check_launch("gn_fwd", (x,), (gamma, beta))
    n, s, c = x.shape
    p = gn_plan(n, s, c, groups, x.dtype, False)
    y = torch.empty_like(x)
    mean = torch.empty((n, groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    with torch.cuda.device(x.device):
        err = _lib().gn_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), n, s, c, groups,
            p.cb, p.rb, p.cluster, eps, int(relu), int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"gn_fwd kernel launch failed with CUDA error {err} (plan {p})")
    LAUNCHES["gn_fwd"] += 1
    return y, mean, rstd


def gn_bwd(x, dy, gamma, beta, mean, rstd, groups: int, relu: bool):
    """Backward on x, dy [N,S,C]: returns (dx, dgamma [N,C], dbeta [N,C])
    per-sample partials; the kernel for CUDA tensors, plain for CPU."""
    _check(x, gamma, beta, groups)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("dy must match x in shape, dtype and device")
    if x.device.type != "cuda":
        # meta: shapes only, never on the card (see gn_fwd)
        if x.device.type == "cpu":
            LAUNCHES["plain"] += 1
        return group_norm_relu_bwd_plain(x, dy, gamma, beta, mean, rstd, groups, relu)
    _check_launch("gn_bwd", (x, dy), (gamma, beta, mean, rstd))
    n, s, c = x.shape
    p = gn_plan(n, s, c, groups, x.dtype, True)
    dx = torch.empty_like(x)
    dgamma = torch.empty((n, c), dtype=torch.float32, device=x.device)
    dbeta = torch.empty_like(dgamma)
    with torch.cuda.device(x.device):
        err = _lib().gn_bwd(
            x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
            dbeta.data_ptr(), n, s, c, groups,
            p.cb, p.rb, p.cluster, int(relu), int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"gn_bwd kernel launch failed with CUDA error {err} (plan {p})")
    LAUNCHES["gn_bwd"] += 1
    return dx, dgamma, dbeta


class _GroupNormReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps, relu):
        x3 = x.reshape(x.shape[0], -1, x.shape[-1])
        y, mean, rstd = gn_fwd(x3, gamma, beta, groups, eps, relu)
        ctx.save_for_backward(x3, gamma, beta, mean, rstd)
        ctx.groups, ctx.relu, ctx.shape = groups, relu, x.shape
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x3, gamma, beta, mean, rstd = ctx.saved_tensors
        dy3 = dy.reshape(x3.shape).contiguous()
        dx, dgamma, dbeta = gn_bwd(x3, dy3, gamma, beta, mean, rstd, ctx.groups, ctx.relu)
        return dx.reshape(ctx.shape), dgamma.sum(dim=0), dbeta.sum(dim=0), None, None, None


def group_norm_relu(x, gamma, beta, groups: int = 32, eps: float = 1e-6, relu: bool = True):
    """Fused GroupNorm(+ReLU) over channel-last ``[B, ..., C]``."""
    return _GroupNormReLU.apply(x, gamma, beta, groups, eps, relu)

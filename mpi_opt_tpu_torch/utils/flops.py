"""FLOP accounting and MFU of a sweep (port of ``mpi_opt_tpu/utils/flops.py``).

The JAX package reads its FLOPs from XLA's cost analysis of a
one-member, one-step program. The port's trainer counts its own
one-member, one-step training update and one eval chunk with
``torch.utils.flop_counter.FlopCounterMode`` on the meta device
(``PopulationTrainer.member_flops``: shapes only, nothing is computed or
allocated), and this module scales them by their trip counts, as the
JAX function does. The counter counts matrix products
and convolutions, forward and the gradients autograd asks for (conv0's
input needs none), and not elementwise work, GroupNorm or pooling: for
the SmallCNN that is every conv and dense FLOP, exactly, and a little
under XLA's count, which includes the elementwise ops.

Peaks are the data sheet's dense bf16 rates, keyed by the card's name;
a card not in the table has none, and its MFU is None.
"""

from __future__ import annotations

import torch

# (substring of torch.cuda.get_device_name, dense bf16 FLOP/s), NVIDIA's
# data sheets; the SXM part names itself "NVIDIA H100 80GB HBM3"
_PEAKS = (
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H100 SXM", 989e12),
    ("H100 80GB HBM3", 989e12),
)


def peak_flops_per_chip(device=None) -> float | None:
    """Dense bf16 peak FLOP/s of a CUDA ``device`` (default: the current
    one); None for the CPU and for a card the table does not name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(dev)
    return next((peak for key, peak in _PEAKS if key in name), None)


def population_sweep_flops(
    workload, population: int, generations: int, steps_per_gen: int,
    n_evals: int | None = None, eval_chunk: int = 1024,
) -> int:
    """FLOPs of a fused population sweep: the one-member pieces that the
    workload's trainer counts (``PopulationTrainer.member_flops``) times
    their trip counts. ``n_evals`` defaults to ``generations``: fused PBT
    evaluates once a generation."""
    d = workload.data()
    f_step, f_eval = workload.make_trainer(device="cpu").member_flops(d["train_x"].shape[1:], eval_chunk)
    n_val = len(d["val_y"])
    n_chunks = -(-n_val // eval_chunk)
    if n_evals is None:
        n_evals = generations
    return population * (generations * steps_per_gen * f_step + n_evals * n_chunks * f_eval)


def mfu(total_flops, seconds: float, device=None) -> float | None:
    """Achieved FLOP/s as a fraction of the card's dense bf16 peak; None
    without a count, a peak or a positive time."""
    peak = peak_flops_per_chip(device)
    if not total_flops or not peak or seconds <= 0:
        return None
    return total_flops / seconds / peak

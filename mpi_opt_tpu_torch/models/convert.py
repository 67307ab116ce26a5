"""Carries a flax parameter tree across to the port's parameters.

Input: the flax ``params`` tree of ``mpi_opt_tpu.models`` ``ResNet``,
``SmallCNN`` or ``MLP`` as nested dicts of numpy arrays, for one member
or stacked over a leading member axis. Output: a dict ``name -> tensor
[P, ...]`` keyed as the port model's ``named_parameters()``. Conv
kernels HWIO become OIHW, Dense kernels ``[in, out]`` become
``[out, in]``, GroupNorm ``scale``/``bias`` become ``gamma``/``beta``,
conv and Dense biases keep their name. The port flattens each member's
activations in H, W, C order, as flax does, so a Dense kernel after a
flatten (SmallCNN's ``fc1``) needs no row permutation.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def flax_to_torch(tree, stacked: bool = False, device=None) -> dict[str, torch.Tensor]:
    """flax params -> the port's ``{name: tensor[P, ...]}``."""
    out = {}
    for path, a in _leaves(tree):
        if not stacked:
            a = a[None]
        module, leaf = path[-2], path[-1]
        if leaf == "kernel" and a.ndim == 5:  # conv [P, kh, kw, I, O]
            name, a = "weight", a.transpose(0, 4, 3, 1, 2)
        elif leaf == "kernel":  # dense [P, in, out]
            name, a = "weight", a.transpose(0, 2, 1)
        elif module.startswith("gn"):
            name = {"scale": "gamma", "bias": "beta"}[leaf]
        else:
            name = leaf
        key = ".".join(path[:-1] + (name,))
        out[key] = torch.tensor(np.asarray(a, dtype=np.float32), device=device)
    return out

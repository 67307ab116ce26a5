"""JAX's draws handed to the port's host algorithms, so both packages
decide from the same numbers. Not a test module (no ``test_`` prefix):
the algorithm and driver parity tests import it.

``install(monkeypatch)`` replaces every ``_draw_*`` method of the port's
algorithms (and of its suggestion server) with one that makes JAX's own draw for the same path
(``fold_in`` chains from the seed; BOHB's two-way split). ``pair(name)``
builds a JAX algorithm and its port over one four-parameter space, and
``score`` is the fixed function of a trial's params and budget that the
stub backends of both test files score with.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mpi_opt_tpu.algorithms as jalg
import mpi_opt_tpu.ops.tpe as jtpe
import mpi_opt_tpu.space as jspace
import mpi_opt_tpu_torch.algorithms as talg
import mpi_opt_tpu_torch.corpus.serve as tserve
import mpi_opt_tpu_torch.ops.tpe as ttpe
import mpi_opt_tpu_torch.space as tspace
from mpi_opt_tpu.ops.pbt import PBTConfig as JPBTConfig
from mpi_opt_tpu_torch.algorithms.base import Algorithm
from mpi_opt_tpu_torch.ops.pbt import PBTConfig

C = 64  # acquisition candidates (small: the JAX side compiles it)

#: each algorithm's arguments and the batch capacity it runs at
CASES = {
    "random": (dict(max_trials=10, budget=5), 4),
    "asha": (dict(max_trials=20, min_budget=1, max_budget=9, eta=3), 4),
    "pbt": (dict(population=6, generations=3, steps_per_generation=5), 4),
    "tpe": (dict(max_trials=24, budget=3, n_startup=6, buffer_size=32), 4),
    "hyperband": (dict(max_budget=9, eta=3), 4),
    "bohb": (dict(max_budget=9, eta=3, buffer_size=32, n_min=5), 4),
}


def space(mod):
    return mod.SearchSpace({
        "lr": mod.LogUniform(1e-3, 1.0),
        "momentum": mod.Uniform(0.5, 0.99),
        "layers": mod.IntUniform(1, 4),
        "act": mod.Choice(["relu", "tanh", "gelu"]),
    })


def score(p, budget):
    return (-(math.log10(p["lr"]) + 1.5) ** 2 - 4 * (p["momentum"] - 0.8) ** 2 + 0.1 * p["layers"]
            + {"relu": 0.2, "tanh": 0.0, "gelu": 0.1}[p["act"]] + 0.05 * math.log(budget + 1))


def pair(name, seed=11, **overrides):
    """(JAX algorithm, port algorithm) of ``CASES[name]`` at ``seed``."""
    kw = {**CASES[name][0], **overrides}
    jkw, tkw = dict(kw), dict(kw)
    if name in ("tpe", "bohb"):
        jkw["config"] = jtpe.TPEConfig(n_candidates=C)
        tkw["config"] = ttpe.TPEConfig(n_candidates=C)
        tkw["device"] = "cpu"
    if name == "pbt":
        jkw["config"], tkw["config"] = JPBTConfig(truncation_frac=0.34), PBTConfig(truncation_frac=0.34)
    return (jalg.get_algorithm(name)(space(jspace), seed=seed, **jkw),
            talg.get_algorithm(name)(space(tspace), seed=seed, **tkw))


def key(path):
    k = jax.random.key(path[0])
    for p in path[1:]:
        k = jax.random.fold_in(k, p)
    return k


def tpe_draws(k, d):
    """The draws of jtpe.tpe_suggest from ``k``: (u_pick, jitter, uni)."""
    k_uni, k_pick, k_jitter = jax.random.split(k, 3)
    return ttpe.TPEDraws(
        torch.from_numpy(np.array(jax.random.uniform(k_pick, (C,)))),
        torch.from_numpy(np.array(jax.random.normal(k_jitter, (C, d)))),
        torch.from_numpy(np.array(jax.random.uniform(k_uni, (C, d)))),
    )


def bohb_key(path):
    """BOHB's paths end in the half of the split JAX takes."""
    return jax.random.split(key(path[:-1]))[path[-1]]


def install(monkeypatch):
    """Every port draw replaced by JAX's draw for the same path."""
    def unit(self, path, n):
        k = bohb_key(path) if isinstance(self, talg.BOHB) else key(path)
        return np.array(jax.random.uniform(k, (n, self.space.dim), dtype=jnp.float32))

    def uniform(self, path):
        return float(jax.random.uniform(bohb_key(path)))

    def tpe(self, path, m, d):
        return tpe_draws(bohb_key(path) if isinstance(self, talg.BOHB) else key(path), d)

    def pbt(self, path, n, d):
        k_src, k_noise, k_res, k_val = jax.random.split(key(path), 4)
        cut = max(1, int(round(n * self.config.truncation_frac)))
        return (torch.from_numpy(np.array(jax.random.randint(k_src, (n,), 0, cut))).long(),
                torch.from_numpy(np.array(jax.random.normal(k_noise, (n, d)))),
                torch.from_numpy(np.array(jax.random.uniform(k_res, (n, d)))),
                torch.from_numpy(np.array(jax.random.uniform(k_val, (n, d)))))

    monkeypatch.setattr(Algorithm, "_draw_unit", unit)
    monkeypatch.setattr(Algorithm, "_draw_uniform", uniform)
    monkeypatch.setattr(talg.TPE, "_draw_tpe", tpe)
    monkeypatch.setattr(talg.BOHB, "_draw_tpe", tpe)
    monkeypatch.setattr(talg.PBT, "_draw_exploit", pbt)
    # the suggestion server draws as the TPE algorithm does (JAX:
    # fold_in(key(seed), suggested) for both branches)
    monkeypatch.setattr(tserve.SuggestServer, "_draw_unit", unit)
    monkeypatch.setattr(tserve.SuggestServer, "_draw_tpe", tpe)

"""Fused BOHB (port of ``mpi_opt_tpu/train/fused_bohb.py``): model-based
Hyperband with on-device brackets.

The bracket execution IS ``fused_hyperband`` (one loop: seeds, the
per-bracket snapshot layout, the best pick); this module supplies its
two model hooks. ``cohort_fn`` samples each bracket's initial cohort:
uniform, except that once a budget qualifies (``ObsStore.model_budget``,
the highest budget with ``n_min`` live observations) each trial is
drawn from a TPE model fit on that budget's ring with probability
``1 - random_fraction``. The model work is ONE batched ``tpe_suggest``
a bracket, on the device. ``observe_fn`` feeds every rung's scores
(``rung_history``) into the ``ObsStore``, which drops non-finite ones,
so a trial promoted through three rungs gives three observations at
three budgets.

Crash recovery: brackets snapshot at rung granularity (``bracket_b``
subdirectories), and each bracket's sampled cohort is persisted
(``cohort_b.npz``) and reused on resume, so a resume never depends on
the model drawing the same bits again.

``warm_obs`` (a prior sweep's observations) files into the same
``ObsStore`` before the first bracket, so the model can qualify before
any bracket ran.

Under a ``mesh`` the acquisition runs identically on every rank (same
generator, same observations: every rank's brackets return the same
rung records) and each rank trains its rows of the cohort;
``round_to`` reaches the brackets' ``fused_sha``.
"""

from __future__ import annotations

import numpy as np
import torch

from mpi_opt_tpu_torch.algorithms.bohb import ObsStore, default_n_min
from mpi_opt_tpu_torch.device import resolve_device
from mpi_opt_tpu_torch.ops.tpe import TPEConfig, tpe_suggest
from mpi_opt_tpu_torch.train.common import workload_arrays
from mpi_opt_tpu_torch.train.engine import boundary_span
from mpi_opt_tpu_torch.train.fused_asha import fused_hyperband

def bracket_generator(seed: int, b: int, device) -> torch.Generator:
    """Bracket ``b``'s cohort generator, seeded from (seed, 104729 + b)
    (the JAX package folds ``104729 + b`` into the sweep's key)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, 104729 + b]).generate_state(1)[0]))
    return gen


def fused_bohb(  # sweeplint: barrier(bracket host loop: files rung observations into the host-side ObsStore)
    workload,
    max_budget: int = 270,
    eta: int = 3,
    seed: int = 0,
    member_chunk: int = 0,
    checkpoint_dir: str | None = None,
    random_fraction: float = 1 / 3,
    n_min: int | None = None,
    buffer_size: int = 512,
    cfg: TPEConfig = TPEConfig(),
    ledger=None,
    wave_size=0,
    oom_backoff: int = 2,
    device=None,
    warm_obs=None,
    mesh=None,
    round_to: int = 1,
):
    """Returns ``fused_hyperband``'s result, each bracket's summary with
    ``n_model_sampled`` (how many of its cohort the model drew).

    ``wave_size``/``oom_backoff`` pass through to every bracket's
    ``fused_sha``; ``ledger`` journals every rung through the brackets'
    offsets; ``checkpoint_dir`` snapshots every rung and persists every
    cohort. ``warm_obs`` (prior-ledger observations, cross-mode): each
    finite prior is filed into the per-budget ``ObsStore`` at its budget
    before the first bracket (the driver BOHB's warm start). ``mesh`` /
    ``round_to``: ``fused_sha``'s, for every bracket."""
    dev = resolve_device(device)
    _, space, *_ = workload_arrays(workload, member_chunk, dev)
    if n_min is None:
        n_min = default_n_min(space.dim)
    obs = ObsStore(space.dim, buffer_size, n_min)
    for o in warm_obs or ():
        if np.isfinite(float(o.score)):
            obs.add(int(o.budget), np.asarray(o.unit), float(o.score))

    def cohort_fn(b: int, n: int):  # sweeplint: barrier(per-bracket re-suggest: the TPE acquisition completes on host by design)
        """(initial unit matrix, model-drawn count) for bracket b: the
        uniform cohort, then the model mask and the model's draws where
        a budget qualifies."""
        gen = bracket_generator(seed, b, dev)
        cohort = space.sample_unit(gen, n).cpu().numpy()
        budget = obs.model_budget()
        if budget is None:
            return cohort, 0
        from_model = (torch.rand((n,), generator=gen, device=dev) >= random_fraction).cpu().numpy()
        n_model = int(from_model.sum())
        if n_model == 0:
            return cohort, 0
        s = obs.budgets[budget]
        ring = [torch.from_numpy(s[k]).to(dev) for k in ("unit", "score", "valid")]
        # one diversified acquisition for the whole cohort, at the
        # bracket's size n (any prefix of a diversified batch is a valid
        # draw set); the fetch is its completion barrier, in the span
        with boundary_span("suggest", bracket=b, n=n):
            sugg, _ = tpe_suggest(gen, *ring, n, cfg)
            cohort[from_model] = sugg.cpu().numpy()[:n_model]
        return cohort, n_model

    def observe_fn(b: int, cohort: np.ndarray, res: dict) -> None:
        for rung in res["rung_history"]:
            for i, sc in zip(rung["trials"], rung["scores"]):
                obs.add(rung["budget"], cohort[int(i)], float(sc))

    return fused_hyperband(
        workload,
        max_budget=max_budget,
        eta=eta,
        seed=seed,
        member_chunk=member_chunk,
        checkpoint_dir=checkpoint_dir,
        ledger=ledger,
        wave_size=wave_size,
        oom_backoff=oom_backoff,
        device=device,
        cohort_fn=cohort_fn,
        observe_fn=observe_fn,
        # the priors are in the ObsStore already: passing them down would
        # also seed the brackets' cohorts and count them twice
        warm_obs=None,
        mesh=mesh,
        round_to=round_to,
    )

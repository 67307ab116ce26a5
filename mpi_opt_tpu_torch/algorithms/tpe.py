"""TPE, host wrapper around the vectorized acquisition (port of
``mpi_opt_tpu/algorithms/tpe.py``).

The math is ``ops/tpe.py`` (a fixed-shape ring buffer, all candidates
scored in one broadcast); this class owns the ring and the trials. The
ring lives on the host and the acquisition runs on ``device`` (CUDA
unless the caller asks for the CPU); its draws come from a CPU
generator (``_draw_tpe``), so the same draws give the same suggestion
on either device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from mpi_opt_tpu_torch.algorithms.base import Algorithm, path_generator
from mpi_opt_tpu_torch.device import resolve_device
from mpi_opt_tpu_torch.ops.tpe import TPEConfig, TPEDraws, draw_tpe, pick_components, tpe_apply, tpe_fit
from mpi_opt_tpu_torch.space import SearchSpace
from mpi_opt_tpu_torch.trial import TrialResult, TrialStatus


def suggest_from_ring(draws: TPEDraws, ring, n_suggest: int, cfg: TPEConfig, device) -> np.ndarray:
    """``tpe_suggest`` on host ring arrays (unit, score, valid) with the
    given draws, on ``device``; returns ``float32[n_suggest, d]`` on the
    host (the fetch is the suggestion's completion)."""
    unit, score, valid = (torch.from_numpy(np.asarray(a)).to(device) for a in ring)
    draws = TPEDraws(*(a.to(device) for a in draws))
    model = tpe_fit(unit, score, valid, cfg)
    comp = pick_components(draws.u_pick, model.probs)
    sugg, _ = tpe_apply(unit, model, comp, draws.jitter, draws.uni, n_suggest, cfg)
    return sugg.cpu().numpy()


class TPE(Algorithm):
    name = "tpe"

    def __init__(
        self,
        space: SearchSpace,
        seed: int = 0,
        max_trials: int = 64,
        budget: int = 1,
        n_startup: int = 10,  # pure-random warm-up before the surrogate
        buffer_size: int = 512,
        config: TPEConfig = TPEConfig(),
        device=None,
    ):
        super().__init__(space, seed)
        self.max_trials = max_trials
        self.budget = budget
        self.n_startup = n_startup
        self.config = config
        self.buffer_size = buffer_size
        self.device = resolve_device(device)
        self._obs_unit = np.zeros((buffer_size, space.dim), dtype=np.float32)
        self._obs_score = np.zeros(buffer_size, dtype=np.float32)
        self._valid = np.zeros(buffer_size, dtype=bool)
        self._n_obs = 0
        self._suggested = 0
        self._done = 0

    def _draw_tpe(self, path, m: int, d: int) -> TPEDraws:
        """One acquisition's draws (``ops/tpe.py::draw_tpe``)."""
        return draw_tpe(path_generator(path), m, d, self.config)

    def ingest_observations(self, observations):
        """Prior observations fill the ring as live reports do and count
        toward ``n_startup``; they never touch the trials. Ascending
        score order: a prior that overflows the ring evicts its worst."""
        finite = [o for o in observations if np.isfinite(o.score)]
        finite.sort(key=lambda o: o.score)
        for o in finite:
            slot = self._n_obs % self.buffer_size
            self._obs_unit[slot] = np.asarray(o.unit, dtype=np.float32)
            self._obs_score[slot] = o.score
            self._valid[slot] = True
            self._n_obs += 1
        return len(finite)

    def next_batch(self, n):
        out = []
        self._drain_requeue(out, n)
        # the surrogate scores only n_candidates points: a larger backend
        # capacity is clamped
        take = min(n - len(out), self.max_trials - self._suggested, self.config.n_candidates)
        if take <= 0:
            return out
        path = (self.seed, self._suggested)
        if self._n_obs < self.n_startup:
            unit = self._draw_unit(path, take)
        else:
            # n_suggest rounded up to a power of two, as the JAX package
            # bounds its compiled variants: the greedy picks' prefix is
            # the same, so this keeps the suggestions equal
            block = 1 << (take - 1).bit_length()
            draws = self._draw_tpe(path, self.buffer_size, self.space.dim)
            ring = (self._obs_unit, self._obs_score, self._valid)
            unit = suggest_from_ring(draws, ring, min(block, self.config.n_candidates),
                                     self.config, self.device)[:take]
        for i in range(take):
            t = self._new_trial(unit[i], budget=self.budget)
            t.status = TrialStatus.RUNNING
            out.append(t)
        self._suggested += take
        return out

    def report_batch(self, results: Sequence[TrialResult]):
        for r in results:
            if not r.ok:
                # failed trials never enter the ring: a NaN would poison
                # the Parzen moments, and counting it toward n_startup
                # would engage the surrogate on garbage
                self._mark_failed(r)
                self._done += 1
                continue
            t = self.trials[r.trial_id]
            t.record(r.score, r.step)
            t.status = TrialStatus.DONE
            slot = self._n_obs % self.buffer_size
            self._obs_unit[slot] = t.unit
            self._obs_score[slot] = r.score
            self._valid[slot] = True
            self._n_obs += 1
            self._done += 1

    def finished(self):
        return self._done >= self.max_trials

    # -- checkpoint -------------------------------------------------------

    def state_dict(self):
        d = super().state_dict()
        d["tpe"] = {
            "obs_unit": self._obs_unit.tolist(),
            "obs_score": self._obs_score.tolist(),
            "valid": self._valid.tolist(),
            "n_obs": self._n_obs,
            "suggested": self._suggested,
            "done": self._done,
        }
        return d

    def load_state_dict(self, state):
        super().load_state_dict(state)
        t = state["tpe"]
        self._obs_unit = np.asarray(t["obs_unit"], dtype=np.float32)
        self._obs_score = np.asarray(t["obs_score"], dtype=np.float32)
        self._valid = np.asarray(t["valid"], dtype=bool)
        self._n_obs = t["n_obs"]
        self._suggested = t["suggested"]
        self._done = t["done"]
        self._requeue_running()

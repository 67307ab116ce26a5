"""Population Based Training, host-side generational bookkeeping (port of
``mpi_opt_tpu/algorithms/pbt.py``).

The algorithm emits one generation of member trials at a time; on a
full generation's results it runs the same exploit/explore decision the
fused sweep runs (``ops/pbt.py``), on the host. A weight copy reaches the
backend as ``params["__inherit_from__"]`` (the source member's trial
id), which the slot-pool backend realises as a gather on the device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from mpi_opt_tpu_torch.algorithms.base import Algorithm, path_generator
from mpi_opt_tpu_torch.ops.pbt import PBTConfig, apply_exploit_explore, draw_exploit_explore
from mpi_opt_tpu_torch.space import SearchSpace
from mpi_opt_tpu_torch.trial import TrialResult, TrialStatus


class PBT(Algorithm):
    name = "pbt"

    def __init__(
        self,
        space: SearchSpace,
        seed: int = 0,
        population: int = 32,
        generations: int = 10,
        steps_per_generation: int = 200,
        config: PBTConfig = PBTConfig(),
    ):
        super().__init__(space, seed)
        self.population = population
        self.generations = generations
        self.steps_per_generation = steps_per_generation
        self.config = config
        self.generation = 0
        # slot -> the trial occupying it; a trial is one member-generation
        self._slots: list[int] = []
        self._pending: set[int] = set()  # spawned but unreported
        self._dispatch: list[int] = []  # spawned but not yet handed out
        self._gen_scores = np.zeros(population, dtype=np.float32)
        self._unit = None  # float32[population, d], the current hparams

    def _draw_exploit(self, path, n: int, d: int):
        """The exploit/explore draws (``ops/pbt.py::draw_exploit_explore``)."""
        return draw_exploit_explore(path_generator(path), n, d, self.config)

    def _spawn_generation(self, unit: np.ndarray, inherit: np.ndarray | None):
        """Create this generation's member trials and queue them."""
        prev_slots = list(self._slots)
        self._slots = []
        for slot in range(self.population):
            t = self._new_trial(unit[slot], budget=self.steps_per_generation * (self.generation + 1))
            t.history = []
            t.params["__inherit_from__"] = None if inherit is None else prev_slots[int(inherit[slot])]
            t.params["__slot__"] = slot
            self._slots.append(t.trial_id)
            self._pending.add(t.trial_id)
            self._dispatch.append(t.trial_id)

    def _pop_dispatch(self, n):
        out = []
        while self._dispatch and len(out) < n:
            t = self.trials[self._dispatch.pop(0)]
            t.status = TrialStatus.RUNNING
            out.append(t)
        return out

    def next_batch(self, n):
        if self.finished():
            return []
        if self._dispatch:
            return self._pop_dispatch(n)
        if self._pending:  # fully dispatched, waiting on this generation
            return []
        if self._unit is None:  # the first generation: the seed's own draw
            self._unit = self._draw_unit((self.seed,), self.population)
            self._spawn_generation(self._unit, None)
            return self._pop_dispatch(n)
        # close the generation: exploit/explore on the host
        draws = self._draw_exploit((self.seed, 1000 + self.generation), self.population,
                                   self.space.dim)
        new_unit, src_idx, _ = apply_exploit_explore(
            torch.from_numpy(self._unit), torch.from_numpy(self._gen_scores),
            self.space.discrete_mask(), self.config, draws,
        )
        self._unit = new_unit.numpy()
        self.generation += 1
        if self.finished():
            return []
        self._spawn_generation(self._unit, src_idx.numpy())
        return self._pop_dispatch(n)

    def report_batch(self, results: Sequence[TrialResult]):
        for r in results:
            if not r.ok:
                # a failed member scores -inf for the generation: it ranks
                # last in the exploit cut and is replaced by a winner's
                # copy (NaN also sorts last, but would poison arithmetic)
                t = self._mark_failed(r)
                self._pending.discard(r.trial_id)
                self._gen_scores[t.params["__slot__"]] = -np.inf
                continue
            t = self.trials[r.trial_id]
            t.record(r.score, r.step)
            t.status = TrialStatus.DONE
            self._pending.discard(r.trial_id)
            self._gen_scores[t.params["__slot__"]] = r.score

    def finished(self):
        return self.generation >= self.generations and not self._pending

    # -- checkpoint -------------------------------------------------------

    def state_dict(self):
        d = super().state_dict()
        d["pbt"] = {
            "generation": self.generation,
            "slots": list(self._slots),
            "gen_scores": self._gen_scores.tolist(),
            "unit": None if self._unit is None else self._unit.tolist(),
            # everything unreported, in slot order, for re-dispatch
            "pending": [t for t in self._slots if t in self._pending],
            # the member metadata the base's re-materialisation drops
            "inherit": {
                str(tid): self.trials[tid].params.get("__inherit_from__")
                for tid in self._slots
                if tid in self.trials
            },
        }
        return d

    def load_state_dict(self, state):
        super().load_state_dict(state)
        p = state["pbt"]
        self.generation = p["generation"]
        self._slots = list(p["slots"])
        self._gen_scores = np.asarray(p["gen_scores"], dtype=np.float32)
        self._unit = None if p["unit"] is None else np.asarray(p["unit"], dtype=np.float32)
        inherit = p.get("inherit", {})
        for slot, tid in enumerate(self._slots):
            if tid in self.trials:
                self.trials[tid].params["__slot__"] = slot
                self.trials[tid].params["__inherit_from__"] = inherit.get(str(tid))
        # in-flight results died with the old process: re-dispatch them
        pending = [int(t) for t in p.get("pending", [])]
        self._pending = set(pending)
        self._dispatch = list(pending)

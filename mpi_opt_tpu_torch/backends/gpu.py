"""The slot-pool population backend (port of ``mpi_opt_tpu/backends/tpu.py``):
trials are rows of one population on the card.

- A device-resident **slot pool**: a ``PopState`` of ``pool_size``
  member slots (params, momentum, step), set up once, lazily. Trials map
  to slots on the host; the states never leave the device.
- ``evaluate(trials)`` runs the WHOLE batch, even one that mixes ASHA
  rungs, as one chain: gather the source states, overwrite the fresh
  members with new inits, ``train_segment_masked`` (each member frozen
  past its own remaining budget), eval, scatter back into the pool, and
  ONE blocking score fetch.
- PBT inheritance (``__inherit_from__``) and ASHA's warm resume are both
  gathers from the pool.
- Slots are recycled least recently used first. Losing a slot is safe:
  budgets are cumulative, so an evicted trial retrains from scratch.

One launch width. The JAX package pads a batch to a power of two; here
the trainer runs every launch at one width for the backend's lifetime:
the member chunk, or without one the population (``launching``). A
batch of any size (ASHA's rung batches differ) then launches the same
shapes, and cuDNN keeps its plans. The padding is the trainer's
stand-ins, whose results are dropped; nothing padded is scattered back.

Under a ``('pop', 'data')`` mesh (``mesh=``, ``parallel/mesh.py``) the
slot pool shards over the ranks' ``pop`` axis (its slot count rounded
up to a multiple of the axis), every rank runs the same host plan, a
batch is padded to a multiple of the axis with frozen stand-ins that are
never written back, and the gather and the scatter move only the rows
another rank holds (``Mesh.exchange``). Scores come back gathered, so
every rank returns the same results.

Random numbers. Batch k (counting only batches that evaluate
something) draws from generators seeded from (seed, 9000 + k, 0) for the
fresh inits and (seed, 9000 + k, 1) for training, on the device; the
pool's initial states from (seed, 7001). No generator runs across
batches, so ``reset()`` replays a search bit for bit.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from mpi_opt_tpu_torch.algorithms.base import path_generator
from mpi_opt_tpu_torch.backends.base import Backend, register_backend
from mpi_opt_tpu_torch.device import resolve_device
from mpi_opt_tpu_torch.trial import Trial, TrialResult, failed_result


@register_backend
class GPUPopulationBackend(Backend):
    name = "gpu"

    def __init__(self, workload, population: int = 32, seed: int = 0, member_chunk: int = 0,
                 mesh=None, device=None):
        if not hasattr(workload, "make_trainer"):
            raise ValueError(
                f"workload {getattr(workload, 'name', workload)!r} has no population protocol "
                "(make_trainer/make_hparams/data)"
            )
        super().__init__(workload)
        self.population = population
        self.seed = seed
        self.member_chunk = member_chunk
        self.device = resolve_device(device)
        self.mesh = mesh
        # a batch (<= capacity == population trials) pins its sources and
        # allocates its outputs, at most 2 * population slots, so no
        # pinned slot is ever evicted; +1 scratch slot, the source of
        # fresh members
        self.pool_size = 2 * population + 1
        if mesh is not None:
            # a pool the 'pop' axis does not divide would be replicated
            # on every rank: round up (extra slots are just free slots)
            n_pop = mesh.shape["pop"]
            self.pool_size = -(-self.pool_size // n_pop) * n_pop
        self._scratch = self.pool_size - 1
        self._setup_done = False
        self._step_counter = 0
        self._slot_of: "OrderedDict[int, int]" = OrderedDict()  # trial_id -> slot, LRU order
        self._trained: dict[int, int] = {}  # trial_id -> steps completed

    @property
    def capacity(self) -> int:
        return self.population

    @property
    def launch_width(self) -> int:
        """Members every launch runs."""
        return self.member_chunk if self.member_chunk > 0 else self.population

    # -- lazy device setup ------------------------------------------------

    def _setup(self):
        if self._setup_done:
            return
        from mpi_opt_tpu_torch.train.common import workload_arrays

        trainer, self._space, self._train_x, self._train_y, self._val_x, self._val_y = (
            workload_arrays(self.workload, self.member_chunk, self.device, self.mesh))
        self._trainer = trainer.launching(self.launch_width)
        self._pool = self._trainer.init_population(
            path_generator((self.seed, 7001), self.device), self.pool_size)
        self._free = [s for s in range(self.pool_size) if s != self._scratch]
        self._setup_done = True

    # -- slot management --------------------------------------------------

    def _alloc_slot(self, trial_id: int, pinned: set[int]) -> int:
        if self._free:
            slot = self._free.pop()
        else:
            # evict the least recently used UNPINNED trial; slots the
            # in-flight batch reads are pinned: evicting one mid-plan
            # would turn a warm resume into an under-trained fresh init
            for old_id, cand in self._slot_of.items():  # LRU order
                if cand not in pinned:
                    slot = cand
                    del self._slot_of[old_id]
                    self._trained.pop(old_id, None)
                    break
            else:  # unreachable: sources + outputs <= 2 * population
                raise AssertionError("slot pool exhausted by a single batch")
        self._slot_of[trial_id] = slot
        return slot

    # -- evaluation --------------------------------------------------------

    def evaluate(self, trials: Sequence[Trial]) -> list[TrialResult]:
        self._setup()
        # Phase A: resolve every trial's state source against the CURRENT
        # slot map and pin those slots, so phase B's allocations can never
        # evict a source this batch still reads.
        pinned: set[int] = set()
        resolved = []
        for t in trials:
            src = t.params.get("__inherit_from__")
            if t.trial_id in self._slot_of:  # warm resume
                src_slot, done, fresh = self._slot_of[t.trial_id], self._trained.get(t.trial_id, 0), False
                self._slot_of.move_to_end(t.trial_id)
            elif src is not None and src in self._slot_of:  # PBT exploit copy
                src_slot, done, fresh = self._slot_of[src], self._trained.get(src, 0), False
            else:  # a fresh member, or an evicted lineage: full retrain
                src_slot, done, fresh = self._scratch, 0, True
            pinned.add(src_slot)
            resolved.append((t, src_slot, fresh, done))
        # Phase B: output slots (a resume keeps its own)
        entries = []
        for t, src_slot, fresh, done in resolved:
            if t.trial_id in self._slot_of:
                out_slot = self._slot_of[t.trial_id]
            else:
                out_slot = self._alloc_slot(t.trial_id, pinned)
            pinned.add(out_slot)
            entries.append((t, src_slot, fresh, out_slot, max(0, t.budget - done)))
        results = self._run_batch(entries)
        return [results[t.trial_id] for t in trials]

    def _run_batch(self, entries: list) -> dict[int, TrialResult]:
        """entries: (trial, src_slot, fresh, out_slot, rem) rows; one
        chain of launches and ONE blocking score fetch for the batch."""
        if not entries:
            # an empty batch does not tick the counter: the draw stream's
            # position is a function of the evaluated batches only
            return {}
        t0 = time.perf_counter()
        n = len(entries)
        dev = self.device
        # under a mesh the batch pads to a multiple of the 'pop' axis with
        # frozen stand-ins (the scratch slot's state, no steps), so it
        # shards; nothing padded is scored or written back
        n_pad = n if self.mesh is None else -(-n // self.mesh.shape["pop"]) * self.mesh.shape["pop"]
        pad = n_pad - n
        gather_idx = torch.tensor([e[1] for e in entries] + [self._scratch] * pad,
                                  dtype=torch.int64, device=dev)
        out_slots = torch.tensor([e[3] for e in entries], dtype=torch.int64, device=dev)
        fresh = [e[2] for e in entries] + [False] * pad
        unit = torch.from_numpy(np.stack([np.asarray(e[0].unit, np.float32) for e in entries]
                                         + [np.zeros(self._space.dim, np.float32)] * pad)).to(dev)
        rem_host = [int(e[4]) for e in entries] + [0] * pad
        path = (self.seed, 9000 + self._step_counter)
        self._step_counter += 1

        trainer = self._trainer
        sub = trainer.gather_members(self._pool, gather_idx)
        if any(fresh):  # steady-state resume/inherit batches skip the init
            new = trainer.init_population(path_generator((*path, 0), dev), n_pad)
            sub = trainer.select_members(torch.tensor(fresh, device=dev), new, sub)
        # hparams from the unit rows, as the device path builds them
        hp = self.workload.make_hparams(self._space.from_unit(unit))
        steps = max(rem_host)
        if steps > 0:
            trainer.train_segment_masked(sub, hp, self._train_x, self._train_y,
                                         path_generator((*path, 1), dev), steps,
                                         torch.tensor(rem_host, dtype=torch.int32, device=dev))
        scores = trainer.eval_population(sub, self._val_x, self._val_y)[:n]
        if self.mesh is None:
            _scatter(self._pool, sub, out_slots)
        else:
            self._pool = _scatter_mesh(self.mesh, self._pool, sub, out_slots, self.pool_size)
        scores = np.asarray(scores.cpu(), dtype=np.float64)  # the batch's one host sync
        wall = time.perf_counter() - t0
        out: dict[int, TrialResult] = {}
        for i, (t, _, _, _, _) in enumerate(entries):
            s = float(scores[i])
            if np.isfinite(s):
                self._trained[t.trial_id] = t.budget
                out[t.trial_id] = TrialResult(trial_id=t.trial_id, score=s, step=t.budget,
                                              wall_time=wall / n)
            else:
                # a diverged member reports as failed and its state is
                # EVICTED (slot back on the free list): a driver retry
                # then retrains it from scratch instead of re-evaluating
                # the wreck for zero steps, and no PBT successor inherits it
                slot = self._slot_of.pop(t.trial_id, None)
                if slot is not None:
                    self._free.append(slot)
                self._trained.pop(t.trial_id, None)
                out[t.trial_id] = failed_result(t.trial_id, t.budget,
                                                f"non-finite score {s!r} (member diverged)",
                                                score=s, wall_time=wall / n)
        return out

    def reset(self):
        """Per-search state back to construction time, the pool kept.
        Every later trial resolves as fresh (the slot map is empty), so
        stale pool contents are unreachable; resetting the counter
        restores the draw stream, so a reset backend gives the results
        of a new one, bit for bit."""
        if not self._setup_done:
            return
        self._slot_of.clear()
        self._trained.clear()
        self._free = [s for s in range(self.pool_size) if s != self._scratch]
        self._step_counter = 0

    # -- checkpoint/resume ------------------------------------------------
    #
    # The pool holds every live trial's params and momentum;
    # host_state_dict carries the map that gives it meaning (trial ->
    # slot, steps trained, the batch counter).

    def host_state_dict(self) -> dict:
        if not self._setup_done:
            return {"setup": False}
        return {
            "setup": True,
            "slot_of": list(self._slot_of.items()),  # keeps the LRU order
            "trained": list(self._trained.items()),
            "free": list(self._free),
            "step_counter": self._step_counter,
        }

    def load_host_state_dict(self, state: dict) -> None:
        if not state.get("setup", False):
            return
        self._setup()
        self._slot_of = OrderedDict((int(k), int(v)) for k, v in state["slot_of"])
        self._trained = {int(k): int(v) for k, v in state["trained"]}
        self._free = [int(s) for s in state["free"]]
        self._step_counter = int(state["step_counter"])

    def device_state(self):
        """The slot pool; under a mesh the whole pool, gathered to rank 0
        (the snapshot's writer: every rank joins, the others get None)."""
        if not self._setup_done:
            return None
        if self.mesh is None:
            return self._pool
        from mpi_opt_tpu_torch.train.population import PopState

        full = self._trainer.gather_state(self._pool, root=0)
        return None if full is None else PopState(full["params"], full["momentum"], full["step"])

    def load_device_state(self, pool) -> None:
        """Install a restored pool (host tensors, a ``PopState`` or its
        dict form) on the device, refusing one of another structure,
        slot count or dtype."""
        from mpi_opt_tpu_torch.train.population import PopState

        self._setup()
        if not isinstance(pool, PopState):
            pool = PopState(params=pool["params"], momentum=pool["momentum"], step=pool["step"])
        if self.mesh is not None:
            if pool.step.shape[0] != self.pool_size:
                raise ValueError(
                    f"restored pool leaf shapes do not match this backend's pool (saved slot "
                    f"count {pool.step.shape[0]}, this backend {self.pool_size}: resumed under "
                    "a different population or mesh?)")
            pool = self._trainer.place(pool)  # this rank's slots

        def leaves(st):
            return ([("params", k, v) for k, v in st.params.items()]
                    + [("momentum", k, v) for k, v in st.momentum.items()] + [("step", "", st.step)])

        got, want = leaves(pool), leaves(self._pool)
        if [g[:2] for g in got] != [w[:2] for w in want]:
            raise ValueError("restored pool structure does not match this backend's pool "
                             "(different workload or population?)")
        if [tuple(g[2].shape) for g in got] != [tuple(w[2].shape) for w in want]:
            raise ValueError(
                "restored pool leaf shapes do not match this backend's pool (saved slot count "
                f"{got[0][2].shape[0]}, this backend {want[0][2].shape[0]}: resumed under a "
                "different population?)")
        if [g[2].dtype for g in got] != [w[2].dtype for w in want]:
            raise ValueError(
                "restored pool leaf dtypes do not match this backend's pool (saved under a "
                "different momentum storage dtype? see MPI_OPT_TPU_MOMENTUM_DTYPE)")
        with torch.no_grad():
            for (_, _, dst), (_, _, srcv) in zip(want, got):
                dst.copy_(srcv)


@torch.no_grad()
def _scatter_mesh(mesh, pool, sub, slots: torch.Tensor, pool_size: int):
    """``_scatter`` over a mesh: pool slot ``slots[i]`` takes the batch's
    row ``i``, wherever either lives; other slots keep their rows. One
    ``Mesh.exchange`` with the pool as its base; returns the new pool."""
    from mpi_opt_tpu_torch.train.population import PopState

    src = np.full(pool_size, -1, dtype=np.int64)
    src[slots.cpu().numpy()] = np.arange(slots.shape[0])
    tree = lambda st: {"params": st.params, "momentum": st.momentum, "step": st.step}
    got = mesh.exchange(tree(sub), src, sub.cohort or sub.step.shape[0], base=tree(pool))
    return PopState(got["params"], got["momentum"], got["step"], cohort=pool.cohort)


@torch.no_grad()
def _scatter(pool, sub, slots: torch.Tensor) -> None:
    """Write member states back into their pool slots, in place."""
    for name in ("params", "momentum"):
        dst, src = getattr(pool, name), getattr(sub, name)
        for k in dst:
            dst[k].index_copy_(0, slots, src[k])
    pool.step.index_copy_(0, slots, sub.step)

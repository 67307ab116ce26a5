"""The workload protocols (port of ``mpi_opt_tpu/workloads/base.py``).

- ``Workload``: a tunable task, evaluated one trial at a time
  (``evaluate``), optionally through the stateful pair ``init_state`` /
  ``train`` that PBT inheritance and ASHA's warm resume need. The CPU
  backend (``backends/cpu.py``) runs these.
- ``PopulationWorkload``: a network trained as rows of a population (the
  fused sweeps and the ``gpu`` slot pool), which is also a ``Workload``:
  its ``evaluate`` trains one member from scratch.
"""

from __future__ import annotations

import abc
import os

import torch

# spellings of the momentum storage dtype that ``jnp.dtype`` maps to
# these names in the JAX package
_DTYPE_NAMES = {
    "float32": "float32", "f4": "float32", "f": "float32", "single": "float32",
    "bfloat16": "bfloat16",
    "float16": "float16", "f2": "float16", "e": "float16", "half": "float16",
}


def resolve_momentum_dtype() -> str | None:
    """The momentum storage dtype from ``MPI_OPT_TPU_MOMENTUM_DTYPE``,
    normalised to a dtype name ("f4" -> "float32"), or None when unset
    (momentum matches the f32 parameters). Resolved once, by
    ``make_trainer``."""
    raw = os.environ.get("MPI_OPT_TPU_MOMENTUM_DTYPE")
    if not raw:
        return None
    try:
        return _DTYPE_NAMES[raw]
    except KeyError:
        raise ValueError(
            f"MPI_OPT_TPU_MOMENTUM_DTYPE={raw!r} is not a dtype the port stores "
            f"momentum in; use one of {sorted(_DTYPE_NAMES)}"
        ) from None


class Workload(abc.ABC):
    """A tunable training task.

    Subclasses implement ``default_space`` and at least one of the two
    evaluation protocols; ``evaluate`` defaults to the stateful one.
    """

    name: str = "base"

    @abc.abstractmethod
    def default_space(self):
        ...

    # -- stateful protocol (optional) ---------------------------------------

    def init_state(self, params: dict, seed: int):
        raise NotImplementedError(f"{self.name} has no stateful protocol")

    def train(self, state, params: dict, steps: int, seed: int):
        """Advance training by ``steps``; returns (state, score)."""
        raise NotImplementedError(f"{self.name} has no stateful protocol")

    @property
    def stateful(self) -> bool:
        return type(self).train is not Workload.train

    # -- stateless protocol ---------------------------------------------------

    def evaluate(self, params: dict, budget: int, seed: int) -> float:
        state = self.init_state(params, seed)
        _, score = self.train(state, params, budget, seed)
        return float(score)

    def set_eval_device(self, device) -> None:
        """Where ``evaluate`` trains: a workload that trains tensors takes
        it (the CPU backend asks for ``"cpu"``); a host-only one ignores
        it."""

    # -- multi-objective protocol ---------------------------------------------

    def objective_metrics(self) -> tuple[str, ...]:
        """Metric names ``evaluate_multi`` can produce (empty: scalar only)."""
        return ()

    def evaluate_multi(self, params: dict, budget: int, seed: int, names) -> dict:
        """``{name: float}`` for the requested metric names (each from
        ``objective_metrics``), from one stateless evaluation."""
        raise NotImplementedError(f"{self.name} has no multi-metric eval path")


class PopulationWorkload(Workload):
    """A network trained as rows of a population.

    Subclasses set ``name``, ``dataset``, ``batch_size``, ``augment`` and
    implement ``_model(n_classes, population, device)`` and
    ``default_space()``. They get the population protocol of the fused
    sweeps and the slot pool (``data``/``make_trainer``/``make_hparams``)
    and the per-trial ``evaluate``: one member trained from scratch, on
    ``eval_device`` (the card unless ``set_eval_device`` asks for the
    CPU), with the trainer and the device arrays cached on the instance.
    Its draws: the member's initial weights from a generator seeded from
    the path (seed, 0), training from (seed, 1), where the JAX package
    splits ``jax.random.key(seed)`` in two.
    """

    name: str = "base"
    dataset: str = ""
    batch_size: int = 256
    augment: bool = True
    # synthetic sets are subsettable; fixed-size sets set these to None
    default_n_train: int | None = 16384
    default_n_val: int | None = 2048

    def __init__(self, n_train: int | None = None, n_val: int | None = None):
        self.n_train = n_train if n_train is not None else self.default_n_train
        self.n_val = n_val if n_val is not None else self.default_n_val
        self._data = None
        self.eval_device = None

    def default_space(self):
        raise NotImplementedError

    def set_eval_device(self, device) -> None:
        self.eval_device = device

    def _model(self, n_classes: int, population: int, device):
        raise NotImplementedError

    def data(self) -> dict:
        """Host numpy dict(train_x, train_y, val_x, val_y, n_classes).
        The sizes go to the loader only when set: a fixed-size set (the
        UCI tables) takes none."""
        if self._data is None:
            from mpi_opt_tpu_torch.data import load_dataset

            kwargs = {}
            if self.n_train is not None:
                kwargs = {"n_train": self.n_train, "n_val": self.n_val}
            self._data = load_dataset(self.dataset, **kwargs)
        return self._data

    def make_trainer(self, member_chunk: int = 0, device=None, momentum_dtype: str | None = None):
        from mpi_opt_tpu_torch.train.population import PopulationTrainer

        n_classes = self.data()["n_classes"]
        if momentum_dtype is None:
            momentum_dtype = resolve_momentum_dtype()
        return PopulationTrainer(
            model_fn=lambda population, device: self._model(n_classes, population, device),
            batch_size=self.batch_size,
            augment=self.augment,
            member_chunk=member_chunk,
            device=device,
            momentum_dtype=getattr(torch, momentum_dtype) if momentum_dtype else None,
        )

    def objective_metrics(self) -> tuple[str, ...]:
        """The objective names a multi-objective sweep of this workload
        may name (``train/common.py::POPULATION_METRICS``)."""
        from mpi_opt_tpu_torch.train.common import POPULATION_METRICS

        return POPULATION_METRICS

    def _eval_state(self, params: dict, budget: int, seed: int):
        """One member trained from scratch to ``budget`` steps: (trainer,
        state, val_x, val_y), shared by ``evaluate`` and
        ``evaluate_multi``."""
        from mpi_opt_tpu_torch.algorithms.base import path_generator
        from mpi_opt_tpu_torch.device import resolve_device
        from mpi_opt_tpu_torch.train.common import workload_arrays

        dev = resolve_device(self.eval_device)
        trainer, space, train_x, train_y, val_x, val_y = workload_arrays(self, 0, dev)
        unit = torch.from_numpy(space.params_to_unit(params)[None, :]).to(dev)
        hp = self.make_hparams(space.from_unit(unit))
        state = trainer.init_population(path_generator((seed, 0), dev), 1)
        state, _ = trainer.train_segment(state, hp, train_x, train_y,
                                         path_generator((seed, 1), dev), int(budget))
        return trainer, state, val_x, val_y

    def evaluate(self, params: dict, budget: int, seed: int) -> float:
        trainer, state, val_x, val_y = self._eval_state(params, budget, seed)
        return float(trainer.eval_population(state, val_x, val_y)[0])

    def evaluate_multi(self, params: dict, budget: int, seed: int, names) -> dict:
        """``evaluate``'s training, then the per-member metric columns of
        the fused path (``train.common.eval_population_objectives``), so
        both paths give one objective value."""
        from mpi_opt_tpu_torch.train.common import eval_population_objectives

        trainer, state, val_x, val_y = self._eval_state(params, budget, seed)
        mo = eval_population_objectives(trainer, state, val_x, val_y, tuple(names))
        return {name: float(mo[0, j]) for j, name in enumerate(names)}

    def make_hparams(self, values: dict):
        from mpi_opt_tpu_torch.train.population import OptHParams

        zeros = torch.zeros_like(values["lr"])
        return OptHParams(
            lr=values["lr"],
            momentum=values["momentum"],
            weight_decay=values["weight_decay"],
            flip_prob=values.get("flip_prob", zeros),
            shift=values.get("shift", zeros),
        )

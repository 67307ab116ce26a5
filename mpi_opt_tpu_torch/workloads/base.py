"""The population workload protocol (port of ``mpi_opt_tpu/workloads/base.py``)."""

from __future__ import annotations

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


class PopulationWorkload:
    """A network trained as rows of a population.

    Subclasses set ``name``, ``dataset``, ``batch_size``, ``augment`` and
    implement ``_model(n_classes, population, device)`` and
    ``default_space()``.
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

    def default_space(self):
        raise NotImplementedError

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

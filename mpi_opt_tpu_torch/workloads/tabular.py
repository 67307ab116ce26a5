"""Config 4's workload (port of ``mpi_opt_tpu/workloads/tabular.py``):
surrogate-model sweeps on UCI tabular data.

``BASELINE.json`` config 4, "Vectorized TPE acquisition, 256-trial
surrogate-model sweep on UCI tabular": a small MLP (hidden 64, batch
128, no augmentation) over the standardised features of
``breast_cancer`` (or ``wine``), tuned over lr, momentum and weight
decay. Trials are cheap, so the acquisition's share of the sweep is the
interesting half.

The trainer folds members into channels of NHWC images, so the rows
``[N, F]`` reach it as ``[N, 1, 1, F]``: the MLP's flatten (H, W, C
order) then gives each row's F features in order, as flax's reshape
does.
"""

from __future__ import annotations

import math

from mpi_opt_tpu_torch.models import MLP
from mpi_opt_tpu_torch.space import LogUniform, SearchSpace, Uniform
from mpi_opt_tpu_torch.workloads import register
from mpi_opt_tpu_torch.workloads.base import PopulationWorkload


@register
class TabularMLP(PopulationWorkload):
    name = "tabular_mlp"
    dataset = "breast_cancer"
    batch_size = 128
    augment = False
    default_n_train = None  # the UCI sets have fixed sizes
    default_n_val = None
    hidden = 64
    datasets = ("breast_cancer", "wine")  # the classification sets it takes

    def __init__(self, dataset: str | None = None):
        super().__init__()
        dataset = self.dataset if dataset is None else dataset
        if dataset not in self.datasets:
            raise ValueError(
                f"{self.name} supports classification sets {'/'.join(self.datasets)}, "
                f"got {dataset!r}"
            )
        self.dataset = dataset

    def data(self) -> dict:
        """The loader's arrays with the feature rows as ``[N, 1, 1, F]``
        images (views: the loader's cache is untouched)."""
        if self._data is None:
            d = dict(super().data())
            for k in ("train_x", "val_x"):
                d[k] = d[k].reshape(d[k].shape[0], 1, 1, -1)
            self._data = d
        return self._data

    def _model(self, n_classes, population, device):
        n_in = math.prod(self.data()["train_x"].shape[1:])
        return MLP(n_in, hidden=self.hidden, n_classes=n_classes, population=population,
                   device=device)

    def default_space(self) -> SearchSpace:
        return SearchSpace(
            {
                "lr": LogUniform(1e-4, 1.0),
                "momentum": Uniform(0.0, 0.99),
                "weight_decay": LogUniform(1e-7, 1e-1),
            }
        )

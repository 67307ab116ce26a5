"""Config 8's workload (port of ``DigitsMLP`` in
``mpi_opt_tpu/workloads/digits.py``): a small MLP over scikit-learn's
8x8 digits features (hidden 32, batch 128, no augmentation), tuned over
lr, momentum and weight decay. Weight decay moves the effective
parameter count, so accuracy against params is a real trade-off for a
multi-objective sweep (``BENCH_ALL.json`` config 8). The table ships
with the port (``data/uci/digits.csv.gz``).

The digits estimator workload (``DigitsLogReg``, scikit-learn's
``LogisticRegression``) belongs to the driver path and is not ported.
"""

from __future__ import annotations

from mpi_opt_tpu_torch.workloads import register
from mpi_opt_tpu_torch.workloads.tabular import TabularMLP


@register
class DigitsMLP(TabularMLP):
    name = "digits_mlp"
    dataset = "digits"
    hidden = 32
    datasets = ("digits",)

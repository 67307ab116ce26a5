"""Vision workloads of the port (``mpi_opt_tpu/workloads/vision.py``)."""

from __future__ import annotations

import math

from mpi_opt_tpu_torch.models import MLP, ResNet18, SmallCNN
from mpi_opt_tpu_torch.space import LogUniform, SearchSpace, Uniform
from mpi_opt_tpu_torch.workloads import register
from mpi_opt_tpu_torch.workloads.base import PopulationWorkload


class _VisionWorkload(PopulationWorkload):
    def default_space(self) -> SearchSpace:
        return SearchSpace(
            {
                "lr": LogUniform(1e-3, 1.0),
                "momentum": Uniform(0.5, 0.99),
                "weight_decay": LogUniform(1e-6, 1e-2),
                "flip_prob": Uniform(0.0, 0.5),
                "shift": Uniform(0.0, 4.0),
            }
        )


@register
class FashionMLP(_VisionWorkload):
    """Config 2: 2-layer MLP on (synthetic) Fashion-MNIST."""

    name = "fashion_mlp"
    dataset = "fashion_mnist"

    def _model(self, n_classes, population, device):
        n_in = math.prod(self.data()["train_x"].shape[1:])
        return MLP(n_in, hidden=128, n_classes=n_classes, population=population, device=device)


@register
class Cifar10CNN(_VisionWorkload):
    """Config 3: SmallCNN on (synthetic) CIFAR-10, the PBT target of the
    north-star sweep, at width 32 as the JAX workload."""

    name = "cifar10_cnn"
    dataset = "cifar10"
    width = 32

    def _model(self, n_classes, population, device):
        return SmallCNN(n_classes=n_classes, width=type(self).width, population=population, device=device)


@register
class Cifar100CNN(Cifar10CNN):
    """The SmallCNN at width 64 on (synthetic) CIFAR-100."""

    name = "cifar100_cnn"
    dataset = "cifar100"
    width = 64


@register
class Cifar100ResNet18(_VisionWorkload):
    """ResNet-18 on (synthetic) CIFAR-100. ``width`` scales every stage
    (64 is the real model, ~11.2M parameters a member)."""

    name = "cifar100_resnet18"
    dataset = "cifar100"
    batch_size = 128

    def __init__(self, n_train=None, n_val=None, width: int = 64):
        super().__init__(n_train=n_train, n_val=n_val)
        self.width = width

    def _model(self, n_classes, population, device):
        return ResNet18(n_classes=n_classes, width=self.width, population=population, device=device)

"""Models of the port, in population form."""

from mpi_opt_tpu_torch.models.cnn import SmallCNN
from mpi_opt_tpu_torch.models.mlp import MLP
from mpi_opt_tpu_torch.models.resnet import ResNet, ResNet18

__all__ = ["MLP", "ResNet", "ResNet18", "SmallCNN"]

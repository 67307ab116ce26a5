"""Models of the port, in population form."""

from mpi_opt_tpu_torch.models.resnet import ResNet, ResNet18

__all__ = ["ResNet", "ResNet18"]

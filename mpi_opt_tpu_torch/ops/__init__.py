"""Decision ops and the GroupNorm kernels of the port."""

from mpi_opt_tpu_torch.ops.common import rank_descending
from mpi_opt_tpu_torch.ops.group_norm import group_norm_relu
from mpi_opt_tpu_torch.ops.pbt import PBTConfig, pbt_exploit_explore

__all__ = ["rank_descending", "group_norm_relu", "PBTConfig", "pbt_exploit_explore"]

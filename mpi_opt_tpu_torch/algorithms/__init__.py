"""Search-algorithm helpers of the port (``mpi_opt_tpu/algorithms/``):
Hyperband's bracket plan and the best-pick rule the fused drivers
share. The host algorithms themselves are not ported yet."""

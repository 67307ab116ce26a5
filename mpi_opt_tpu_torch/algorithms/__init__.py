"""Search-algorithm helpers of the port (``mpi_opt_tpu/algorithms/``):
Hyperband's bracket plan, the best-pick rule the fused drivers share,
and BOHB's observation store. The host algorithms themselves are not
ported yet."""

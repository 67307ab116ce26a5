"""Observability of the port (``mpi_opt_tpu/obs/``):

- ``trace``: span tracing (``span``/``traced``/``configure``), which
  costs nothing when no sink is configured;
- ``report``: the ``trace`` subcommand's attribution (merge by ``ts``,
  per-phase wall, achieved TF/s, time to first trial);
- ``bubbles``: device-idle gaps by cause, staging overlap and the
  roofline verdict;
- ``memory``: device-memory readings from the CUDA caching allocator.
- ``events``: the event/span name registry, the metrics stream's
  schema (the tables ``lint``'s ``event-registry`` check reads).
"""

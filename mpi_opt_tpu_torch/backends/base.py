"""The execution-backend plugin layer (port of the jax-free
``mpi_opt_tpu/backends/base.py``, copied so that the port imports
nothing of the JAX package): the ``backend=`` hook through which the
search driver evaluates suggested trials. ``capacity`` tells the driver
how many trials to ask for a batch; the slot-pool backend reports its
population, so the driver feeds it device-shaped batches.
"""

from __future__ import annotations

import abc
from typing import Sequence

from mpi_opt_tpu_torch.trial import Trial, TrialResult

_BACKENDS: dict[str, type] = {}


def register_backend(cls):
    _BACKENDS[cls.name] = cls
    return cls


def get_backend(name: str, workload, **kwargs) -> "Backend":
    try:
        cls = _BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; available: {sorted(_BACKENDS)}") from None
    return cls(workload, **kwargs)


def available_backends() -> list[str]:
    return sorted(_BACKENDS)


class Backend(abc.ABC):
    name: str = "base"

    def __init__(self, workload):
        self.workload = workload

    @property
    @abc.abstractmethod
    def capacity(self) -> int:
        """Preferred evaluation batch size."""

    @abc.abstractmethod
    def evaluate(self, trials: Sequence[Trial]) -> list[TrialResult]:
        """Run each trial to its budget; return its result, in order.

        Trials may carry ``params['__inherit_from__']`` (PBT weight
        inheritance) and cumulative budgets (ASHA promotions); a stateful
        backend honours both. One trial failing must not poison the
        batch: a diverging trial comes back as a non-ok ``TrialResult``
        (``trial.failed_result``), never as a raised exception, so the
        driver's ``FailurePolicy`` can retry or report it.
        """

    def close(self) -> None:
        pass

    def reset(self) -> None:
        """Forget all per-search state, as a freshly constructed backend
        (minus the set-up already paid). A backend serves ONE search at a
        time: trial ids restart at 0 for every algorithm, so a second
        search on a used stateful backend would warm-resume the first
        one's states. Call this between searches that share a backend."""

    # -- checkpoint/resume (utils/checkpoint.py::SearchCheckpointer) ------
    #
    # Losing a trial's trained state is always correct: budgets are
    # cumulative, so a resumed trial whose state is gone retrains from
    # scratch to its budget (slower, never wrong).

    def host_state_dict(self) -> dict:
        """JSON-able host-side state (slot map, counters)."""
        return {}

    def load_host_state_dict(self, state: dict) -> None:
        pass

    def device_state(self):
        """Device-resident state worth persisting (None if stateless)."""
        return None

    def load_device_state(self, pool) -> None:
        raise NotImplementedError(f"{self.name} backend has no device state")

"""Workload registry of the port: ``get_workload(name, **kwargs)``."""

_REGISTRY: dict[str, type] = {}


def register(cls):
    _REGISTRY[cls.name] = cls
    return cls


def get_workload(name: str, **kwargs):
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown workload {name!r}; available: {sorted(_REGISTRY)}") from None
    return cls(**kwargs)


from mpi_opt_tpu_torch.workloads import (  # noqa: E402,F401  (registers)
    chaos,
    digits,
    synthetic,
    tabular,
    vision,
)

__all__ = ["register", "get_workload"]

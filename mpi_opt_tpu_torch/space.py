"""Search-space definition, array-first (port of ``mpi_opt_tpu/space.py``).

Every domain maps to and from the unit cube, so a population's
hyperparameters are one ``float32[n, d]`` tensor on the device. The maps
run in float32 like the JAX package's, and ``spec``/``space_hash`` give
the same bytes, so a ledger written by either package names the same
space.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Mapping, Sequence

import numpy as np
import torch


def _plain(v):
    """One value -> a plain JSON scalar (bool/int/float/str/None), repr
    for anything exotic; bool first, since it is an int."""
    if isinstance(v, (bool, str)) or v is None:
        return v
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    return repr(v)


class Domain:
    """One hyperparameter's domain: a map between [0, 1] and its values."""

    def from_unit(self, u: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def to_unit(self, v: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def materialize(self, v: Any):
        """A scalar tensor element -> the Python-typed value."""
        return float(v)

    @property
    def discrete(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class Uniform(Domain):
    low: float
    high: float

    def __post_init__(self):
        if not self.low < self.high:
            raise ValueError(f"Uniform requires low < high, got [{self.low}, {self.high}]")

    def from_unit(self, u):
        return self.low + (self.high - self.low) * u

    def to_unit(self, v):
        return (v - self.low) / (self.high - self.low)


@dataclasses.dataclass(frozen=True)
class LogUniform(Domain):
    low: float
    high: float

    def __post_init__(self):
        if self.low <= 0 or self.high <= 0:
            raise ValueError("LogUniform bounds must be positive")
        if not self.low < self.high:
            raise ValueError(f"LogUniform requires low < high, got [{self.low}, {self.high}]")

    def from_unit(self, u):
        lo, hi = np.log(self.low), np.log(self.high)
        # the bounds enter as float32 scalars, as in the JAX package
        # (numpy float64 scalars are canonicalised to float32 there)
        return torch.exp(float(np.float32(lo)) + float(np.float32(hi - lo)) * u)

    def to_unit(self, v):
        lo, hi = np.log(self.low), np.log(self.high)
        return (torch.log(v) - float(np.float32(lo))) / float(np.float32(hi - lo))


@dataclasses.dataclass(frozen=True)
class IntUniform(Domain):
    low: int
    high: int  # inclusive

    def __post_init__(self):
        if not self.low <= self.high:
            raise ValueError(f"IntUniform requires low <= high, got [{self.low}, {self.high}]")

    def from_unit(self, u):
        n = self.high - self.low + 1
        return self.low + torch.clamp(torch.floor(u * n), 0, n - 1)

    def to_unit(self, v):
        n = self.high - self.low + 1
        # centre of the bucket, so from_unit(to_unit(v)) == v
        return ((v - self.low) + 0.5) / n

    def materialize(self, v):
        return int(v)

    @property
    def discrete(self):
        return True


@dataclasses.dataclass(frozen=True)
class Choice(Domain):
    options: tuple

    def __init__(self, options: Sequence[Any]):
        object.__setattr__(self, "options", tuple(options))

    def from_unit(self, u):
        n = len(self.options)
        return torch.clamp(torch.floor(u * n), 0, n - 1)

    def to_unit(self, v):
        # v is the option INDEX (use SearchSpace.params_to_unit for values)
        return (v + 0.5) / len(self.options)

    def value_to_index(self, value) -> int:
        for i, opt in enumerate(self.options):
            if opt is value or (type(opt) is type(value) and opt == value):
                return i
        raise ValueError(f"{value!r} is not one of {self.options}")

    def materialize(self, v):
        return self.options[int(v)]

    @property
    def discrete(self):
        return True


class SearchSpace:
    """An ordered mapping name -> Domain; the unit-cube layout is
    ``float32[..., d]`` in insertion order."""

    def __init__(self, domains: Mapping[str, Domain]):
        self.domains = dict(domains)
        self.names = list(self.domains.keys())

    @property
    def dim(self) -> int:
        return len(self.names)

    def sample_unit(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """Uniform sample in the unit cube: ``float32[n, d]`` on the
        generator's device."""
        return torch.rand(
            (n, self.dim), generator=generator, dtype=torch.float32,
            device=generator.device,
        )

    def sample(self, generator: torch.Generator, n: int) -> dict[str, torch.Tensor]:
        """n uniform points as typed value tensors (``from_unit`` of a
        ``sample_unit`` draw)."""
        return self.from_unit(self.sample_unit(generator, n))

    def from_unit(self, u) -> dict[str, torch.Tensor]:
        """Unit-cube ``[..., d]`` -> dict of typed value tensors, all in
        float32 (a float64 input is rounded to float32 FIRST, so a
        restored host row maps to the same values as the device path)."""
        u = torch.as_tensor(u, dtype=torch.float32)
        return {
            name: dom.from_unit(u[..., i])
            for i, (name, dom) in enumerate(self.domains.items())
        }

    def to_unit(self, values: Mapping[str, Any]) -> torch.Tensor:
        """Dict of device-representation values -> unit cube ``[..., d]``
        (for Choice the option index; see ``params_to_unit``)."""
        cols = [
            self.domains[name].to_unit(torch.as_tensor(values[name], dtype=torch.float32))
            for name in self.names
        ]
        return torch.stack(cols, dim=-1)

    def params_to_unit(self, params: Mapping[str, Any]) -> np.ndarray:
        """Typed-value params dict (one point) -> unit-cube row (host)."""
        row = np.zeros(self.dim, dtype=np.float32)
        for i, (name, dom) in enumerate(self.domains.items()):
            v = params[name]
            if isinstance(dom, Choice):
                v = dom.value_to_index(v)
            row[i] = float(dom.to_unit(torch.tensor(float(v), dtype=torch.float32)))
        return row

    def materialize_row(self, u_row) -> dict[str, Any]:
        """One unit-cube row -> a plain-Python hparam dict (host side)."""
        u = torch.as_tensor(np.asarray(u_row), dtype=torch.float32).cpu()
        return {
            name: dom.materialize(dom.from_unit(u[i]))
            for i, (name, dom) in enumerate(self.domains.items())
        }

    def discrete_mask(self) -> np.ndarray:
        """bool[d]: which dims are discrete (PBT resamples those)."""
        return np.array([d.discrete for d in self.domains.values()])

    def spec(self) -> list[dict]:
        """JSON-able description of the space, in dimension order: the
        space's durable identity, byte-equal to the JAX package's."""
        out = []
        for name, dom in self.domains.items():
            d: dict[str, Any] = {"name": name, "kind": type(dom).__name__}
            for f in dataclasses.fields(dom):
                v = getattr(dom, f.name)
                d[f.name] = [_plain(o) for o in v] if isinstance(v, tuple) else _plain(v)
            out.append(d)
        return out

    def space_hash(self) -> str:
        """Stable short digest of ``spec()``."""
        payload = json.dumps(self.spec(), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def canonical_params(self, params: Mapping[str, Any]) -> dict[str, Any]:
        """One hparam dict -> its canonical JSON-able form, byte-equal to
        the JAX package's: keys restricted to this space's dimensions in
        insertion order (``__``-prefixed plumbing keys dropped), values
        plain JSON scalars, so the same point serialises to the same
        bytes live from ``materialize_row`` or back from a ledger."""
        missing = [n for n in self.names if n not in params]
        if missing:
            raise KeyError(f"params missing dimensions {missing} of {self.names}")
        return {name: _plain(params[name]) for name in self.names}

    def params_key(self, params: Mapping[str, Any]) -> str:
        """Canonical exact-match key for one point."""
        return json.dumps(self.canonical_params(params), sort_keys=True)

    def __repr__(self):
        inner = ", ".join(f"{k}={v}" for k, v in self.domains.items())
        return f"SearchSpace({inner})"

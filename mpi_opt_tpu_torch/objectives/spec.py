"""ObjectiveSpec: named objectives, directions, constraint bounds (port of
``mpi_opt_tpu/objectives/spec.py``).

The spec is the durable contract of a multi-objective sweep, as
``SearchSpace.spec()`` is for the search space: parsed once from the
CLI, carried in the ledger header beside ``space_spec`` and in the
snapshot config, and handed to the fused drivers.

Syntax (``--objectives``)::

    accuracy:max,params:min<=2e4,latency:min

One comma-separated item per objective: ``name[:direction][OP bound]``.
``direction`` is ``max`` (default) or ``min``; the optional constraint
operator must agree with the direction (``>=`` for max, ``<=`` for
min): a bounded objective is feasible when it is at least as good as
its bound.

Normalization: the ranking in ``objectives/pareto.py`` works in
*maximize form*, the scores multiplied by per-objective signs (+1 max,
-1 min), the bounds mapped the same way (feasible iff normalized value
>= normalized bound). The first objective is primary: ``scalarize``
returns its normalized value, which vector records journal as their
scalar ``score``.

``normalize`` and ``scalarize`` take numpy arrays (the host-side winner
pick) or torch tensors; a tensor comes back on its own device and dtype,
the signs taken from a per-device cache, so the boundary ops copy
nothing from the host after the first call.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

_DIRECTIONS = ("max", "min")

#: one constraint clause, shared with ``report --best-under``
_CONSTRAINT_RE = re.compile(r"^\s*([A-Za-z_][\w.-]*)\s*(<=|>=)\s*([^\s]+)\s*$")

# (signs, device, dtype) -> the signs as a tensor there: a host-to-device
# copy of a pageable array waits for the stream, so it is made once
_SIGNS_ON_DEVICE: dict = {}


@dataclasses.dataclass(frozen=True)
class Objective:
    """One named objective: a direction and an optional feasibility bound.

    ``bound`` is in raw metric units; feasibility is direction-aware
    (``max``: value >= bound, ``min``: value <= bound).
    """

    name: str
    direction: str = "max"
    bound: float | None = None

    def __post_init__(self):
        if not self.name or not re.match(r"^[A-Za-z_][\w.-]*$", self.name):
            raise ValueError(f"bad objective name: {self.name!r}")
        if self.direction not in _DIRECTIONS:
            raise ValueError(
                f"objective {self.name!r}: direction must be max|min, got {self.direction!r}"
            )
        if self.bound is not None and not np.isfinite(self.bound):
            raise ValueError(f"objective {self.name!r}: bound must be finite")

    @property
    def sign(self) -> float:
        return 1.0 if self.direction == "max" else -1.0


@dataclasses.dataclass(frozen=True)
class ObjectiveSpec:
    """An ordered tuple of objectives; the first is primary."""

    objectives: tuple[Objective, ...]

    def __post_init__(self):
        if len(self.objectives) < 1:
            raise ValueError("objective spec needs at least one objective")
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")

    # -- identity ----------------------------------------------------

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(o.name for o in self.objectives)

    @property
    def m(self) -> int:
        return len(self.objectives)

    @property
    def has_bounds(self) -> bool:
        return any(o.bound is not None for o in self.objectives)

    def index(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(f"unknown objective {name!r}; spec has {list(self.names)}") from None

    # -- durable form (ledger header, checkpoint config) -------------

    def spec(self) -> list:
        """Plain-data form for the ledger header (beside ``space_spec``)."""
        out = []
        for o in self.objectives:
            d = {"name": o.name, "direction": o.direction}
            if o.bound is not None:
                d["bound"] = float(o.bound)
            out.append(d)
        return out

    @classmethod
    def from_spec(cls, spec: list) -> "ObjectiveSpec":
        return cls(objectives=tuple(
            Objective(name=str(d["name"]), direction=str(d.get("direction", "max")),
                      bound=None if d.get("bound") is None else float(d["bound"]))
            for d in spec
        ))

    # -- CLI syntax --------------------------------------------------

    @classmethod
    def parse(cls, text: str) -> "ObjectiveSpec":
        """Parse ``"accuracy:max,params:min<=2e4"`` (see module doc)."""
        objs = []
        for raw in text.split(","):
            item = raw.strip()
            if not item:
                raise ValueError(f"empty objective in {text!r}")
            bound = None
            op = None
            m = re.search(r"(<=|>=)", item)
            if m:
                op = m.group(1)
                item, bound_text = item[: m.start()], item[m.end():]
                try:
                    bound = float(bound_text)
                except ValueError:
                    raise ValueError(
                        f"bad bound {bound_text!r} in objective {raw.strip()!r}"
                    ) from None
            item = item.strip()
            if ":" in item:
                name, direction = item.split(":", 1)
                name, direction = name.strip(), direction.strip()
            else:
                name, direction = item, "max"
            if op is not None:
                want = ">=" if direction == "max" else "<="
                if op != want:
                    raise ValueError(
                        f"objective {name!r}: constraint operator {op!r} "
                        f"contradicts direction {direction!r} (use {want!r}: "
                        "a bound means 'at least this good')"
                    )
            objs.append(Objective(name=name, direction=direction, bound=bound))
        return cls(objectives=tuple(objs))

    # -- maximize-form transforms ------------------------------------

    def signs(self) -> np.ndarray:
        return np.asarray([o.sign for o in self.objectives], dtype=np.float32)

    def _signs_like(self, scores: torch.Tensor) -> torch.Tensor:
        key = (tuple(o.sign for o in self.objectives), str(scores.device), scores.dtype)
        signs = _SIGNS_ON_DEVICE.get(key)
        if signs is None:
            signs = _SIGNS_ON_DEVICE[key] = torch.as_tensor(
                self.signs(), device=scores.device).to(scores.dtype)
        return signs

    def normalize(self, scores):
        """Raw ``[..., m]`` scores -> maximize form (numpy in, numpy out;
        a tensor in, a tensor on its device and dtype out)."""
        if isinstance(scores, torch.Tensor):
            return scores * self._signs_like(scores)
        return scores * self.signs()

    def norm_bounds(self) -> np.ndarray:
        """Maximize-form bounds, ``-inf`` where unconstrained (every
        finite value is feasible against ``-inf``)."""
        out = np.full((self.m,), -np.inf, dtype=np.float32)
        for j, o in enumerate(self.objectives):
            if o.bound is not None:
                out[j] = o.sign * o.bound
        return out

    def scalarize(self, scores):
        """Normalized primary objective: the scalar ``score`` vector
        records journal (higher is better by construction)."""
        return scores[..., 0] * self.objectives[0].sign


def parse_constraint(text: str) -> tuple[str, str, float]:
    """Parse one ``report --best-under`` clause: ``"params<=2e4"`` ->
    ``("params", "<=", 20000.0)``."""
    m = _CONSTRAINT_RE.match(text)
    if not m:
        raise ValueError(f"bad constraint {text!r}; expected NAME<=VALUE or NAME>=VALUE")
    name, op, val = m.group(1), m.group(2), m.group(3)
    try:
        value = float(val)
    except ValueError:
        raise ValueError(f"bad constraint value {val!r} in {text!r}") from None
    return name, op, value

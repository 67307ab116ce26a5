"""torch-discipline checkers: random streams, host syncs in the hot path.

The port's counterpart of ``mpi_opt_tpu/analysis/checkers_jax.py``,
under the same two ids, so that both packages' ``lint --json`` list the
same checks in the same order.

- **key-reuse** — a random stream that is not the one the sweep's seed
  gives. Every draw of the port takes an explicit ``torch.Generator``
  seeded from the sweep's seed, and the wave/resident bit identity
  rests on it. Three shapes are findings:

  - a draw with no ``generator=`` keyword (``torch.rand``/``randn``/
    ``randint``/``randperm``/``normal``/``bernoulli``/``multinomial``/
    ``poisson``, the ``*_like`` draws, the in-place ``uniform_``/
    ``normal_``/``bernoulli_``/``random_``/``exponential_``/
    ``geometric_``/``cauchy_``/``log_normal_``): it draws from torch's
    global generator, which any other caller in the process advances;
  - global seeding (``torch.manual_seed``, ``torch.cuda.manual_seed``,
    ``torch.cuda.manual_seed_all``, ``torch.random.manual_seed``);
  - the same seed NAME fed to two ``manual_seed`` calls with no
    intervening rebind: two generators seeded alike give one stream
    twice, correlating draws that every algorithm assumes independent.
    As in the JAX checker, each straight-line statement list is judged
    on its own (no cross-branch joins), so an if/else that each seed
    once never false-positives.

- **host-sync** — ``.item()`` / ``.tolist()`` / ``.cpu()`` /
  ``.numpy()`` / ``.synchronize()`` (a tensor's, ``torch.cuda``'s, an
  ``Event``'s or a ``Stream``'s) / ``.to("cpu")`` / ``np.asarray``
  inside the fused hot-path modules (``train/fused_*.py``,
  ``train/staging.py``) block the host on the device and serialize the
  dispatch pipeline. Boundary code MUST sync (scores must reach the
  host to exploit/journal): those functions carry an explicit
  ``# sweeplint: barrier(reason)`` on their ``def`` line, which exempts
  the function's DIRECT body; nested defs are judged on their own, so a
  helper nested inside an annotated host loop stays protected. One sync
  line can carry the annotation on itself or the line above.
"""

from __future__ import annotations

import ast

from mpi_opt_tpu_torch.analysis.core import Checker, FileContext

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

# -- key-reuse -----------------------------------------------------------

#: ``torch.<name>(...)`` draws that take a ``generator=`` keyword
_TORCH_DRAWS = frozenset(
    {
        "rand",
        "randn",
        "randint",
        "randperm",
        "normal",
        "bernoulli",
        "multinomial",
        "poisson",
        "rand_like",
        "randn_like",
        "randint_like",
    }
)
#: in-place draws, on any tensor (and ``nn.init``'s spellings)
_INPLACE_DRAWS = frozenset(
    {
        "uniform_",
        "normal_",
        "bernoulli_",
        "random_",
        "exponential_",
        "geometric_",
        "cauchy_",
        "log_normal_",
    }
)
#: the modules whose ``manual_seed`` seeds a process-wide generator
_GLOBAL_SEED_BASES = frozenset({"torch", "torch.cuda", "torch.random"})
_SEEDERS = frozenset({"manual_seed", "manual_seed_all"})


def _dotted(node) -> str:
    """``a.b.c`` for a Name/Attribute chain, else ''."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(node.id)
    return ".".join(reversed(parts))


def _global_draw(call: ast.Call):
    """The spelling of a draw from torch's global generator, else None.
    A ``**kwargs`` splat may carry the generator, so it is not judged."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    if any(kw.arg == "generator" or kw.arg is None for kw in call.keywords):
        return None
    if fn.attr in _TORCH_DRAWS and _dotted(fn.value) == "torch":
        return f"torch.{fn.attr}"
    if fn.attr in _INPLACE_DRAWS:
        return f".{fn.attr}()"
    return None


def _global_seed(call: ast.Call):
    """``torch.manual_seed``-style calls that seed a global generator."""
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr in _SEEDERS:
        base = _dotted(fn.value)
        if base in _GLOBAL_SEED_BASES:
            return f"{base}.{fn.attr}"
    return None


def _seed_name(call: ast.Call):
    """The seed variable name a generator's ``manual_seed`` consumes,
    else None. Conservative: only ``<gen>.manual_seed(<Name>)`` shapes
    count (a computed seed expression is skipped rather than guessed
    about), and the global seeders are judged by their own rule."""
    fn = call.func
    if not (isinstance(fn, ast.Attribute) and fn.attr == "manual_seed"):
        return None
    if _global_seed(call) is not None:
        return None
    if call.args and isinstance(call.args[0], ast.Name):
        return call.args[0].id
    return None


def _bound_names(stmt):
    """Names (re)bound by one statement: assignment targets, for/with
    bindings, walrus — anything that makes a seed name FRESH again."""
    targets = []
    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign, ast.For, ast.AsyncFor)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        targets = [i.optional_vars for i in stmt.items if i.optional_vars]
    out = set()
    for t in targets:
        for sub in ast.walk(t):
            if isinstance(sub, ast.Name):
                out.add(sub.id)
    # walrus anywhere in the statement's expressions
    for sub in ast.walk(stmt):
        if isinstance(sub, ast.NamedExpr) and isinstance(sub.target, ast.Name):
            out.add(sub.target.id)
    return out


def _stmt_seeds(stmt):
    """Generator seedings in ``stmt``'s OWN expressions, in source order
    — not in nested statements (an if/else's arms are separate regions;
    counting both arms here would false-positive a perfectly balanced
    branch pair) and not in nested function defs."""
    found = []
    stack = list(ast.iter_child_nodes(stmt))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.stmt, ast.Lambda)):
            continue  # nested statements are their own region
        if isinstance(node, ast.Call):
            name = _seed_name(node)
            if name is not None:
                found.append((node.lineno, node.col_offset, name))
        stack.extend(ast.iter_child_nodes(node))
    return sorted(found)


class KeyReuseChecker(Checker):
    id = "key-reuse"
    hint = (
        "draw from the sweep's own torch.Generator (generator=gen), "
        "seeded once from the sweep's seed; give each stream its own seed"
    )
    interests = _FUNC_NODES + (ast.Module, ast.Call)

    def visit(self, node, ctx: FileContext) -> None:
        if isinstance(node, ast.Call):
            draw = _global_draw(node)
            if draw is not None:
                self.report(
                    ctx,
                    node,
                    f"{draw} without generator= draws from torch's global "
                    "generator — not the sweep's seeded stream",
                )
            seeder = _global_seed(node)
            if seeder is not None:
                self.report(
                    ctx,
                    node,
                    f"{seeder} seeds a process-wide generator — every "
                    "draw must come from an explicit torch.Generator",
                )
            return
        # every statement LIST in this scope is one straight-line region
        # (if/else arms, loop bodies, try blocks each stand alone);
        # nested function defs are their own visit.
        for region in self._regions(node):
            seeded: dict = {}
            for stmt in region:
                for lineno, _col, name in _stmt_seeds(stmt):
                    if name in seeded:
                        self.report(
                            ctx,
                            lineno,
                            f"seed {name!r} fed to manual_seed again (first "
                            f"use line {seeded[name]}) with no intervening "
                            "rebind — two generators, one stream",
                        )
                    else:
                        seeded[name] = lineno
                for name in _bound_names(stmt):
                    seeded.pop(name, None)

    def _regions(self, scope):
        stack = [scope]
        while stack:
            node = stack.pop()
            for fieldname in ("body", "orelse", "finalbody"):
                body = getattr(node, fieldname, None)
                if isinstance(body, list) and body:
                    yield body
                    for ch in body:
                        if not isinstance(ch, (*_FUNC_NODES, ast.Lambda)):
                            stack.append(ch)
            for handler in getattr(node, "handlers", ()) or ():
                yield handler.body
                for ch in handler.body:
                    if not isinstance(ch, (*_FUNC_NODES, ast.Lambda)):
                        stack.append(ch)


# -- host-sync -----------------------------------------------------------

_SYNC_ATTRS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})


def _is_cpu_device(node) -> bool:
    return (
        isinstance(node, ast.Constant)
        and isinstance(node.value, str)
        and node.value.split(":")[0] == "cpu"
    )


def _sync_kind(call: ast.Call):
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    if fn.attr in _SYNC_ATTRS and not call.args:
        return f".{fn.attr}()"
    if fn.attr == "to" and (
        (call.args and _is_cpu_device(call.args[0]))
        or any(kw.arg == "device" and _is_cpu_device(kw.value) for kw in call.keywords)
    ):
        return '.to("cpu")'
    if fn.attr == "asarray" and isinstance(fn.value, ast.Name):
        if fn.value.id in ("np", "numpy"):
            return "np.asarray"
    return None


class HostSyncChecker(Checker):
    id = "host-sync"
    severity = "error"
    hint = (
        "hot-path code must stay async; if this IS boundary/host code, "
        "annotate the def line: # sweeplint: barrier(reason)"
    )
    interests = _FUNC_NODES + (ast.Module,)

    def interested(self, ctx: FileContext) -> bool:
        p = ctx.path.replace("\\", "/")
        name = p.rsplit("/", 1)[-1]
        return "train/" in p and (
            name.startswith("fused_") or name == "staging.py"
        )

    def _annotated_barrier(self, fn, ctx: FileContext) -> bool:
        start = fn.lineno
        for dec in getattr(fn, "decorator_list", ()):
            start = min(start, dec.lineno)
        end = fn.body[0].lineno if fn.body else fn.lineno
        return any(ln in ctx.barriers for ln in range(start, end + 1))

    def visit(self, node, ctx: FileContext) -> None:
        if isinstance(node, _FUNC_NODES) and self._annotated_barrier(node, ctx):
            return
        for call in self._direct_calls(node):
            kind = _sync_kind(call)
            if kind is None:
                continue
            # line-level barrier: one-off sync lines can be annotated
            # without exempting the whole function
            if call.lineno in ctx.barriers or call.lineno - 1 in ctx.barriers:
                continue
            self.report(
                ctx,
                call,
                f"{kind} forces a host sync in a fused hot-path module — "
                "only annotated barrier functions may block on the device",
            )

    @staticmethod
    def _direct_calls(scope):
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            node = stack.pop()
            if isinstance(node, (*_FUNC_NODES, ast.Lambda)):
                continue
            if isinstance(node, ast.Call):
                yield node
            stack.extend(ast.iter_child_nodes(node))

"""event-registry: every literal event/span name is registered.

The port's copy of ``mpi_opt_tpu/analysis/checkers_registry.py``. The
registry TABLES live in the port's ``obs/events.py`` (the metrics-stream
schema's home, equal to the JAX package's tables), the AST mechanics
here with the other checkers; ``obs.events.scan_call_sites``/``lint``
are thin shims over them.

Emitter shapes gated (same rules as the original scanner):

- kind "event": ``*.log("name", ...)`` (attribute call only — bench.py's
  bare ``log(msg)`` stderr helper is not an emitter),
  ``notify("name", ...)`` in both spellings, ``_event("name", ...)``;
- kind "span": ``span("name", ...)`` / ``trace.span(...)`` /
  ``@traced("name")``.

Non-literal first arguments are skipped (re-emission helpers forward a
variable on purpose).
"""

from __future__ import annotations

import ast

from mpi_opt_tpu_torch.analysis.core import Checker, FileContext


def callee_kind(fn) -> str:
    """"event"/"span"/"" for a call's func node (the one home for the
    emitter-shape convention; obs.events re-exports it)."""
    if isinstance(fn, ast.Attribute):
        name, is_attr = fn.attr, True
    elif isinstance(fn, ast.Name):
        name, is_attr = fn.id, False
    else:
        return ""
    if name == "log" and is_attr:
        return "event"
    if name in ("notify", "_event"):
        return "event"
    if name in ("span", "traced"):
        return "span"
    return ""


def call_site(node: ast.Call):
    """(kind, name) when ``node`` is a registered-emitter call with a
    literal first argument, else None."""
    if not node.args:
        return None
    first = node.args[0]
    if not (isinstance(first, ast.Constant) and isinstance(first.value, str)):
        return None
    kind = callee_kind(node.func)
    return (kind, first.value) if kind else None


class EventRegistryChecker(Checker):
    id = "event-registry"
    hint = "register the name in obs/events.py (EVENTS, SPANS or SPAN_ATTRS)"
    interests = (ast.Call,)

    def __init__(self):
        super().__init__()
        # imported lazily-late so the checker module stays importable
        # even while obs/ is being refactored under it
        from mpi_opt_tpu_torch.obs.events import EVENTS, SPAN_ATTRS, SPANS

        self._tables = {"event": EVENTS, "span": SPANS}
        self._span_attrs = SPAN_ATTRS

    def visit(self, node, ctx: FileContext) -> None:
        site = call_site(node)
        if site is None:
            return
        kind, name = site
        if name not in self._tables[kind]:
            table = "EVENTS" if kind == "event" else "SPANS"
            self.report(
                ctx,
                node,
                f"unregistered {kind} name {name!r} — add it to "
                f"obs/events.py {table}",
            )
        if kind != "span":
            return
        # span ATTR keys are schema too (the trace/diff CLIs key on
        # them): every literal keyword at a span call site must be in
        # SPAN_ATTRS. **attrs forwarding (kw.arg is None) is a
        # re-emission helper and is skipped, same rule as non-literal
        # names above.
        for kw in node.keywords:
            if kw.arg is not None and kw.arg not in self._span_attrs:
                self.report(
                    ctx,
                    node,
                    f"unregistered span attr {kw.arg!r} on span {name!r} — "
                    "add it to obs/events.py SPAN_ATTRS",
                )

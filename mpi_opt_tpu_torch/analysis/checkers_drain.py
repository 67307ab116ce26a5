"""drain-swallow: except clauses that eat the graceful-drain signal.

The preemption protocol only works if ``SweepInterrupted`` —
raised at a drain point AFTER durable state flushed — propagates all
the way to the CLI's catch, which maps it to exit 75. The same goes for
``KeyboardInterrupt`` (the interactive escalation). A handler that
catches either (explicitly, or via bare ``except:`` /
``except BaseException:``) and does not re-raise turns a platform
preemption into a silent continue: the sweep keeps running, the
supervisor SIGKILLs it mid-checkpoint, and the whole drain machinery is
bypassed. This checker makes it a lint failure.

A handler passes when its body contains a ``raise`` (bare or explicit)
anywhere — containment-then-reraise is the launch supervisor's cleanup
idiom and is exactly right. Deliberate terminal swallows (a scheduler
containing a tenant slice, a transfer thread surfacing errors through
``drain()``) carry a ``# sweeplint: disable=drain-swallow`` with the
one-line reason.
"""

from __future__ import annotations

import ast

from mpi_opt_tpu_torch.analysis.core import Checker, FileContext

#: exception names whose capture-without-reraise kills the protocol.
#: Exception is NOT here: SweepInterrupted is a RuntimeError, so
#: `except Exception` does technically catch it, but flagging every
#: generic handler would drown the suite in noise — the CLI's own
#: retry/containment handlers are `except Exception` by design and
#: re-raise non-transient errors.
_DRAIN_NAMES = frozenset({"SweepInterrupted", "KeyboardInterrupt", "BaseException"})


def _caught_names(handler: ast.ExceptHandler):
    t = handler.type
    if t is None:
        yield "<bare>"
        return
    parts = t.elts if isinstance(t, ast.Tuple) else [t]
    for p in parts:
        if isinstance(p, ast.Name):
            yield p.id
        elif isinstance(p, ast.Attribute):
            yield p.attr


def _reraises(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
    return False


def _is_protocol_endpoint(handler: ast.ExceptHandler) -> bool:
    """The ONE legitimate terminal catch: the CLI's mapper that turns
    the drain into exit EX_TEMPFAIL. Recognized by the handler body
    referencing the constant — anything that maps the drain to the
    protocol's own exit code has, by definition, not swallowed it."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Name) and node.id == "EX_TEMPFAIL":
            return True
        if isinstance(node, ast.Attribute) and node.attr == "EX_TEMPFAIL":
            return True
    return False


class DrainSwallowChecker(Checker):
    id = "drain-swallow"
    hint = (
        "re-raise (the drain must reach the CLI's exit-75 catch), or "
        "mark the deliberate swallow with a disable + reason"
    )
    interests = (ast.ExceptHandler,)

    def visit(self, node, ctx: FileContext) -> None:
        caught = set(_caught_names(node))
        hit = caught & _DRAIN_NAMES or ("<bare>" in caught and {"<bare>"})
        if not hit or _reraises(node) or _is_protocol_endpoint(node):
            return
        what = sorted(hit)[0]
        label = "bare except:" if what == "<bare>" else f"except {what}"
        self.report(
            ctx,
            node,
            f"{label} swallows the graceful-drain signal "
            "(SweepInterrupted/KeyboardInterrupt) without re-raising",
        )

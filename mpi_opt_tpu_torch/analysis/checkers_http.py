"""http-handler-contained: HTTP handler methods answer, never raise.

The front door's serving contract (service/http.py): a bug in a
``do_*`` handler must cost ONE typed 500 answer, never the serving
thread — stdlib ``ThreadingHTTPServer`` logs an uncaught handler
exception to stderr and drops the connection, which from the client
side is indistinguishable from a torn network and from the operator
side is a silent capacity leak. So the contract is structural, and this
checker makes it machine-checked the way drain-swallow does the drain
contract:

every ``do_*`` method of a class whose base names end in
``RequestHandler`` must have a body that is exactly one
``try`` statement (after the docstring) whose handlers include an
``except Exception`` (or bare ``except``) — the shape that guarantees
the typed-error answer path sees every failure. Code before the try,
code after it, or a try that can only catch narrower types all leave a
raise path straight into the server plumbing and are flagged.
"""

from __future__ import annotations

import ast

from mpi_opt_tpu_torch.analysis.core import Checker, FileContext


def _is_handler_class(node: ast.ClassDef) -> bool:
    """A class serving HTTP requests: any base whose dotted name ends
    in "RequestHandler" (BaseHTTPRequestHandler and kin; a project
    subclass-of-a-subclass must keep the suffix in its base's name for
    this textual test to see it — the repo convention)."""
    for base in node.bases:
        name = ""
        if isinstance(base, ast.Name):
            name = base.id
        elif isinstance(base, ast.Attribute):
            name = base.attr
        if name.endswith("RequestHandler"):
            return True
    return False


def _catches_exception(try_node: ast.Try) -> bool:
    """Does any handler of this try catch Exception (or everything)?"""
    for h in try_node.handlers:
        if h.type is None:  # bare except
            return True
        types = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
        for t in types:
            name = ""
            if isinstance(t, ast.Name):
                name = t.id
            elif isinstance(t, ast.Attribute):
                name = t.attr
            if name in ("Exception", "BaseException"):
                return True
    return False


class HttpHandlerChecker(Checker):
    id = "http-handler-contained"
    hint = (
        "wrap the whole do_* body in one try/except Exception that "
        "answers a typed error (service/http.py contract: a handler "
        "raise must answer, never kill the serving thread)"
    )
    interests = (ast.ClassDef,)

    def visit(self, node, ctx: FileContext) -> None:
        if not _is_handler_class(node):
            return
        for item in node.body:
            if not isinstance(item, ast.FunctionDef):
                continue
            if not item.name.startswith("do_"):
                continue
            body = list(item.body)
            # a leading docstring is fine; it can't raise
            if body and isinstance(body[0], ast.Expr) and isinstance(
                body[0].value, ast.Constant
            ) and isinstance(body[0].value.value, str):
                body = body[1:]
            if len(body) != 1 or not isinstance(body[0], ast.Try):
                self.report(
                    ctx,
                    item,
                    f"handler {node.name}.{item.name} has statements "
                    "outside its containment try — the body must be "
                    "exactly one try/except Exception",
                )
                continue
            if not _catches_exception(body[0]):
                self.report(
                    ctx,
                    item,
                    f"handler {node.name}.{item.name}'s try never "
                    "catches Exception — a handler bug would escape "
                    "into the server plumbing instead of answering a "
                    "typed 500",
                )

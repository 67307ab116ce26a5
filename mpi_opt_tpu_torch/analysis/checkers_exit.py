"""exit-code: exit-code literals outside ``utils/exitcodes``.

Three layers classify the sweep's exit codes (CLI producing them,
launch supervisor restart policy, service tenant state machine), so
the literals live in ``utils/exitcodes.py`` alone: bare 75s/65s kept in
sync by hand across them drift apart. The
invariant: a REGISTERED code (0/1/2/65/69/75) appears as an integer
literal only in ``utils/exitcodes.py`` — everywhere else it must be the
named constant, both in exit calls (``sys.exit(75)``,
``SystemExit(65)``, ``os._exit(75)``) and in classification comparisons
(``rc == 75``). Unregistered codes (a chaos drill's ``os._exit(13)``)
are not this contract's business and pass.
"""

from __future__ import annotations

import ast

import re

from mpi_opt_tpu_torch.analysis.core import Checker, FileContext

#: the registered contract codes (utils/exitcodes.py). 0 and 1 are
#: deliberately NOT flagged: `return 0`/`exit(1)` literals are the
#: universal unix idiom and carry no cross-layer protocol meaning the
#: named constants exist to protect (65/75/2 do).
CONTRACT_CODES = frozenset({2, 65, 69, 75})

_EXIT_CALLEES = frozenset({"exit", "_exit", "SystemExit"})

#: variable shapes that mean "this integer is an exit code" in a
#: comparison (returncode covers subprocess handles; `.code` covers
#: SystemExit instances)
_RC_NAME = re.compile(r"\b(rc|ret|returncode|exit_?code|code|status)\b", re.I)


def _exit_callee(fn) -> bool:
    if isinstance(fn, ast.Attribute):
        return fn.attr in _EXIT_CALLEES
    if isinstance(fn, ast.Name):
        return fn.id in _EXIT_CALLEES
    return False


class ExitCodeChecker(Checker):
    id = "exit-code"
    hint = "import the named constant from mpi_opt_tpu_torch.utils.exitcodes"
    interests = (ast.Call, ast.Compare)

    def interested(self, ctx: FileContext) -> bool:
        # the one home for the literals; the table itself must hold them
        return not ctx.path.endswith("utils/exitcodes.py")

    def visit(self, node, ctx: FileContext) -> None:
        if isinstance(node, ast.Call):
            if not (_exit_callee(node.func) and node.args):
                return
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and arg.value in CONTRACT_CODES:
                self.report(
                    ctx,
                    node,
                    f"exit-code literal {arg.value} in an exit call — the "
                    "contract codes live in utils/exitcodes",
                )
            return
        # rc == 75 / rc != 65 classification comparisons: the exact
        # drift utils/exitcodes.classify() exists to end. Gated on the
        # OTHER operand naming an exit code (`rc`, `returncode`,
        # `exit_code`, `e.code`) — a bare `len(x) == 2` is not this
        # contract's business
        operands = [node.left, *node.comparators]
        literal = None
        for comparand in operands:
            if (
                isinstance(comparand, ast.Constant)
                and type(comparand.value) is int
                and comparand.value in CONTRACT_CODES
            ):
                literal = comparand.value
        if literal is None:
            return
        others = " ".join(
            ast.unparse(c) for c in operands if not isinstance(c, ast.Constant)
        )
        if _RC_NAME.search(others):
            self.report(
                ctx,
                node,
                f"exit-code literal {literal} compared against an exit "
                "code — use utils/exitcodes constants (or classify())",
            )

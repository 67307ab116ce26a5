"""coord-write: agreement files are written ONLY by parallel/coord.py.

The multi-process SPMD argument that every rank-divergent
decision is unanimous before the next collective rests on the vote/
decide protocol's atomicity: ``O_EXCL`` vote creates (a duplicate vote
is a protocol error, not a race winner), ``O_EXCL`` decision publishes
(the first file is what every peer read), single-use epochs. An
agreement file touched any other way — a supervisor "helpfully"
unlinking stale votes while ranks are mid-barrier, a test scribbling a
decision with ``json.dump`` — silently reintroduces exactly the split
decisions the plane exists to prevent, and nothing would fail until
two ranks actually diverged at a boundary. This checker makes that a
lint error instead, the same fence ``lease-write`` puts around the
lease protocol.

What is flagged, outside ``parallel/coord.py``:

- ``open(<coord-ish>, "w"/"a"/...)`` — any write/append/update mode;
- ``os.open(<coord-ish>, ...)`` — the O_EXCL path is plane-only too;
- ``os.replace``/``os.rename`` with a coord-ish operand (votes and
  decisions are never renamed by anyone but the plane's primitives);
- ``os.unlink``/``os.remove`` of a coord-ish path (cleanup is
  ``coord.reset_dir``; a bare unlink under live readers is the
  stale-READY race the epoch protocol closes).

"Coord-ish" is judged lexically and conservatively: a string constant
containing ``vote.json`` / ``decision.json``, or an identifier (name,
attribute, string path segment) whose ``coord``/``coords`` appears as
a whole ``_``-delimited word — so ``coord_dir``, ``args.coord_dir``,
``"run/coord"`` all match while ``coordinator`` (the process
group's address plumbing) and ``coordinates`` never do. Reads stay free:
status surfaces may inspect votes at will.
"""

from __future__ import annotations

import ast
import re

from mpi_opt_tpu_torch.analysis.core import Checker, FileContext

#: `coord` / `coords` as a whole word inside an identifier's
#: underscore-split (or at a dotted/word boundary): `coord_dir` yes,
#: `args.coord` yes (attr == "coord"), `coordinator`/`coordinates` no
_COORD_WORD = re.compile(r"(?:^|_)coords?(?:_|$)")

#: the plane's file-name suffixes; a constant carrying one IS an
#: agreement path regardless of what the variable around it is called
_COORD_FILES = ("vote.json", "decision.json")


def _coord_ident(name: str) -> bool:
    return bool(_COORD_WORD.search(name))


def _mentions_coord(node) -> bool:
    """Does this expression lexically name an agreement path?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            if any(f in sub.value for f in _COORD_FILES) or _coord_ident(sub.value):
                return True
        elif isinstance(sub, ast.Name) and _coord_ident(sub.id):
            return True
        elif isinstance(sub, ast.Attribute) and _coord_ident(sub.attr):
            return True
    return False


def _callee(fn):
    """(module-ish, name) for a call target: os.replace -> ("os",
    "replace"); bare open -> ("", "open")."""
    if isinstance(fn, ast.Attribute):
        base = fn.value.id if isinstance(fn.value, ast.Name) else ""
        return base, fn.attr
    if isinstance(fn, ast.Name):
        return "", fn.id
    return "", ""


_WRITE_MODES = re.compile(r"[wax+]")


class CoordWriteChecker(Checker):
    id = "coord-write"
    hint = (
        "go through parallel/coord.py (agree/reset_dir) — the O_EXCL "
        "vote/decision primitives and single-use epochs are what makes "
        "boundary decisions unanimous"
    )
    interests = (ast.Call,)

    def interested(self, ctx: FileContext) -> bool:
        # the plane's own home is the one legal writer
        return not ctx.path.replace("\\", "/").endswith("parallel/coord.py")

    def visit(self, node, ctx: FileContext) -> None:
        base, name = _callee(node.func)
        if name == "open":
            # open(path, "w"/"a"/"r+"/...) or os.open(path, flags):
            # os.open is always suspicious on an agreement file (its
            # only legitimate coord use IS the plane's O_EXCL create);
            # builtin open only in an explicit write-ish mode
            if not node.args or not _mentions_coord(node.args[0]):
                return
            if base == "os":
                self.report(
                    ctx, node, "os.open of a coord path outside parallel/coord.py"
                )
                return
            mode = None
            if len(node.args) >= 2:
                mode = node.args[1]
            for kw in node.keywords:
                if kw.arg == "mode":
                    mode = kw.value
            if (
                isinstance(mode, ast.Constant)
                and isinstance(mode.value, str)
                and _WRITE_MODES.search(mode.value)
            ):
                self.report(
                    ctx,
                    node,
                    f"open(..., {mode.value!r}) on a coord path outside "
                    "parallel/coord.py",
                )
            return
        if base != "os":
            return
        if name in ("replace", "rename"):
            if any(_mentions_coord(a) for a in node.args[:2]):
                self.report(
                    ctx,
                    node,
                    f"os.{name} involving a coord path outside "
                    "parallel/coord.py (votes/decisions move only "
                    "through the plane's primitives)",
                )
        elif name in ("unlink", "remove"):
            if node.args and _mentions_coord(node.args[0]):
                self.report(
                    ctx,
                    node,
                    f"os.{name} of a coord path outside parallel/coord.py "
                    "(cleanup is coord.reset_dir; a bare unlink under "
                    "live readers races the READY protocol)",
                )

"""lease-write: lease files are written ONLY by service/leases.py.

The fleet-federation argument that double execution is
structurally impossible rests on every lease mutation going through
the atomic helpers — ``O_EXCL`` create, rename-tomb steal/restore,
token-checked tmp+rename refresh. A lease written any other way (a
convenient ``json.dump(lease, open(path, "w"))`` in a future scheduler
refactor) silently re-opens the read-modify-write window the helpers
exist to close, and nothing would fail until two servers actually
raced. This checker makes that a lint error instead.

What is flagged, outside ``service/leases.py``:

- ``open(<lease-ish>, "w"/"a"/...)`` — any write/append/update mode;
- ``os.open(<lease-ish>, ...)`` — the O_EXCL path is helper-only too;
- ``os.replace``/``os.rename`` whose DESTINATION is lease-ish (a
  rename onto a lease file is a lease write; renaming a lease away is
  the tomb protocol, also helper-only — so either operand trips it);
- ``os.unlink``/``os.remove`` of a lease-ish path (release is
  token-checked in the helper; a bare unlink is a fencing bypass).

"Lease-ish" is judged lexically and conservatively: a string constant
containing ``lease.json``, or an identifier (name, attribute, keyword
path segment) whose ``lease``/``leases`` appears as a whole ``_``-
delimited word — so ``t.lease``, ``lease_path``, ``"lease.json"`` all
match while ``release``/``released_jobs`` never do. Reads (plain
``open(path)`` in the default mode, ``_read_json``) stay free: status
and report surfaces may inspect leases at will.
"""

from __future__ import annotations

import ast
import re

from mpi_opt_tpu_torch.analysis.core import Checker, FileContext

#: `lease` / `leases` as a whole word inside an identifier's
#: underscore-split (or at a dotted/word boundary): `lease_path` yes,
#: `t.lease` yes (attr == "lease"), `release`/`released` no
_LEASE_WORD = re.compile(r"(?:^|_)leases?(?:_|$)")


def _lease_ident(name: str) -> bool:
    return bool(_LEASE_WORD.search(name))


def _mentions_lease(node) -> bool:
    """Does this expression lexically name a lease path?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            if "lease.json" in sub.value or _lease_ident(sub.value):
                return True
        elif isinstance(sub, ast.Name) and _lease_ident(sub.id):
            return True
        elif isinstance(sub, ast.Attribute) and _lease_ident(sub.attr):
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


class LeaseWriteChecker(Checker):
    id = "lease-write"
    hint = (
        "go through service/leases.py (acquire/refresh/release) — the "
        "atomic, token-checked helpers are what makes exactly-one-"
        "claimant true"
    )
    interests = (ast.Call,)

    def interested(self, ctx: FileContext) -> bool:
        # the helpers' own home is the one legal writer
        return not ctx.path.replace("\\", "/").endswith("service/leases.py")

    def visit(self, node, ctx: FileContext) -> None:
        base, name = _callee(node.func)
        if name == "open":
            # open(path, "w"/"a"/"r+"/...) or os.open(path, flags):
            # os.open is always suspicious on a lease (its only
            # legitimate lease use IS the helper's O_EXCL create);
            # builtin open only in an explicit write-ish mode
            if not node.args or not _mentions_lease(node.args[0]):
                return
            if base == "os":
                self.report(
                    ctx, node, "os.open of a lease path outside service/leases.py"
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
                    f"open(..., {mode.value!r}) on a lease path outside "
                    "service/leases.py",
                )
            return
        if base != "os":
            return
        if name in ("replace", "rename"):
            if any(_mentions_lease(a) for a in node.args[:2]):
                self.report(
                    ctx,
                    node,
                    f"os.{name} involving a lease path outside "
                    "service/leases.py (the tomb protocol is helper-only)",
                )
        elif name in ("unlink", "remove"):
            if node.args and _mentions_lease(node.args[0]):
                self.report(
                    ctx,
                    node,
                    f"os.{name} of a lease path outside service/leases.py "
                    "(release is token-checked; bare unlink bypasses the fence)",
                )

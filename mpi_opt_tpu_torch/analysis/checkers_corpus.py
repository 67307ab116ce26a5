"""corpus-index-write: index files are written ONLY by corpus/index.py.

The corpus index is derived state read by ``--warm-start auto:``
resolution while sweeps run concurrently — a TORN index (half a JSON
document behind an ``open(path, "w")``) would make a sweep silently
resolve against half a corpus, the exact quiet-failure class the
atomic ``write_index`` helper (tmp + fsync + rename) exists to close.
This checker is the lease-write pattern (checkers_lease.py)
applied to the corpus: any index write outside the helper's home
module is a lint error, so a future refactor cannot re-open the
read-a-partial-document window and have nothing fail until a sweep
races an indexer.

What is flagged, outside ``corpus/index.py``:

- ``open(<index-ish>, "w"/"a"/...)`` — any write/append/update mode;
- ``os.open(<index-ish>, ...)`` — flag-driven writes included;
- ``os.replace``/``os.rename`` whose either operand is index-ish (a
  rename ONTO the index is an index write; renaming it away would be a
  tomb protocol this file does not have — both are helper-only);
- ``os.unlink``/``os.remove`` of an index-ish path (deleting the index
  out from under a resolving sweep is also a write to its state).

"Index-ish" is judged lexically and conservatively, mirroring the
lease checker: a string constant containing ``corpus-index`` (the
on-disk name) or an identifier whose underscore-split words contain
the ``corpus_index`` pair — so ``corpus-index.json``,
``corpus_index_path`` match while ``index``, ``reindex`` and every
ordinary use of the word never do. Reads stay free: resolution and
the report surfaces may inspect the index at will.
"""

from __future__ import annotations

import ast
import re

from mpi_opt_tpu_torch.analysis.core import Checker, FileContext

#: `corpus_index` as adjacent whole words inside an identifier's
#: underscore-split: `corpus_index`, `corpus_index_path` yes;
#: `index`, `corpus`, `corpus_reindex` no
_INDEX_WORD = re.compile(r"(?:^|_)corpus_index(?:_|$)")


def _index_ident(name: str) -> bool:
    return bool(_INDEX_WORD.search(name))


def _mentions_index(node) -> bool:
    """Does this expression lexically name a corpus-index path?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            if "corpus-index" in sub.value or _index_ident(sub.value):
                return True
        elif isinstance(sub, ast.Name) and _index_ident(sub.id):
            return True
        elif isinstance(sub, ast.Attribute) and _index_ident(sub.attr):
            return True
    return False


def _callee(fn):
    if isinstance(fn, ast.Attribute):
        base = fn.value.id if isinstance(fn.value, ast.Name) else ""
        return base, fn.attr
    if isinstance(fn, ast.Name):
        return "", fn.id
    return "", ""


_WRITE_MODES = re.compile(r"[wax+]")


class CorpusIndexWriteChecker(Checker):
    id = "corpus-index-write"
    hint = (
        "go through corpus/index.py (write_index: tmp + fsync + atomic "
        "rename) — a torn index makes --warm-start auto: resolve half "
        "a corpus"
    )
    interests = (ast.Call,)

    def interested(self, ctx: FileContext) -> bool:
        # the atomic helper's own home is the one legal writer
        return not ctx.path.replace("\\", "/").endswith("corpus/index.py")

    def visit(self, node, ctx: FileContext) -> None:
        base, name = _callee(node.func)
        if name == "open":
            if not node.args or not _mentions_index(node.args[0]):
                return
            if base == "os":
                self.report(
                    ctx,
                    node,
                    "os.open of a corpus-index path outside corpus/index.py",
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
                    f"open(..., {mode.value!r}) on a corpus-index path "
                    "outside corpus/index.py",
                )
            return
        if base != "os":
            return
        if name in ("replace", "rename"):
            if any(_mentions_index(a) for a in node.args[:2]):
                self.report(
                    ctx,
                    node,
                    f"os.{name} involving a corpus-index path outside "
                    "corpus/index.py (atomic updates are helper-only)",
                )
        elif name in ("unlink", "remove"):
            if node.args and _mentions_index(node.args[0]):
                self.report(
                    ctx,
                    node,
                    f"os.{name} of a corpus-index path outside "
                    "corpus/index.py (deleting the index under a "
                    "resolving sweep is a write to its state)",
                )

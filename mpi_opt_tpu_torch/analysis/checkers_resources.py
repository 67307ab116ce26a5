"""resource-funnel: resource-exhaustion handling outside the classifier.

The port's counterpart of ``mpi_opt_tpu/analysis/checkers_resources.py``,
retargeted at CUDA's errors. ``utils/resources.py`` funnels the two
scale-out failure classes: a CUDA out-of-memory error becomes typed
``DeviceOOM`` (wave backoff / classified exit 74) and ENOSPC/EDQUOT
becomes ``StorageFull`` (prune-then-park). The funnel only holds if
nothing ELSE quietly grows its own handling: an ad-hoc ``except
torch.cuda.OutOfMemoryError`` swallow or an ``"out of memory" in
str(e)`` probe in a driver would bypass the backoff and the exit-code
contract, and a bare ``errno.ENOSPC`` comparison would re-inline the
storage classification the spool/checkpoint layers ask
``is_storage_full`` about. Flagged shapes (outside utils/resources.py):

- an ``except`` clause or ``isinstance`` check naming
  ``OutOfMemoryError`` (``torch.cuda.OutOfMemoryError``,
  ``torch.OutOfMemoryError``) or ``AcceleratorError`` (catch/ask the
  classified ``DeviceOOM`` instead);
- an ``"out of memory"`` string literal used in a COMPARISON (``in`` /
  ``==`` probes, any case: the ad-hoc swallow shape; docstrings and
  messages merely mentioning the words are not handling and pass);
- ``errno.ENOSPC`` / ``errno.EDQUOT`` references (attribute or
  from-import): the storage-exhaustion predicate is
  ``resources.is_storage_full``.
"""

from __future__ import annotations

import ast

from mpi_opt_tpu_torch.analysis.core import Checker, FileContext

_CUDA_ERROR_NAMES = frozenset({"OutOfMemoryError", "AcceleratorError"})
_STORAGE_ERRNO_NAMES = frozenset({"ENOSPC", "EDQUOT"})
#: held in a constant (not inline) so this checker's own source does
#: not carry the literal-in-a-Compare shape it flags
_OOM_TOKEN = "out of memory"


def _names_cuda_error(expr) -> bool:
    """Does this type expression (possibly a tuple) name a raw CUDA
    runtime error class?"""
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and node.id in _CUDA_ERROR_NAMES:
            return True
        if isinstance(node, ast.Attribute) and node.attr in _CUDA_ERROR_NAMES:
            return True
    return False


class ResourceFunnelChecker(Checker):
    id = "resource-funnel"
    hint = (
        "classify through mpi_opt_tpu_torch.utils.resources "
        "(is_device_oom/is_storage_full, DeviceOOM/StorageFull, oom_funnel)"
    )
    interests = (ast.ExceptHandler, ast.Call, ast.Compare, ast.Attribute, ast.ImportFrom)

    def interested(self, ctx: FileContext) -> bool:
        # the one home for the raw markers; the classifier itself must
        # hold them
        return not ctx.path.endswith("utils/resources.py")

    def visit(self, node, ctx: FileContext) -> None:
        if isinstance(node, ast.ExceptHandler):
            if node.type is not None and _names_cuda_error(node.type):
                self.report(
                    ctx,
                    node,
                    "except clause names the raw CUDA runtime error — "
                    "catch the classified DeviceOOM (utils/resources) "
                    "so the OOM funnel/backoff is not bypassed",
                )
            return
        if isinstance(node, ast.Call):
            fn = node.func
            is_isinstance = (
                isinstance(fn, ast.Name) and fn.id == "isinstance"
            )
            if is_isinstance and any(_names_cuda_error(a) for a in node.args[1:]):
                self.report(
                    ctx,
                    node,
                    "isinstance check against the raw CUDA runtime error — "
                    "ask utils.resources.is_device_oom (type gate "
                    "included) instead of re-deriving the classification",
                )
            return
        if isinstance(node, ast.Compare):
            for operand in (node.left, *node.comparators):
                if (
                    isinstance(operand, ast.Constant)
                    and isinstance(operand.value, str)
                    and _OOM_TOKEN in operand.value.lower()
                ):
                    self.report(
                        ctx,
                        node,
                        f"{_OOM_TOKEN!r} message probe — ad-hoc OOM "
                        "classification belongs in utils/resources "
                        "(is_device_oom)",
                    )
                    return
            return
        if isinstance(node, ast.Attribute):
            if node.attr in _STORAGE_ERRNO_NAMES and isinstance(
                node.value, ast.Name
            ) and node.value.id == "errno":
                self.report(
                    ctx,
                    node,
                    f"errno.{node.attr} literal — the storage-exhaustion "
                    "predicate is utils.resources.is_storage_full",
                )
            return
        if isinstance(node, ast.ImportFrom):
            if node.module == "errno":
                for alias in node.names:
                    if alias.name in _STORAGE_ERRNO_NAMES:
                        self.report(
                            ctx,
                            node,
                            f"imports errno.{alias.name} — the storage-"
                            "exhaustion predicate is "
                            "utils.resources.is_storage_full",
                        )

"""Durability-contract checkers: journal ordering, rank gating, atomic
status writes, ledger fsync.

These four encode the crash-safety contracts of the ledger and the
snapshots:

- **journal-order** — a fused boundary's ledger records journal BEFORE
  that boundary's snapshot saves (``ledger/store.py`` docstring: the
  only append-kill shape is then a torn FINAL boundary, which resume
  self-heals; a snapshot covering an unjournaled boundary is
  unrecoverable divergence).
- **ledger-gate** — ``SweepLedger`` is constructed with an explicit
  ``read_only=`` decision outside the ledger package itself. Under
  multi-process SPMD every rank runs the same loop; N ranks
  fsync-appending one journal interleave records and corrupt it, so
  construction must always state which side of the rank-0 gate it is on
  (the CLI's gate sites pass ``read_only=rank != 0``).
- **atomic-write** — durable JSON state (status, heartbeat, spool,
  results) is written tmp+``os.replace``, never ``open(path, "w")``
  directly: a reader (watchdog, scheduler, report) must never see a
  torn record, and a crash mid-write must not destroy the previous one.
- **ledger-fsync** — every append to a ledger's file handle fsyncs in
  the same function (the fsync-before-report invariant: a journal that
  can lag its snapshot is not a journal).
"""

from __future__ import annotations

import ast

from mpi_opt_tpu_torch.analysis.core import Checker, FileContext

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)
_LOOP_NODES = (ast.For, ast.AsyncFor, ast.While)


def _callee_name(fn) -> str:
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _direct_calls(scope):
    """Call nodes lexically in ``scope``'s body, NOT descending into
    nested function/lambda definitions — a nested ``def save_now()``
    deferred to a boundary callback is its own scope, and attributing
    its calls to the parent would misjudge both."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        if isinstance(node, (*_FUNC_NODES, ast.Lambda)):
            continue
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


# -- journal-order -------------------------------------------------------

#: snapshot-save callee names at the fused drivers' layer (the
#: checkpointer surface: utils/checkpoint.py SweepCheckpointer +
#: population-sweep/wave variants)
_SAVE_NAMES = frozenset(
    {"save", "save_sweep", "save_population_sweep", "save_wave_sweep"}
)


class JournalOrderChecker(Checker):
    id = "journal-order"
    hint = (
        "journal the boundary's member records (journal_boundary) "
        "before its snapshot save in the same region"
    )
    interests = _FUNC_NODES

    def visit(self, node, ctx: FileContext) -> None:
        # judge each straight-line region independently: the nearest
        # enclosing loop body (one region per loop — the per-boundary
        # iteration is what the ordering contract is ABOUT), else the
        # function body itself. Cross-region pairs (a mid-generation
        # drain snapshot before a later loop's journal) are not
        # boundary-ordering violations.
        regions: dict = {}

        def region_of(path):
            for anc in reversed(path):
                if isinstance(anc, _LOOP_NODES):
                    return anc
            return node

        stack = [(node, [])]
        while stack:
            cur, path = stack.pop()
            for ch in ast.iter_child_nodes(cur):
                if isinstance(ch, (*_FUNC_NODES, ast.Lambda)) and ch is not cur:
                    continue
                if isinstance(ch, ast.Call):
                    name = _callee_name(ch.func)
                    if name == "journal_boundary":
                        regions.setdefault(region_of(path), [[], []])[0].append(
                            ch.lineno
                        )
                    elif name in _SAVE_NAMES:
                        regions.setdefault(region_of(path), [[], []])[1].append(
                            ch.lineno
                        )
                stack.append((ch, path + [ch]))
        for region, (journals, saves) in regions.items():
            if journals and saves and min(saves) < min(journals):
                self.report(
                    ctx,
                    min(saves),
                    "snapshot save precedes the boundary's journal_boundary "
                    "call — a crash between them leaves a snapshot covering "
                    "an unjournaled boundary (unrecoverable; the torn-final-"
                    "boundary self-heal relies on journal-before-snapshot)",
                )


# -- ledger-gate ---------------------------------------------------------


class LedgerGateChecker(Checker):
    id = "ledger-gate"
    hint = (
        "pass read_only=<rank != 0 decision> (rank-0-only journaling); "
        "see cli.py's gate sites"
    )
    interests = (ast.Call,)

    def interested(self, ctx: FileContext) -> bool:
        # the ledger package constructs its own stores (load/repair
        # internals); everyone else must take the gate decision
        return "ledger/" not in ctx.path.replace("\\", "/")

    def visit(self, node, ctx: FileContext) -> None:
        if _callee_name(node.func) != "SweepLedger":
            return
        if any(kw.arg == "read_only" for kw in node.keywords):
            return
        self.report(
            ctx,
            node,
            "SweepLedger constructed without an explicit read_only= rank "
            "gate — under multi-process SPMD, N ranks appending one "
            "journal corrupt it",
        )


# -- atomic-write --------------------------------------------------------


def _is_plain_open(call: ast.Call) -> bool:
    """``open(path, "w")`` / ``open(path, mode="w")`` — bare builtin
    only. ``os.fdopen`` wraps descriptors whose atomicity contract
    (O_CREAT|O_EXCL claim files) is made at ``os.open`` time."""
    if not (isinstance(call.func, ast.Name) and call.func.id == "open"):
        return False
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    return (
        isinstance(mode, ast.Constant)
        and isinstance(mode.value, str)
        and "w" in mode.value
        and "b" not in mode.value
    )


def _mentions_json(node) -> bool:
    """Does the open target read as a .json/.jsonl destination? Checks
    string-literal fragments anywhere in the expression (f-strings
    included) and attribute/variable names."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            if ".json" in sub.value:
                return True
        elif isinstance(sub, ast.Attribute) and "json" in sub.attr.lower():
            return True
        elif isinstance(sub, ast.Name) and "json" in sub.id.lower():
            return True
    return False


class AtomicWriteChecker(Checker):
    """Two signatures, one idiom:

    1. ``open(<something .json>, "w")`` in a scope with no
       ``os.replace``/``os.rename``;
    2. ``with open(x, "w") as f: json.dump(_, f)`` (or
       ``f.write(json.dumps(...))``) in such a scope — the destination
       doesn't have to NAME json to hold it.

    The tmp+replace idiom passes because the scope that writes the tmp
    also calls ``os.replace``.
    """

    id = "atomic-write"
    hint = (
        "write to a tmp path and os.replace() it over the destination "
        "(see service/spool._write_json_atomic)"
    )
    interests = _FUNC_NODES + (ast.Module,)

    def visit(self, node, ctx: FileContext) -> None:
        # source order: deterministic findings, and the dedup below
        # relies on an open call being judged before (or guarded
        # against) the dump/write that flows through it
        calls = sorted(
            _direct_calls(node), key=lambda c: (c.lineno, c.col_offset)
        )
        for c in calls:
            name = _callee_name(c.func)
            # os.replace/os.rename SPECIFICALLY: a bare attribute match
            # would let any str.replace() in the scope disarm the check
            if (
                name in ("replace", "rename")
                and isinstance(c.func, ast.Attribute)
                and isinstance(c.func.value, ast.Name)
                and c.func.value.id == "os"
            ):
                return  # the idiom is present in this scope
        # handle names bound by `with open(...) as f`
        json_handles: dict = {}
        for sub in ast.walk(node):
            if not isinstance(sub, (ast.With, ast.AsyncWith)):
                continue
            for item in sub.items:
                cexpr = item.context_expr
                if (
                    isinstance(cexpr, ast.Call)
                    and _is_plain_open(cexpr)
                    and isinstance(item.optional_vars, ast.Name)
                ):
                    json_handles[item.optional_vars.id] = cexpr
        reported: set = set()  # open nodes already flagged (one finding
        # per defective write, even when it matches several signatures)
        for c in calls:
            if (
                _is_plain_open(c)
                and _mentions_json(c.args[0] if c.args else c)
                and id(c) not in reported
            ):
                reported.add(id(c))
                self.report(
                    ctx,
                    c,
                    "non-atomic write to a .json destination — a reader can "
                    "see a torn record, and a crash mid-write destroys the "
                    "previous one",
                )
            elif _callee_name(c.func) == "dump" and len(c.args) >= 2:
                target = c.args[1]
                if (
                    isinstance(target, ast.Name)
                    and target.id in json_handles
                    and id(json_handles[target.id]) not in reported
                ):
                    reported.add(id(json_handles[target.id]))
                    self.report(
                        ctx,
                        json_handles[target.id],
                        "json.dump into a handle opened with open(path, 'w') "
                        "and no os.replace in scope — non-atomic JSON write",
                    )
            elif (
                _callee_name(c.func) == "write"
                and isinstance(c.func, ast.Attribute)
                and isinstance(c.func.value, ast.Name)
                and c.func.value.id in json_handles
                and id(json_handles[c.func.value.id]) not in reported
                and c.args
                and any(
                    isinstance(s, ast.Call) and _callee_name(s.func) == "dumps"
                    for s in ast.walk(c.args[0])
                )
            ):
                reported.add(id(json_handles[c.func.value.id]))
                self.report(
                    ctx,
                    json_handles[c.func.value.id],
                    "json.dumps written through open(path, 'w') with no "
                    "os.replace in scope — non-atomic JSON write",
                )


# -- ledger-fsync --------------------------------------------------------


class LedgerFsyncChecker(Checker):
    id = "ledger-fsync"
    hint = "flush + os.fsync the ledger handle before returning"
    interests = _FUNC_NODES

    def interested(self, ctx: FileContext) -> bool:
        return "ledger/" in ctx.path.replace("\\", "/")

    def visit(self, node, ctx: FileContext) -> None:
        writes = []
        has_fsync = False
        for c in _direct_calls(node):
            name = _callee_name(c.func)
            if name == "fsync":
                has_fsync = True
            elif (
                name == "write"
                and isinstance(c.func, ast.Attribute)
                and isinstance(c.func.value, ast.Attribute)
                and c.func.value.attr == "_file"
            ):
                writes.append(c.lineno)
        if writes and not has_fsync:
            self.report(
                ctx,
                min(writes),
                "ledger handle written without os.fsync in the same "
                "function — the journal may lag the snapshot/report it "
                "must precede (fsync-before-report invariant)",
            )

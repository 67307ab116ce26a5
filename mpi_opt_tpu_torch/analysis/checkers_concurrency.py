"""racelint pass 2: the concurrency-contract checkers (the port's copy
of ``mpi_opt_tpu/analysis/checkers_concurrency.py``).

The thread, signal and file-protocol code (the staging engine's
transfer thread, the lease Refresher riding the heartbeat, the
ShutdownGuard flag handlers, the fleet claim protocol) each rests on an
invariant that these checks hold:

- **guarded-by** — a module global written from both a thread-entry
  call graph and main-line code is a data race unless every shared
  write holds a named lock. The lock is declared on the global's
  declaration line: ``# sweeplint: guarded-by(<lock>)``; writes
  lexically inside ``with <that lock>:`` pass, writes outside it are
  findings, and an UNANNOTATED shared global whose writes aren't all
  lock-covered is a finding at its declaration. Deliberate GIL-atomic
  flag stores carry ``# sweeplint: disable=guarded-by -- reason``.
- **beat-path-nonblocking** — the lease Refresher's lesson: code
  reachable from the heartbeat / beat-listener / slice-hook surfaces
  runs on the sweep's hot host path AND inside the staging transfer
  thread, so a blocking lock acquisition there stalls the very loop
  the heartbeat reports on. ``acquire(blocking=False)`` or a timeout
  pass; bare ``with lock:`` / ``acquire()`` are findings.
- **signal-safety** — code reachable from a registered signal handler
  may only set flags, read state, and raise: lock acquisition (the
  handler may interrupt the holder — instant self-deadlock), I/O,
  allocation-heavy formatting/logging and thread operations are
  findings.
- **lock-order** — the static partial order of nested lock scopes
  across files must be acyclic; a cycle is a deadlock two threads can
  reach. Non-blocking acquires contribute no edge (a trylock cannot
  deadlock).
- **fsync-before-rename** — extends atomic-write for the DURABLE
  layers (``ledger/``, ``corpus/``, ``service/``): a tmp-write whose
  scope renames it into place must fsync the fd first, or the rename
  can publish an empty/partial file after a crash (the contract
  ``corpus/index.write_index`` and ``spool._write_json_atomic`` follow
  but nothing checked). The heartbeat's deliberately-unfsynced beat
  files live in ``health/`` — out of scope by design: liveness, not
  history.
"""

from __future__ import annotations

import ast

from mpi_opt_tpu_torch.analysis.core import Checker, FileContext, ProjectChecker
from mpi_opt_tpu_torch.analysis.project import (
    ProjectTable,
    find_cycles,
    lock_order_edges,
)

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


# -- guarded-by ------------------------------------------------------------


class GuardedByChecker(ProjectChecker):
    id = "guarded-by"
    hint = (
        "declare the guard on the global's declaration line "
        "(# sweeplint: guarded-by(<lock>)) and take that lock around "
        "every shared write; a deliberate GIL-atomic flag store gets "
        "# sweeplint: disable=guarded-by -- reason"
    )

    def check_project(self, table: ProjectTable) -> None:
        thread = table.thread_side()
        main = table.main_side()
        for (path, name), g in sorted(table.globals.items()):
            if not g.writes:
                continue
            thread_writes = [w for w in g.writes if w[0] in thread]
            main_writes = [
                w for w in g.writes if w[0] is None or w[0] in main
            ]
            if not thread_writes or not main_writes:
                continue  # single-context global: not shared
            ctx = table.ctxs.get(path)
            if ctx is None:
                continue
            declared = ctx.guard_for(g.line)
            if declared is None:
                # no annotation: pass only when ONE common lock covers
                # every shared write (two writers under two different
                # locks exclude nothing)
                common = None
                for _fk, _ln, held in g.writes:
                    resolved = {table.resolve_lock(h) for h in held}
                    common = resolved if common is None else common & resolved
                if common:
                    continue
                writers = sorted(
                    {
                        table.functions[w[0]].qualname
                        for w in g.writes
                        if w[0] in table.functions
                    }
                )
                self.report(
                    ctx,
                    g.line,
                    f"module global {name!r} is written from a thread-entry "
                    f"call graph AND main-line code ({', '.join(writers)}) "
                    "with no declared guard — unsynchronized shared write",
                )
                continue
            # annotation present: resolve the lock and hold writers to it
            lock_key = self._resolve_guard(table, path, declared)
            if lock_key is None:
                self.report(
                    ctx, g.line,
                    f"guarded-by({declared}) names no lock the symbol table "
                    "knows in this module",
                )
                continue
            for funckey, line, held in g.writes:
                held_resolved = {table.resolve_lock(h) for h in held}
                if table.resolve_lock(lock_key) not in held_resolved:
                    self.report(
                        ctx, line,
                        f"write to {name!r} outside its declared guard "
                        f"{declared!r} (guarded-by on line {g.line})",
                    )

    @staticmethod
    def _resolve_guard(table: ProjectTable, path: str, declared: str):
        """``guarded-by(<lock>)`` names: a module-level lock name, or
        ``Class._attr`` / ``self._attr``-style dotted name."""
        tail = declared.split(".")[-1]
        for key, d in table.locks.items():
            if d.file != path:
                continue
            if key.endswith(f"::{declared}") or key.endswith(f".{tail}"):
                return key
            if key == f"{path}::{declared}":
                return key
        return None


# -- beat-path-nonblocking -------------------------------------------------


class BeatPathChecker(ProjectChecker):
    id = "beat-path-nonblocking"
    hint = (
        "use lock.acquire(blocking=False) (skip and let the next beat "
        "retry) or a timeout — the beat path runs on the sweep's hot "
        "host path and inside the staging transfer thread"
    )

    def check_project(self, table: ProjectTable) -> None:
        roots = [k for k, _r in table.beat_entries]
        if not roots:
            return
        for key in sorted(table.reachable(roots)):
            fn = table.functions.get(key)
            if fn is None:
                continue
            for lock_key, line, mode in fn.lock_events:
                if mode in ("nonblocking", "timeout"):
                    continue
                ctx = table.ctxs.get(fn.file)
                if ctx is None:
                    continue
                self.report(
                    ctx, line,
                    f"blocking acquisition of {table.lock_display(lock_key)} "
                    f"in beat-path-reachable {fn.qualname} — a contended "
                    "lock here stalls the hot path the heartbeat reports on",
                )


# -- signal-safety ---------------------------------------------------------

#: calls a signal handler's reachable code must not make: file/IO and
#: process ops, serialization, sleeping, thread lifecycle — anything
#: beyond set-a-flag/read/raise. (Matched by callee NAME — conservative
#: lexical judgement, same spirit as the rest of sweeplint.)
_SIGNAL_UNSAFE = frozenset(
    {
        "open", "print", "sleep", "dump", "dumps", "load", "loads",
        "warn", "warning", "error", "info", "debug", "exception",
        "makedirs", "unlink", "remove", "replace", "rename", "fsync",
        "fdopen", "system", "popen", "kill", "write", "flush", "read",
        "readline", "start", "join", "format",
    }
)


class SignalSafetyChecker(ProjectChecker):
    id = "signal-safety"
    hint = (
        "a handler may only set flags, read state, and raise — do the "
        "real work at a drain point that polls the flag (the "
        "ShutdownGuard protocol)"
    )

    def check_project(self, table: ProjectTable) -> None:
        roots = [k for k, _r in table.signal_entries]
        if not roots:
            return
        for key in sorted(table.reachable(roots)):
            fn = table.functions.get(key)
            ctx = table.ctxs.get(fn.file) if fn else None
            if fn is None or ctx is None:
                continue
            for lock_key, line, _mode in fn.lock_events:
                self.report(
                    ctx, line,
                    f"lock acquisition ({table.lock_display(lock_key)}) in "
                    f"signal-handler-reachable {fn.qualname} — the handler "
                    "can interrupt the lock's holder on the same thread: "
                    "self-deadlock",
                )
            for shape, base, attr, line in fn.raw_calls:
                name = attr if shape != "direct" else ""
                if name in _SIGNAL_UNSAFE:
                    self.report(
                        ctx, line,
                        f"{name}() call in signal-handler-reachable "
                        f"{fn.qualname} — handlers may only set flags/read "
                        "(no I/O, no allocation-heavy work)",
                    )


# -- lock-order ------------------------------------------------------------


class LockOrderChecker(ProjectChecker):
    id = "lock-order"
    hint = (
        "pick one global acquisition order for these locks and make "
        "every nesting follow it (or make the inner acquisition "
        "non-blocking)"
    )

    def check_project(self, table: ProjectTable) -> None:
        edges = lock_order_edges(table)
        cycles = find_cycles(edges)
        if not cycles:
            return
        # anchor each cycle at one concrete site of its first edge so
        # the finding is clickable (and suppressible) at real code
        site_of = {}
        for o, i, f, l in edges:
            site_of.setdefault((o, i), (f, l))
        for cyc in cycles:
            pairs = list(zip(cyc, cyc[1:] + cyc[:1]))
            f, l = site_of.get(pairs[0], (None, 0))
            ctx = table.ctxs.get(f)
            if ctx is None:
                continue
            order = " -> ".join(table.lock_display(k) for k in cyc + [cyc[0]])
            self.report(
                ctx, l,
                f"lock-order cycle: {order} — two threads entering this "
                "cycle from different edges deadlock",
            )


# -- fsync-before-rename ---------------------------------------------------

# one home for the scope-walk helpers (checkers_durability defines
# them for the same per-scope judgement shape; a third drifting copy
# is how subtle nested-lambda bugs get fixed in one checker only)
from mpi_opt_tpu_torch.analysis.checkers_durability import (  # noqa: E402
    _callee_name,
    _direct_calls,
)


def _is_write_open(call: ast.Call) -> bool:
    """``open(path, "w"/"a"/...)`` or ``os.fdopen(fd, "w")``."""
    name = _callee_name(call.func)
    if name not in ("open", "fdopen"):
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
        and any(c in mode.value for c in "wa+")
    )


class FsyncBeforeRenameChecker(Checker):
    id = "fsync-before-rename"
    hint = (
        "f.flush(); os.fsync(f.fileno()) before the os.replace — "
        "rename orders METADATA, not data; see spool._write_json_atomic"
    )
    interests = _FUNC_NODES

    def interested(self, ctx: FileContext) -> bool:
        p = ctx.path.replace("\\", "/")
        return any(seg in p for seg in ("ledger/", "corpus/", "service/"))

    def visit(self, node, ctx: FileContext) -> None:
        replaces, opens, has_fsync = [], [], False
        for c in _direct_calls(node):
            name = _callee_name(c.func)
            if (
                name in ("replace", "rename")
                and isinstance(c.func, ast.Attribute)
                and isinstance(c.func.value, ast.Name)
                and c.func.value.id == "os"
            ):
                replaces.append(c.lineno)
            elif name == "fsync":
                has_fsync = True
            elif _is_write_open(c):
                opens.append(c.lineno)
        if replaces and opens and not has_fsync:
            # the defect is the publish: a rename that can promote
            # unsynced bytes into the durable name
            self.report(
                ctx,
                min(replaces),
                "tmp written and renamed into place without an os.fsync in "
                "the same scope — after a crash the durable name can hold "
                "an empty/partial file (rename orders metadata, not data)",
            )

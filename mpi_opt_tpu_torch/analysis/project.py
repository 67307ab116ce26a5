"""racelint pass 1: the repo-wide concurrency symbol table (the port's
copy of ``mpi_opt_tpu/analysis/project.py``).

Per-file lexical checks cannot judge the engine's concurrency
contracts: whether a module global is written from BOTH the staging
thread and the main loop is a property of the whole call graph, and a
lock-order cycle is by definition cross-file. This module builds the
one table those judgements need, from the SAME parse the per-file pass
already did (FileContext trees are reused; no second parse):

- **locks** — ``threading.Lock()``/``RLock()``/``Condition(...)``
  assigned to a module-level name, an instance attribute
  (``self._lock = ...``), or a function local. A ``Condition`` wrapping
  a known lock is an alias of it (acquiring the condition acquires the
  lock).
- **thread entries** — ``threading.Thread(target=...)`` targets.
- **signal entries** — handlers installed via ``signal.signal``.
- **beat entries** — callables registered through
  ``set_beat_listener``/``set_slice_hook`` (they run on whatever thread
  beats — including the staging transfer thread), plus the structural
  roots of the beat path itself: ``beat``/``_notify_listener`` defined
  in a ``heartbeat.py`` and ``poll_slice`` in a ``shutdown.py``.
- **module globals** — declarations plus every write site (``global X``
  rebinds, and subscript/augmented mutations of a module-level name),
  each tagged with the ``with``-locks lexically held. Attribute stores
  are skipped on purpose: ``_LOCAL.stack = []`` on a
  ``threading.local`` is the per-thread idiom, not a shared write.
- **call graph** — resolved conservatively: bare names to same-file
  defs (nested defs included — the scheduler's ``hook``/``on_beat``
  closures are exactly the functions that matter) or
  ``from m import f`` imports; ``mod.f`` through the file's import
  aliases (matched by module stem); ``self.m`` to the enclosing class;
  locals whose constructor was seen
  (``r = leases.Refresher(...)`` then ``r()``) to that class's
  ``__call__``/method; anything else by project-wide name match EXCEPT
  a deny list of generic method names (``get``/``put``/``close``/...)
  whose matches would connect unrelated subsystems. Dynamic dispatch
  through stored callables is out of scope — the registration APIs
  above are modeled explicitly because they ARE the dynamic edges that
  matter here.

Pass 2 (checkers_concurrency.py) runs the guarded-by /
beat-path-nonblocking / signal-safety / lock-order judgements over this
table; ``summary()`` is the ``lint --json`` "project" section.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Optional

from mpi_opt_tpu_torch.analysis.core import FileContext, relpath_under

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

#: attribute-call names too generic for cross-file name-fallback
#: resolution — an edge guessed from ``.get()`` or ``.close()`` would
#: connect unrelated subsystems and poison every reachability set
_GENERIC_NAMES = frozenset(
    {
        "get", "put", "set", "add", "pop", "update", "append", "extend",
        "remove", "insert", "items", "keys", "values", "close", "open",
        "read", "write", "flush", "join", "start", "run", "send", "recv",
        "acquire", "release", "wait", "notify", "notify_all", "clear",
        "copy", "index", "count", "sort", "split", "strip", "encode",
        "decode", "format", "log", "exists", "mkdir", "load", "loads",
        "dump", "dumps", "save",
    }
)

_REGISTRARS = {
    "set_beat_listener": "beat listener",
    "set_slice_hook": "slice hook",
}


@dataclass
class LockDef:
    key: str  # "path::Class._lock" / "path::_TOKEN_LOCK" / "path::fn.v"
    name: str  # display name, e.g. "heartbeat.Heartbeat._lock"
    file: str
    line: int
    kind: str  # Lock | RLock | Condition
    alias_of: Optional[str] = None  # Condition wrapping a known lock

    def resolve(self, table: "ProjectTable") -> str:
        """The underlying lock key (Condition aliases collapse)."""
        if self.alias_of and self.alias_of in table.locks:
            return self.alias_of
        return self.key


@dataclass
class FuncInfo:
    key: str  # "path::qualname"
    name: str
    qualname: str
    file: str
    line: int
    cls: Optional[str]  # enclosing class name, if a method
    #: raw call records: (shape, base, attr, line); shape "direct" has
    #: the resolved funckey in base, "instance" a (path, Class) tuple
    raw_calls: list = field(default_factory=list)
    #: lock events: (lock_key, line, mode) — mode "with" | "blocking" |
    #: "nonblocking" | "timeout"
    lock_events: list = field(default_factory=list)
    #: lexical nesting: (outer_key, inner_key, line, inner_mode)
    nested_locks: list = field(default_factory=list)
    #: calls made while holding locks: (held tuple, rawcall, line)
    calls_under_lock: list = field(default_factory=list)


@dataclass
class GlobalDef:
    file: str
    name: str
    line: int  # declaration line (first module-level binding)
    #: write sites: (funckey_or_None, line, with-locks held tuple)
    writes: list = field(default_factory=list)


@dataclass
class ProjectTable:
    ctxs: dict = field(default_factory=dict)  # path -> FileContext
    locks: dict = field(default_factory=dict)  # key -> LockDef
    functions: dict = field(default_factory=dict)  # key -> FuncInfo
    classes: dict = field(default_factory=dict)  # path -> {cls: {meth: key}}
    globals: dict = field(default_factory=dict)  # (path, name) -> GlobalDef
    thread_entries: list = field(default_factory=list)  # (funckey, reason)
    signal_entries: list = field(default_factory=list)
    beat_entries: list = field(default_factory=list)
    calls: dict = field(default_factory=dict)  # funckey -> set(funckey)
    callers: dict = field(default_factory=dict)  # reverse edges
    # resolution indexes
    by_stem: dict = field(default_factory=dict)  # module stem -> [paths]
    by_name: dict = field(default_factory=dict)  # func name -> [funckeys]
    imports: dict = field(default_factory=dict)  # path -> alias map
    #: memoized lock_order_edges result — the checker and the cli's
    #: project summary both need it; computing the call-resolution
    #: pass twice per lint run would double the project pass's cost
    edge_cache: Optional[list] = None
    #: seconds spent in build_table (scans + linking) — the dominant
    #: cost of the project pass, charged to the synthetic
    #: "project-table" entry in `lint --json` checks so per-checker
    #: wall_s attribution stays honest
    build_wall_s: float = 0.0

    # -- queries ----------------------------------------------------------

    def reachable(self, roots) -> set:
        seen = set(roots)
        stack = list(roots)
        while stack:
            cur = stack.pop()
            for nxt in self.calls.get(cur, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return seen

    def thread_side(self) -> set:
        """Functions reachable from ANY asynchronous entry: thread
        targets, signal handlers, registered beat listeners/slice hooks
        and the beat-path roots (listeners run on whichever thread
        beats, so the beat path is thread-side by construction)."""
        roots = [k for k, _r in self.thread_entries]
        roots += [k for k, _r in self.signal_entries]
        roots += [k for k, _r in self.beat_entries]
        return self.reachable(roots)

    def main_side(self) -> set:
        """Functions reachable from main-line code: BFS from every
        function that is NOT itself thread-side. A helper called both
        from the staging thread and from the driver lands in BOTH
        sets — which is exactly the shared-write shape guarded-by
        exists to judge."""
        t = self.thread_side()
        return self.reachable([k for k in self.functions if k not in t])

    def lock_display(self, key: str) -> str:
        d = self.locks.get(key)
        return d.name if d else key

    def resolve_lock(self, key: str) -> str:
        d = self.locks.get(key)
        return d.resolve(self) if d else key


# -- pass 1: per-file scan -------------------------------------------------


def _stem(path: str) -> str:
    name = path.replace("\\", "/").rsplit("/", 1)[-1]
    return name[:-3] if name.endswith(".py") else name


def _call_shape(call: ast.Call):
    """(shape, base, attr) for a call target expression."""
    fn = call.func
    if isinstance(fn, ast.Name):
        return ("name", None, fn.id)
    if isinstance(fn, ast.Attribute):
        base = fn.value
        if isinstance(base, ast.Name):
            if base.id == "self":
                return ("self", None, fn.attr)
            return ("attr", base.id, fn.attr)
        return ("chain", None, fn.attr)
    return ("dynamic", None, "")


def _acquire_mode(call: ast.Call) -> str:
    """"nonblocking" (blocking=False / positional False), "timeout", or
    "blocking" for a bare ``acquire()``."""
    for kw in call.keywords:
        if kw.arg == "blocking":
            if isinstance(kw.value, ast.Constant) and kw.value.value is False:
                return "nonblocking"
        if kw.arg == "timeout":
            return "timeout"
    if call.args:
        a0 = call.args[0]
        if isinstance(a0, ast.Constant) and a0.value is False:
            return "nonblocking"
        if len(call.args) >= 2:
            return "timeout"
    return "blocking"


class _FileScan:
    """One file's contribution to the table."""

    def __init__(self, ctx: FileContext, table: ProjectTable):
        self.ctx = ctx
        self.path = ctx.path
        self.table = table
        #: alias -> ("module", stem) | ("symbol", modstem, symbol)
        self.aliases: dict = {}
        self.module_globals: set = set()
        self.module_locks: dict = {}  # name -> lock key

    def key(self, qualname: str) -> str:
        return f"{self.path}::{qualname}"

    # -- scan -------------------------------------------------------------

    def scan(self) -> None:
        for node in ast.walk(self.ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    alias = a.asname or a.name.split(".")[0]
                    self.aliases[alias] = ("module", a.name.split(".")[-1])
            elif isinstance(node, ast.ImportFrom):
                modstem = (node.module or "").split(".")[-1]
                for a in node.names:
                    # `from pkg import mod` and `from mod import sym`
                    # are lexically identical; the linker tries both
                    self.aliases[a.asname or a.name] = ("symbol", modstem, a.name)
        for stmt in self.ctx.tree.body:
            self._module_stmt(stmt)
        for stmt in self.ctx.tree.body:
            if isinstance(stmt, _FUNC_NODES):
                self._scan_func(stmt, qual=stmt.name, cls=None, env={})
            elif isinstance(stmt, ast.ClassDef):
                self._scan_class(stmt)
        # module-level calls (import-time registration is rare but
        # legal) ride a pseudo-function "<module>"
        mod_fn = self._ensure_fn("<module>", line=1)
        body = [
            s
            for s in self.ctx.tree.body
            if not isinstance(s, (*_FUNC_NODES, ast.ClassDef))
        ]
        self._scan_body(mod_fn, body, env={}, declared=set(), cls=None)

    def _module_stmt(self, stmt) -> None:
        targets, value = [], None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign):
            targets, value = [stmt.target], stmt.value
        for t in targets:
            if not isinstance(t, ast.Name):
                continue
            name = t.id
            kind = (
                _lock_factory_kind(value, self.aliases)
                if isinstance(value, ast.Call)
                else None
            )
            if kind:
                key = self.key(name)
                self.table.locks[key] = LockDef(
                    key, f"{_stem(self.path)}.{name}", self.path, stmt.lineno,
                    kind, self._condition_alias(value, cls=None),
                )
                self.module_locks[name] = key
            elif self._is_threading_local(value):
                pass  # per-thread containers are not shared state
            elif name not in self.module_globals:
                self.module_globals.add(name)
                self.table.globals[(self.path, name)] = GlobalDef(
                    self.path, name, stmt.lineno
                )
            else:
                g = self.table.globals.get((self.path, name))
                if g is not None:  # later module-level rebind: main-line
                    g.writes.append((None, stmt.lineno, ()))

    def _is_threading_local(self, value) -> bool:
        if not isinstance(value, ast.Call):
            return False
        _shape, base, attr = _call_shape(value)
        return attr == "local" and base in ("threading", None)

    def _condition_alias(self, call: ast.Call, cls: Optional[str]) -> Optional[str]:
        """``Condition(<known lock>)`` aliases that lock."""
        _shape, _b, attr = _call_shape(call)
        if attr != "Condition" or not call.args:
            return None
        arg = call.args[0]
        if isinstance(arg, ast.Name) and arg.id in self.module_locks:
            return self.module_locks[arg.id]
        if (
            isinstance(arg, ast.Attribute)
            and isinstance(arg.value, ast.Name)
            and arg.value.id == "self"
            and cls
        ):
            return self.key(f"{cls}.{arg.attr}")
        return None

    def _scan_class(self, cls: ast.ClassDef) -> None:
        methods = self.table.classes.setdefault(self.path, {}).setdefault(
            cls.name, {}
        )
        for stmt in cls.body:
            if isinstance(stmt, _FUNC_NODES):
                qual = f"{cls.name}.{stmt.name}"
                methods[stmt.name] = self.key(qual)
                self._scan_func(stmt, qual=qual, cls=cls.name, env={})

    def _ensure_fn(self, qual: str, line: int) -> FuncInfo:
        key = self.key(qual)
        fn = self.table.functions.get(key)
        if fn is None:
            fn = FuncInfo(
                key=key, name=qual.rsplit(".", 1)[-1], qualname=qual,
                file=self.path, line=line, cls=None,
            )
            self.table.functions[key] = fn
            self.table.by_name.setdefault(fn.name, []).append(key)
        return fn

    def _scan_func(self, node, qual: str, cls: Optional[str], env: dict) -> None:
        fn = self._ensure_fn(qual, node.lineno)
        fn.cls = cls
        # `global` declarations of THIS function only — a nested def's
        # `global X` must not leak here, or the enclosing function's
        # LOCAL X (ordinary Python scoping) would be misread as a
        # module-global write
        declared: set = set()
        stack = list(ast.iter_child_nodes(node))
        while stack:
            sub = stack.pop()
            if isinstance(sub, (*_FUNC_NODES, ast.Lambda)):
                continue
            if isinstance(sub, ast.Global):
                declared.update(sub.names)
            stack.extend(ast.iter_child_nodes(sub))
        local_env = dict(env)  # nested defs see the enclosing
        # function's constructor-typed locals and sibling defs
        self._collect_local_bindings(node, qual, cls, local_env)
        self._scan_body(fn, node.body, local_env, declared, cls)
        for stmt in self._direct_nested_defs(node):
            self._scan_func(
                stmt, qual=f"{qual}.{stmt.name}", cls=cls, env=local_env
            )

    @staticmethod
    def _direct_nested_defs(parent):
        stack = list(ast.iter_child_nodes(parent))
        while stack:
            n = stack.pop()
            if isinstance(n, _FUNC_NODES):
                yield n
                continue
            stack.extend(ast.iter_child_nodes(n))

    def _collect_local_bindings(self, node, qual, cls, env) -> None:
        """Lexical sweep: local lock constructions, instance-attr lock
        constructions (``self._lock = threading.Lock()`` — how instance
        locks enter the table), constructor-typed locals, nested-def
        names."""
        stack = list(node.body)
        while stack:
            stmt = stack.pop(0)
            if isinstance(stmt, _FUNC_NODES):
                env[stmt.name] = ("func", self.key(f"{qual}.{stmt.name}"))
                continue
            if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
                kind = _lock_factory_kind(stmt.value, self.aliases)
                tgt = stmt.targets[0] if len(stmt.targets) == 1 else None
                if kind and isinstance(tgt, ast.Name):
                    key = self.key(f"{qual}.{tgt.id}")
                    self.table.locks[key] = LockDef(
                        key, f"{_stem(self.path)}.{qual}.{tgt.id}", self.path,
                        stmt.lineno, kind, self._condition_alias(stmt.value, cls),
                    )
                    env[tgt.id] = ("lock", key)
                elif (
                    kind
                    and isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                    and cls
                ):
                    key = self.key(f"{cls}.{tgt.attr}")
                    self.table.locks[key] = LockDef(
                        key, f"{_stem(self.path)}.{cls}.{tgt.attr}", self.path,
                        stmt.lineno, kind, self._condition_alias(stmt.value, cls),
                    )
                elif isinstance(tgt, ast.Name):
                    ckey = self._class_of_call(stmt.value)
                    if ckey:
                        env[tgt.id] = ("instance", ckey)
            for ch in ast.iter_child_nodes(stmt):
                if isinstance(ch, ast.stmt):
                    stack.append(ch)
                elif isinstance(ch, ast.excepthandler):
                    stack.extend(ch.body)

    def _class_of_call(self, call: ast.Call):
        """(path, ClassName) when the call constructs a project class
        (CamelCase heuristic gates the lookup)."""
        shape, base, attr = _call_shape(call)
        if not attr or not attr[0].isupper():
            return None
        candidates = []
        if shape == "name":
            candidates.append((self.path, attr))
            tgt = self.aliases.get(attr)
            if tgt and tgt[0] == "symbol":
                for p in self.table.by_stem.get(tgt[1], ()):
                    candidates.append((p, attr))
        elif shape == "attr":
            stems = [base]
            tgt = self.aliases.get(base)
            if tgt:
                stems.append(tgt[1])
                if tgt[0] == "symbol":
                    stems.append(tgt[2])
            for s in stems:
                for p in self.table.by_stem.get(s, ()):
                    candidates.append((p, attr))
        for p, c in candidates:
            if c in self.table.classes.get(p, {}):
                return (p, c)
        return None

    # -- body scan: calls, lock events, global writes ---------------------

    def _lock_of_expr(self, expr, cls: Optional[str], env: dict):
        if isinstance(expr, ast.Name):
            if expr.id in self.module_locks:
                return self.module_locks[expr.id]
            hit = env.get(expr.id)
            if hit and hit[0] == "lock":
                return hit[1]
        elif (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and cls
        ):
            key = self.key(f"{cls}.{expr.attr}")
            if key in self.table.locks:
                return key
        return None

    def _scan_body(
        self, fn: FuncInfo, body, env: dict, declared: set,
        cls: Optional[str], held: tuple = (),
    ) -> None:
        for stmt in body:
            if isinstance(stmt, _FUNC_NODES):
                continue  # nested defs are their own functions
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                new_held = held
                for item in stmt.items:
                    lk = self._lock_of_expr(item.context_expr, cls, env)
                    if lk is not None:
                        fn.lock_events.append((lk, stmt.lineno, "with"))
                        for outer in new_held:
                            fn.nested_locks.append(
                                (outer, lk, stmt.lineno, "with")
                            )
                        new_held = new_held + (lk,)
                    else:
                        self._scan_exprs(fn, item.context_expr, env, cls, held)
                self._scan_body(fn, stmt.body, env, declared, cls, new_held)
                continue
            self._global_writes(fn, stmt, declared, held)
            self._scan_exprs(fn, stmt, env, cls, held, own_exprs_only=True)
            for ch in ast.iter_child_nodes(stmt):
                if isinstance(ch, ast.stmt):
                    self._scan_body(fn, [ch], env, declared, cls, held)
                elif isinstance(ch, ast.excepthandler):
                    self._scan_body(fn, ch.body, env, declared, cls, held)

    def _global_writes(self, fn, stmt, declared, held) -> None:
        if fn.qualname == "<module>":
            return  # module-level statements are import-time init
        names = []
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                names.extend(self._write_names(t, declared))
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            names.extend(self._write_names(stmt.target, declared))
        for name in names:
            g = self.table.globals.get((self.path, name))
            if g is not None:
                g.writes.append((fn.key, stmt.lineno, held))

    def _write_names(self, target, declared) -> list:
        out = []
        if isinstance(target, ast.Name):
            if target.id in declared and target.id in self.module_globals:
                out.append(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                out.extend(self._write_names(el, declared))
        elif isinstance(target, ast.Subscript):
            base = target.value
            # mutation of a module-level container needs no `global`
            if isinstance(base, ast.Name) and base.id in self.module_globals:
                out.append(base.id)
        return out

    def _scan_exprs(
        self, fn, node, env, cls, held, own_exprs_only: bool = False
    ) -> None:
        stack = list(ast.iter_child_nodes(node)) if own_exprs_only else [node]
        while stack:
            cur = stack.pop()
            if isinstance(cur, (*_FUNC_NODES, ast.Lambda)):
                continue
            if own_exprs_only and isinstance(cur, ast.stmt):
                continue  # nested statements handled by _scan_body
            if isinstance(cur, ast.Call):
                self._record_call(fn, cur, env, cls, held)
            stack.extend(ast.iter_child_nodes(cur))

    def _record_call(self, fn, call: ast.Call, env, cls, held) -> None:
        shape, base, attr = _call_shape(call)
        # lock.acquire(...) events (any base form the lock resolver knows)
        if attr == "acquire" and isinstance(call.func, ast.Attribute):
            lk = self._lock_of_expr(call.func.value, cls, env)
            if lk is not None:
                mode = _acquire_mode(call)
                fn.lock_events.append((lk, call.lineno, mode))
                for outer in held:
                    fn.nested_locks.append((outer, lk, call.lineno, mode))
                return
        # registrations: thread targets, signal handlers, beat listeners
        if attr == "Thread":
            for kw in call.keywords:
                if kw.arg == "target":
                    self.table.thread_entries.append(
                        (self._ref(kw.value, env, cls), "Thread target")
                    )
        elif attr == "signal" and len(call.args) >= 2:
            self.table.signal_entries.append(
                (self._ref(call.args[1], env, cls), "signal handler")
            )
        elif attr in _REGISTRARS and call.args:
            self.table.beat_entries.append(
                (self._ref(call.args[0], env, cls), _REGISTRARS[attr])
            )
        raw = self._classify_call(shape, base, attr, env)
        if raw is None:
            return
        fn.raw_calls.append((*raw, call.lineno))
        if held:
            fn.calls_under_lock.append((held, raw, call.lineno))

    def _classify_call(self, shape, base, attr, env):
        """Rewrite a call shape against the local env: constructor-typed
        locals become ("instance", (path, Class), method); known nested
        defs become ("direct", funckey, None)."""
        if shape == "name":
            hit = env.get(attr)
            if hit:
                if hit[0] == "func":
                    return ("direct", hit[1], None)
                if hit[0] == "instance":
                    return ("instance", hit[1], "__call__")
                if hit[0] == "lock":
                    return None
            return ("name", None, attr)
        if shape == "attr":
            hit = env.get(base)
            if hit and hit[0] == "instance":
                return ("instance", hit[1], attr)
            return (shape, base, attr)
        return (shape, base, attr)

    def _ref(self, expr, env, cls):
        """A callable REFERENCE passed to Thread/signal/registrar APIs:
        a funckey, a deferred marker resolved by the linker, or None."""
        if isinstance(expr, ast.Name):
            hit = env.get(expr.id)
            if hit and hit[0] == "func":
                return hit[1]
            if hit and hit[0] == "instance":
                return ("instance_ref", hit[1])
            return ("name_ref", self.path, expr.id)
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
            if expr.value.id == "self" and cls:
                return ("method_ref", self.path, cls, expr.attr)
            return ("mod_ref", self.path, expr.value.id, expr.attr)
        return None


def _lock_factory_kind(call: ast.Call, aliases: dict) -> Optional[str]:
    """"Lock"/"RLock"/"Condition" when ``call`` constructs a threading
    primitive (``threading.Lock()``, a bare ``Lock()`` from-import, or
    through a module alias)."""
    shape, base, attr = _call_shape(call)
    if attr not in ("Lock", "RLock", "Condition"):
        return None
    if shape == "name":
        tgt = aliases.get(attr)
        return attr if tgt and tgt[1] == "threading" else None
    if shape == "attr":
        tgt = aliases.get(base)
        if base == "threading" or (tgt and "threading" in (tgt[1],) + tgt[2:]):
            return attr
    return None


# -- linking ---------------------------------------------------------------


class _Linker:
    def __init__(self, table: ProjectTable):
        self.table = table

    def resolve_call(self, path: str, raw) -> list:
        shape, base, attr = raw
        t = self.table
        if shape == "direct":
            return [base] if base in t.functions else []
        if shape == "instance":
            p, c = base
            key = t.classes.get(p, {}).get(c, {}).get(attr)
            return [key] if key else []
        aliases = t.imports.get(path, {})
        if shape == "name":
            key = f"{path}::{attr}"
            if key in t.functions:
                return [key]
            tgt = aliases.get(attr)
            out = []
            if tgt and tgt[0] == "symbol":
                for p in t.by_stem.get(tgt[1], ()):
                    key = f"{p}::{attr}"
                    if key in t.functions:
                        out.append(key)
            return out
        if shape == "attr":
            stems = [base]
            tgt = aliases.get(base)
            if tgt:
                stems.append(tgt[1])
                if tgt[0] == "symbol" and len(tgt) > 2:
                    stems.append(tgt[2])
            out = []
            for s in stems:
                for p in t.by_stem.get(s, ()):
                    key = f"{p}::{attr}"
                    if key in t.functions:
                        out.append(key)
            if out:
                return out
        # fallback: project-wide by (non-generic) name; dunders never
        # fallback — `ann.__enter__()` matching every context manager
        # in the repo would weld unrelated subsystems together
        if attr and attr not in _GENERIC_NAMES and not attr.startswith("__"):
            return list(t.by_name.get(attr, ()))
        return []

    def resolve_with_class(self, fn: FuncInfo, raw) -> list:
        """``resolve_call`` plus the enclosing-class context a "self"
        call needs — the ONE resolution rule for both the call graph
        and the lock-order call edges (a self-method call through a
        generic name like ``.put()`` resolves here where the bare name
        fallback would conservatively drop it)."""
        shape, _base, attr = raw
        if shape == "self":
            methods = self.table.classes.get(fn.file, {}).get(fn.cls or "", {})
            if attr in methods:
                return [methods[attr]]
            return self.resolve_call(fn.file, ("chain", None, attr))
        return self.resolve_call(fn.file, raw)

    def link(self) -> None:
        t = self.table
        for key, fn in t.functions.items():
            targets: set = set()
            for shape, base, attr, _line in fn.raw_calls:
                targets.update(self.resolve_with_class(fn, (shape, base, attr)))
            t.calls[key] = {k for k in targets if k in t.functions and k != key}
        for key, callees in t.calls.items():
            for callee in callees:
                t.callers.setdefault(callee, set()).add(key)

    def resolve_entry(self, ref):
        t = self.table
        if isinstance(ref, str):
            return [ref] if ref in t.functions else []
        if not isinstance(ref, tuple):
            return []
        if ref[0] == "name_ref":
            _tag, path, name = ref
            return self.resolve_call(path, ("name", None, name))
        if ref[0] == "method_ref":
            _tag, path, cls, attr = ref
            key = t.classes.get(path, {}).get(cls, {}).get(attr)
            return [key] if key else []
        if ref[0] == "mod_ref":
            _tag, path, base, attr = ref
            return self.resolve_call(path, ("attr", base, attr))
        if ref[0] == "instance_ref":
            _tag, (path, cls) = ref
            key = t.classes.get(path, {}).get(cls, {}).get("__call__")
            return [key] if key else []
        return []


def build_table(ctxs) -> ProjectTable:
    """Pass 1 over already-parsed files: register class names first
    (constructor typing needs them project-wide), scan every file, link
    the call graph, resolve entry references, seed the beat roots."""
    table = ProjectTable()
    scans = []
    for ctx in ctxs:
        table.ctxs[ctx.path] = ctx
        table.by_stem.setdefault(_stem(ctx.path), []).append(ctx.path)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                table.classes.setdefault(ctx.path, {}).setdefault(node.name, {})
        scans.append(_FileScan(ctx, table))
    for s in scans:
        s.scan()
        table.imports[s.path] = s.aliases
    linker = _Linker(table)
    linker.link()
    for attr in ("thread_entries", "signal_entries", "beat_entries"):
        resolved = []
        for ref, reason in getattr(table, attr):
            for key in linker.resolve_entry(ref):
                resolved.append((key, reason))
        setattr(table, attr, resolved)
    for path in table.by_stem.get("heartbeat", ()):
        for key, fn in table.functions.items():
            if fn.file == path and fn.name in ("beat", "_notify_listener"):
                table.beat_entries.append((key, "beat-path root"))
    for path in table.by_stem.get("shutdown", ()):
        for key, fn in table.functions.items():
            if fn.file == path and fn.name == "poll_slice":
                table.beat_entries.append((key, "beat-path root"))
    return table


# -- lock-order edges ------------------------------------------------------


def lock_order_edges(table: ProjectTable) -> list:
    """The static partial order: ``(outer_key, inner_key, file, line)``
    for every lexical nesting plus one-hop call edges (a with-lock body
    calling a function that acquires another lock). Non-blocking
    acquires contribute no edge — a trylock cannot deadlock. Memoized
    per table (the checker and the summary share one computation)."""
    if table.edge_cache is not None:
        return table.edge_cache
    edges = []
    linker = _Linker(table)
    for fn in table.functions.values():
        for outer, inner, line, mode in fn.nested_locks:
            if mode == "nonblocking":
                continue
            o, i = table.resolve_lock(outer), table.resolve_lock(inner)
            if o != i:
                edges.append((o, i, fn.file, line))
        for held, raw, line in fn.calls_under_lock:
            for callee_key in linker.resolve_with_class(fn, raw):
                callee = table.functions.get(callee_key)
                if callee is None:
                    continue
                for lk, _ln, mode in callee.lock_events:
                    if mode == "nonblocking":
                        continue
                    i = table.resolve_lock(lk)
                    for outer in held:
                        o = table.resolve_lock(outer)
                        if o != i:
                            edges.append((o, i, fn.file, line))
    table.edge_cache = edges
    return edges


def find_cycles(edges) -> list:
    """Cycles in the lock-order graph, each reported once (rotated
    smallest-first for determinism)."""
    graph: dict = {}
    for o, i, _f, _l in edges:
        graph.setdefault(o, set()).add(i)
    cycles, seen = [], set()
    WHITE, GRAY, BLACK = 0, 1, 2
    color: dict = {}

    def dfs(node, stack):
        color[node] = GRAY
        stack.append(node)
        for nxt in sorted(graph.get(node, ())):
            if color.get(nxt, WHITE) == GRAY:
                cyc = stack[stack.index(nxt):]
                lo = min(range(len(cyc)), key=lambda j: cyc[j])
                norm = tuple(cyc[lo:] + cyc[:lo])
                if norm not in seen:
                    seen.add(norm)
                    cycles.append(list(norm))
            elif color.get(nxt, WHITE) == WHITE:
                dfs(nxt, stack)
        stack.pop()
        color[node] = BLACK

    for n in sorted(graph):
        if color.get(n, WHITE) == WHITE:
            dfs(n, [])
    return cycles


# -- the `lint --json` project section -------------------------------------


def summary(table: ProjectTable, root: Optional[str] = None) -> dict:
    """The machine-readable project-pass digest: locks discovered,
    thread/signal/beat entries, and the lock-order graph."""
    edges = lock_order_edges(table)
    uniq_edges = sorted(
        {(table.lock_display(o), table.lock_display(i)) for o, i, _f, _l in edges}
    )

    def fq(key):
        fn = table.functions.get(key)
        if fn is None:
            return key
        return f"{relpath_under(fn.file, root)}::{fn.qualname}"

    return {
        "locks": sorted(
            (
                {
                    "name": d.name,
                    "file": relpath_under(d.file, root),
                    "line": d.line,
                    "kind": d.kind,
                }
                for d in table.locks.values()
            ),
            key=lambda x: (x["file"], x["line"]),
        ),
        "thread_entries": sorted({fq(k) for k, _r in table.thread_entries}),
        "signal_handlers": sorted({fq(k) for k, _r in table.signal_entries}),
        "beat_entries": sorted({fq(k) for k, _r in table.beat_entries}),
        "lock_order": {
            "edges": [list(e) for e in uniq_edges],
            "cycles": [
                [table.lock_display(k) for k in cyc]
                for cyc in find_cycles(edges)
            ],
        },
    }

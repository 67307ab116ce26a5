"""The checker framework: parse once per file, visitors share the tree
(the port's copy of ``mpi_opt_tpu/analysis/core.py``).

A ``Checker`` declares the AST node types it wants (``interests``) plus
optional ``begin_file``/``finish_file`` hooks; the framework parses each
file ONCE, walks the tree ONCE, and dispatches nodes to every
interested checker — adding a tenth checker costs one dict lookup per
node, not another parse+walk of the repo. Checkers that reason about
whole function bodies (ordering, key flow) register interest in
``ast.FunctionDef``/``ast.Module`` and scan locally from there.

Findings carry ``file:line``, the check id, severity, message, and a
fix hint. Suppression and the barrier annotation are comment-driven and
parsed once per file into :class:`FileContext`:

- ``# sweeplint: disable=<id>[,<id>] -- reason`` on the finding line or
  the line directly above suppresses those checks there;
- ``# sweeplint: barrier(reason)`` on a ``def`` line marks the function
  as an explicit host-sync barrier (checkers_torch.HostSyncChecker);
- ``# sweeplint: guarded-by(<lock>)`` on a module global's declaration
  line declares which lock its shared writers must hold
  (checkers_concurrency.GuardedByChecker).

Two checker shapes share the framework: per-file
:class:`Checker` subclasses ride the single walk above, and
:class:`ProjectChecker` subclasses run a SECOND pass over the repo-wide
symbol table (mpi_opt_tpu_torch/analysis/project.py) after every file has
been parsed — cross-file properties (thread-entry reachability, the
lock partial order) cannot be judged one file at a time. Both report
:class:`Finding` through the same suppression/baseline machinery, and
the framework charges wall time per checker (``Checker.wall_s``) so a
future slow checker is diagnosable from ``lint --json``.

The baseline is a committed JSON file of accepted legacy findings,
keyed by (check, relpath, stripped line content) — content, not line
number, so unrelated edits above a baselined finding never un-baseline
it, while any edit TO the flagged line surfaces it again.
"""

from __future__ import annotations

import ast
import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Iterable, Optional

#: directories never scanned (mirrors obs/events.py's historical walk:
#: tests fabricate names/patterns on purpose; probes are shell-driven
#: drill scripts with deliberate kill shapes)
EXCLUDED_DIRS = ("__pycache__", ".git", "tests", "probes", "node_modules")

_DIRECTIVE = re.compile(r"#\s*sweeplint:\s*(disable|barrier|guarded-by)\b([^#\n]*)")
_DISABLE_IDS = re.compile(r"disable\s*=\s*([\w,\-]+)")
_GUARDED_BY = re.compile(r"guarded-by\s*\(\s*([\w.]+)\s*\)")


@dataclass
class Finding:
    """One invariant violation at a concrete source location."""

    check: str  # check id, e.g. "exit-code"
    file: str  # path as given to the runner
    line: int  # 1-based
    message: str
    hint: str = ""
    severity: str = "error"

    def as_dict(self, root: Optional[str] = None) -> dict:
        return {
            "check": self.check,
            "file": relpath_under(self.file, root),
            "line": self.line,
            "severity": self.severity,
            "message": self.message,
            "hint": self.hint,
        }

    def render(self, root: Optional[str] = None) -> str:
        loc = f"{relpath_under(self.file, root)}:{self.line}"
        tail = f" (fix: {self.hint})" if self.hint else ""
        return f"{loc}: [{self.check}] {self.message}{tail}"


def relpath_under(path: str, root: Optional[str]) -> str:
    """``path`` relative to ``root`` when it lives under it, else as
    given — findings and baseline fingerprints must not bake in an
    absolute checkout location."""
    if not root:
        return path
    try:
        rel = os.path.relpath(os.path.abspath(path), os.path.abspath(root))
    except ValueError:  # pragma: no cover - windows cross-drive
        return path
    return path if rel.startswith("..") else rel


@dataclass
class FileContext:
    """Everything checkers share about one parsed file."""

    path: str
    source: str
    tree: ast.Module
    lines: list = field(default_factory=list)
    #: lineno -> set of check ids disabled there (the line itself; the
    #: runner also honors a directive on the line above a finding)
    disabled: dict = field(default_factory=dict)
    #: linenos carrying a `# sweeplint: barrier` annotation
    barriers: set = field(default_factory=set)
    #: lineno -> lock name from a `# sweeplint: guarded-by(<lock>)`
    #: annotation (the guarded-by checker honors the declaration line
    #: or the line directly above, like suppression)
    guards: dict = field(default_factory=dict)

    @classmethod
    def parse(cls, path: str, source: str) -> "FileContext":
        tree = ast.parse(source)
        ctx = cls(path=path, source=source, tree=tree, lines=source.splitlines())
        for i, line in enumerate(ctx.lines, start=1):
            m = _DIRECTIVE.search(line)
            if not m:
                continue
            if m.group(1) == "barrier":
                ctx.barriers.add(i)
            elif m.group(1) == "guarded-by":
                g = _GUARDED_BY.search(m.group(0))
                if g:
                    ctx.guards[i] = g.group(1)
            else:
                ids = _DISABLE_IDS.search(m.group(0))
                if ids:
                    ctx.disabled.setdefault(i, set()).update(
                        s for s in ids.group(1).split(",") if s
                    )
        return ctx

    def guard_for(self, lineno: int) -> Optional[str]:
        """The guarded-by lock declared on ``lineno`` or the line above."""
        for ln in (lineno, lineno - 1):
            if ln in self.guards:
                return self.guards[ln]
        return None

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def suppressed(self, finding: Finding) -> bool:
        """Directive on the finding's line or the line directly above."""
        for ln in (finding.line, finding.line - 1):
            if finding.check in self.disabled.get(ln, ()):
                return True
        return False


class Checker:
    """Base: subclasses set ``id``/``severity``/``hint``, declare the
    node types they want in ``interests``, and append to
    ``self.findings`` from ``visit``/``begin_file``/``finish_file``.
    Checkers must be stateless ACROSS files — per-file state is reset by
    ``begin_file`` (the framework calls it before any visit)."""

    id: str = "checker"
    severity: str = "error"
    hint: str = ""
    #: node classes this checker's visit() receives (empty = no dispatch;
    #: the checker works entirely from begin_file/finish_file)
    interests: tuple = ()

    def __init__(self):
        self.findings: list = []
        #: cumulative seconds this checker spent across the run (begin/
        #: visit/finish for per-file checkers, check_project for project
        #: ones) — surfaced in `lint --json` so a slow checker is a
        #: number, not a mystery
        self.wall_s: float = 0.0

    # -- hooks ------------------------------------------------------------

    def interested(self, ctx: FileContext) -> bool:
        """File-scope gate (path-scoped checkers override); uninterested
        checkers skip the whole file for free."""
        return True

    def begin_file(self, ctx: FileContext) -> None:
        pass

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        pass

    def finish_file(self, ctx: FileContext) -> None:
        pass

    # -- helpers ----------------------------------------------------------

    def report(self, ctx: FileContext, node_or_line, message: str) -> None:
        line = (
            node_or_line
            if isinstance(node_or_line, int)
            else getattr(node_or_line, "lineno", 0)
        )
        self.findings.append(
            Finding(
                check=self.id,
                file=ctx.path,
                line=int(line),
                message=message,
                hint=self.hint,
                severity=self.severity,
            )
        )


class ProjectChecker(Checker):
    """Base for two-pass checkers: ``check_project`` runs once over the
    repo-wide symbol table (analysis/project.py ProjectTable) after
    every file has been parsed. Project checkers take no part in the
    per-file walk (``interested`` is False); their findings flow through
    the same suppression and baseline machinery via the table's parsed
    FileContexts."""

    def interested(self, ctx: FileContext) -> bool:
        return False

    def check_project(self, table) -> None:
        raise NotImplementedError


def check_file_context(ctx: FileContext, checkers: Iterable[Checker]) -> list:
    """Run ``checkers`` over one parsed file: single walk, type-dispatched,
    suppression applied. Returns surviving findings."""
    active = [c for c in checkers if c.interested(ctx)]
    if not active:
        return []
    clock = time.perf_counter
    for c in active:
        c.findings = []
        t0 = clock()
        c.begin_file(ctx)
        c.wall_s += clock() - t0
    dispatch: dict = {}
    for c in active:
        for t in c.interests:
            dispatch.setdefault(t, []).append(c)
    if dispatch:
        for node in ast.walk(ctx.tree):
            for c in dispatch.get(type(node), ()):
                t0 = clock()
                c.visit(node, ctx)
                c.wall_s += clock() - t0
    out: list = []
    for c in active:
        t0 = clock()
        c.finish_file(ctx)
        c.wall_s += clock() - t0
        out.extend(f for f in c.findings if not ctx.suppressed(f))
    return out


def run_project_checkers(ctxs: dict, checkers: Iterable["ProjectChecker"]) -> tuple:
    """The second pass: build the symbol table over every parsed file
    and run the project checkers against it. Returns
    ``(findings, table)`` — findings suppressed through each file's own
    directives, exactly like the per-file pass."""
    from mpi_opt_tpu_torch.analysis.project import build_table

    checkers = list(checkers)
    if not checkers:
        return [], None
    t0 = time.perf_counter()
    table = build_table(list(ctxs.values()))
    table.build_wall_s = time.perf_counter() - t0
    out: list = []
    for c in checkers:
        c.findings = []
        t0 = time.perf_counter()
        c.check_project(table)
        c.wall_s += time.perf_counter() - t0
        for f in c.findings:
            ctx = ctxs.get(f.file)
            if ctx is not None and ctx.suppressed(f):
                continue
            out.append(f)
    return out, table


def check_source(
    source: str, path: str = "snippet.py", checkers: Optional[Iterable[Checker]] = None
) -> list:
    """String-source entry point (the per-checker fixture tests' door:
    no temp repos, just parse and judge). ``path`` matters — several
    checkers are path-scoped (host-sync: train/fused_*; ledger-fsync:
    ledger/)."""
    if checkers is None:
        from mpi_opt_tpu_torch.analysis import all_checkers

        checkers = all_checkers()
    checkers = list(checkers)
    ctx = FileContext.parse(path, source)
    findings = check_file_context(
        ctx, [c for c in checkers if not isinstance(c, ProjectChecker)]
    )
    project = [c for c in checkers if isinstance(c, ProjectChecker)]
    if project:
        pf, _table = run_project_checkers({path: ctx}, project)
        findings = sorted(findings + pf, key=lambda f: (f.file, f.line, f.check))
    return findings


def iter_python_files(root: str):
    """Walk ``root`` for .py files with the standard exclusions; a
    single .py file path yields itself."""
    if os.path.isfile(root):
        if root.endswith(".py"):
            yield root
        return
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in EXCLUDED_DIRS]
        for fname in sorted(filenames):
            if fname.endswith(".py"):
                yield os.path.join(dirpath, fname)


def run_paths(
    paths: Iterable[str], checkers: Optional[Iterable[Checker]] = None
) -> tuple:
    """Lint every python file under ``paths``. Returns
    ``(findings, n_files, errors)`` — see :func:`run_paths_ex` for the
    variant that also returns the project symbol table."""
    findings, n_files, errors, _table = run_paths_ex(paths, checkers)
    return findings, n_files, errors


def run_paths_ex(
    paths: Iterable[str], checkers: Optional[Iterable[Checker]] = None
) -> tuple:
    """Two-pass lint over every python file under ``paths``: per-file
    checkers ride one walk per file; project checkers then run over the
    repo-wide symbol table built from the same parse. Returns
    ``(findings, n_files, errors, table)`` where ``errors`` are files
    that could not be read/parsed (reported, never silently skipped — a
    syntax-broken file would otherwise make the lint vacuously green
    exactly when the tree is at its sickest) and ``table`` is the
    ProjectTable (None when no project checkers ran)."""
    if checkers is None:
        from mpi_opt_tpu_torch.analysis import all_checkers

        checkers = all_checkers()
    checkers = list(checkers)
    file_checkers = [c for c in checkers if not isinstance(c, ProjectChecker)]
    project_checkers = [c for c in checkers if isinstance(c, ProjectChecker)]
    findings: list = []
    errors: list = []
    ctxs: dict = {}
    n_files = 0
    for root in paths:
        for path in iter_python_files(root):
            n_files += 1
            try:
                with open(path, "r") as f:
                    source = f.read()
                ctx = FileContext.parse(path, source)
            except (OSError, SyntaxError, ValueError) as e:
                errors.append(f"{path}: {type(e).__name__}: {e}")
                continue
            ctxs[path] = ctx
            findings.extend(check_file_context(ctx, file_checkers))
    table = None
    if project_checkers:
        pf, table = run_project_checkers(ctxs, project_checkers)
        findings.extend(pf)
    findings.sort(key=lambda f: (f.file, f.line, f.check))
    return findings, n_files, errors, table


# -- baseline ------------------------------------------------------------

BASELINE_VERSION = 1


def fingerprint(finding: Finding, ctx_line: str, root: Optional[str]) -> dict:
    """The baseline identity of a finding: check id + repo-relative path
    + the flagged line's stripped content. No line numbers — edits
    elsewhere in the file must not churn the baseline."""
    return {
        "check": finding.check,
        "file": relpath_under(finding.file, root),
        "content": ctx_line.strip(),
    }


def _line_of(finding: Finding) -> str:
    try:
        with open(finding.file, "r") as f:
            lines = f.read().splitlines()
        return lines[finding.line - 1] if 1 <= finding.line <= len(lines) else ""
    except OSError:
        return ""


def load_baseline(path: str) -> list:
    """The accepted-finding fingerprints in a baseline file (ValueError
    on malformed content — a truncated baseline silently accepting
    nothing would fail CI confusingly, accepting everything would be
    worse)."""
    with open(path, "r") as f:
        data = json.load(f)
    if not isinstance(data, dict) or "findings" not in data:
        raise ValueError(f"{path}: not a sweeplint baseline (no 'findings')")
    if int(data.get("version", -1)) > BASELINE_VERSION:
        raise ValueError(
            f"{path}: baseline version {data['version']} is newer than "
            f"this build's {BASELINE_VERSION}"
        )
    return list(data["findings"])


def split_baselined(findings: list, baseline: list, root: Optional[str]) -> tuple:
    """(fresh, accepted): findings whose fingerprint is in the baseline
    are accepted (reported separately, never failing the run)."""
    keyset = {(b.get("check"), b.get("file"), b.get("content")) for b in baseline}
    fresh, accepted = [], []
    for f in findings:
        fp = fingerprint(f, _line_of(f), root)
        (accepted if (fp["check"], fp["file"], fp["content"]) in keyset else fresh).append(f)
    return fresh, accepted


def write_baseline(path: str, findings: list, root: Optional[str]) -> None:
    data = {
        "version": BASELINE_VERSION,
        "tool": "sweeplint",
        "findings": [fingerprint(f, _line_of(f), root) for f in findings],
    }
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):  # failed mid-write: no orphan debris
            os.unlink(tmp)

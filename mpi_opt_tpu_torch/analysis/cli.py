"""``mpi_opt_tpu_torch lint [PATHS] [--json] [--baseline FILE]``.

The port's copy of ``mpi_opt_tpu/analysis/cli.py``. Dispatched from
``__main__.py`` before torch loads, and from ``cli.main`` like
``report``/``fsck``/``trace``; imports neither torch nor jax. Exit 0 =
no non-baselined findings (and no unparseable files), 1 = findings (or
scan errors), 2 = usage.

With no PATH it lints the port's tree: the ``mpi_opt_tpu_torch``
package and the top-level ``chip_smoke.py`` beside it. The JAX
package's own lint keeps covering the JAX package, whose hazards the
port's torch checkers do not describe. Finding paths and baseline
fingerprints are relative to the repo root, as in the JAX package, so
one baseline file serves both tools.

The JSON schema mirrors the ``fsck``/``report --validate`` pattern —
one stable top-level object a CI gate can parse::

    {"ok": bool, "tool": "sweeplint", "files_scanned": N,
     "findings": [{"check", "file", "line", "severity", "message",
                   "hint"}, ...],
     "baselined": [...same shape...], "errors": [str, ...],
     "checks": [{"id", "severity", "hint", "wall_s"}, ...],
     "project": {"locks": [...], "thread_entries": [...],
                 "signal_handlers": [...], "beat_entries": [...],
                 "lock_order": {"edges": [...], "cycles": [...]}}}

``wall_s`` is each checker's attributed wall time (the full-repo
self-lint budgets <15 s total; per-checker attribution makes a future
slow checker a number instead of a mystery) — the synthetic
``project-table`` entry carries the pass-1 symbol-table build + link
time, which belongs to no single checker — and ``project`` is the
racelint pass-1 digest, null when the run carried no
project checkers.

``--write-baseline FILE`` records the CURRENT findings as accepted —
the adoption workflow: run it once on a legacy tree, commit the file,
and the gate only fails on NEW findings from then on. (This repo's
committed ``sweeplint-baseline.json`` is empty by policy: every true
positive is fixed and deliberate cases are marked inline with
``# sweeplint: disable`` — the baseline exists so the NEXT big refactor
can stage fixes without turning the gate off.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from mpi_opt_tpu_torch.analysis import all_checkers
from mpi_opt_tpu_torch.analysis.core import (
    load_baseline,
    run_paths_ex,
    split_baselined,
    write_baseline,
)
from mpi_opt_tpu_torch.utils.exitcodes import EX_FAILURE, EX_OK


#: top-level scripts of the port, linted with the package by default
PORT_SCRIPTS = ("chip_smoke.py",)


def package_dir() -> str:
    """The ``mpi_opt_tpu_torch`` package directory (found from this file,
    so the package's ``__init__`` is not imported for it)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def repo_root() -> str:
    """The directory HOLDING the package (the repo checkout in every
    supported layout): findings and baseline fingerprints are relative
    to it."""
    return os.path.dirname(package_dir())


def default_paths() -> list:
    """The port's tree: the package and the top-level scripts that
    exist beside it."""
    root = repo_root()
    scripts = [os.path.join(root, s) for s in PORT_SCRIPTS]
    return [package_dir()] + [s for s in scripts if os.path.isfile(s)]


def lint_main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="mpi_opt_tpu_torch lint",
        description="AST invariant checks for the sweep engine's "
        "contracts (see README: Static analysis)",
    )
    p.add_argument(
        "paths",
        nargs="*",
        metavar="PATH",
        help="files/directories to lint (default: the port's tree, "
        "mpi_opt_tpu_torch/ and chip_smoke.py; tests/ and probes/ are "
        "always excluded)",
    )
    p.add_argument(
        "--json", action="store_true", help="machine-readable report on stdout"
    )
    p.add_argument(
        "--baseline",
        default=None,
        metavar="FILE",
        help="accepted-legacy-findings file: findings fingerprinted "
        "there are reported separately and never fail the run",
    )
    p.add_argument(
        "--write-baseline",
        default=None,
        metavar="FILE",
        help="record the current findings as the accepted baseline "
        "and exit 0 (the adoption workflow)",
    )
    args = p.parse_args(argv)

    root = repo_root()
    paths = args.paths or default_paths()
    for path in paths:
        if not os.path.exists(path):
            p.error(f"{path!r} does not exist")
    baseline = []
    if args.baseline is not None:
        try:
            baseline = load_baseline(args.baseline)
        except (OSError, ValueError) as e:
            p.error(f"--baseline: {e}")

    checkers = all_checkers()
    findings, n_files, errors, table = run_paths_ex(paths, checkers)
    fresh, accepted = split_baselined(findings, baseline, root)

    if args.write_baseline is not None:
        if errors:
            # a baseline recorded while files are unparseable is a lie:
            # every finding in those files would later surface as "new"
            # (or ship unrecorded) — refuse, same no-silent-skips rule
            # as the lint itself
            for e in errors:
                print(f"scan error: {e}", file=sys.stderr)
            print(
                f"refusing to write a baseline over {len(errors)} "
                "unparseable file(s) — fix them and re-run",
                file=sys.stderr,
            )
            return EX_FAILURE
        write_baseline(args.write_baseline, findings, root)
        print(
            f"wrote {len(findings)} accepted finding(s) to "
            f"{args.write_baseline}",
            file=sys.stderr,
        )
        return EX_OK

    ok = not fresh and not errors
    if args.json:
        from mpi_opt_tpu_torch.analysis import project as project_mod

        print(
            json.dumps(
                {
                    "ok": ok,
                    "tool": "sweeplint",
                    "files_scanned": n_files,
                    "findings": [f.as_dict(root) for f in fresh],
                    "baselined": [f.as_dict(root) for f in accepted],
                    "errors": errors,
                    "checks": [
                        {
                            "id": c.id,
                            "severity": c.severity,
                            "hint": c.hint,
                            "wall_s": round(c.wall_s, 4),
                        }
                        for c in checkers
                    ]
                    + (
                        # the symbol-table build is the project pass's
                        # dominant cost and belongs to no one checker;
                        # a synthetic entry keeps wall attribution
                        # honest (a slow build must be a number too)
                        [
                            {
                                "id": "project-table",
                                "severity": "info",
                                "hint": "racelint pass-1 symbol-table "
                                "build + call-graph link (shared by "
                                "all project checkers)",
                                "wall_s": round(table.build_wall_s, 4),
                            }
                        ]
                        if table is not None
                        else []
                    ),
                    "project": (
                        None if table is None else project_mod.summary(table, root)
                    ),
                }
            )
        )
    else:
        for f in fresh:
            print(f.render(root))
        for f in accepted:
            print(f"{f.render(root)} [baselined]")
        for e in errors:
            print(f"scan error: {e}", file=sys.stderr)
        tail = f"{n_files} file(s), {len(fresh)} finding(s)"
        if accepted:
            tail += f", {len(accepted)} baselined"
        if errors:
            tail += f", {len(errors)} unparseable"
        print(("OK: " if ok else "FAIL: ") + tail, file=sys.stderr)
    return EX_OK if ok else EX_FAILURE

"""``python -m mpi_opt_tpu_torch corpus index|resolve`` (dispatched from
cli.main; port of ``mpi_opt_tpu/corpus/cli.py``).

``index DIR`` builds/refreshes the persistent corpus index (atomic
write, incremental over unchanged ledgers) and renders a one-line-per-
entry summary; ``resolve DIR --workload W`` is the dry run of
``--warm-start auto:DIR`` — it prints exactly which sources a sweep
over that workload's default space would ingest (exact vs fuzzy, with
per-record loss counters) WITHOUT running anything, so an operator can
audit the auto-resolution before trusting a long sweep to it.
Neither touches the device; ``resolve`` builds the workload's space.
"""

from __future__ import annotations

import argparse
import json
import os


def corpus_main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="mpi_opt_tpu_torch corpus",
        description="the cross-sweep ledger-corpus knowledge layer "
        "(see README: Cross-sweep knowledge corpus)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    ip = sub.add_parser("index", help="build/refresh DIR's corpus index")
    ip.add_argument("dir", metavar="DIR", help="corpus root (ledgers underneath)")
    ip.add_argument("--json", action="store_true", help="machine-readable output")
    rp = sub.add_parser(
        "resolve", help="dry-run what --warm-start auto:DIR would ingest"
    )
    rp.add_argument("dir", metavar="DIR", help="corpus root")
    rp.add_argument(
        "--workload", required=True, help="the sweep's workload (space source)"
    )
    rp.add_argument("--json", action="store_true", help="machine-readable output")
    args = p.parse_args(argv)

    if not os.path.isdir(args.dir):
        p.error(f"{args.dir!r} is not a directory")

    if args.cmd == "index":
        from mpi_opt_tpu_torch.corpus.index import index_corpus, index_path

        doc = index_corpus(args.dir)
        if args.json:
            print(json.dumps(doc))
            return 0
        entries = doc["entries"]
        errored = [e for e in entries if e.get("error")]
        print(
            f"corpus {args.dir}: {len(entries)} ledger(s) indexed -> "
            f"{index_path(args.dir)}"
        )
        for e in entries:
            if e.get("error"):
                print(f"  {e['path']}: UNREADABLE ({e['error']})")
                continue
            best = e.get("best_score")
            print(
                f"  {e['path']}: {e.get('workload')}/{e.get('algorithm')} "
                f"space={str(e.get('space_hash'))[:8]} ok={e.get('ok')}"
                f"/{e.get('records')}"
                + (f" best={best:.6f}" if best is not None else " best=none")
            )
        # unreadable entries are recorded, not fatal: resolution skips
        # them with events — but the INDEXING operator should see red
        return 1 if errored else 0

    # resolve: the auto warm-start dry run
    from mpi_opt_tpu_torch.corpus.resolve import resolve
    from mpi_opt_tpu_torch.workloads import _REGISTRY, get_workload

    if args.workload not in _REGISTRY:
        p.error(f"--workload must be one of {sorted(_REGISTRY)}, got {args.workload!r}")
    space = get_workload(args.workload).default_space()
    res = resolve(space, args.dir, workload=args.workload)
    out = {
        "corpus": args.dir,
        "workload": args.workload,
        "space_hash": space.space_hash(),
        "observations": len(res.observations),
        "sources": res.sources,
        "skips": res.skips,
        "skipped_entries": res.skipped,
    }
    if args.json:
        print(json.dumps(out))
        return 0
    print(
        f"corpus {args.dir} -> {args.workload} "
        f"(space {space.space_hash()[:8]}): "
        f"{len(res.observations)} observation(s) from {len(res.sources)} source(s)"
    )
    for s in res.sources:
        print(f"  [{s['match']}] {s['path']}: {s['records']} record(s)")
    if res.skips:
        print(f"  record skips: {res.skips}")
    for sk in res.skipped:
        print(f"  skipped entry: {sk['path']} ({sk['reason']})")
    return 0

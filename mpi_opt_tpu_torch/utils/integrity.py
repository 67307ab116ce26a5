"""Snapshot integrity: content digests, manifests, quarantine, fsck,
and the port's on-disk step layout (port of
``mpi_opt_tpu/utils/integrity.py`` over this layout).

- **Digests.** ``tree_digest`` hashes each leaf as SHA-256 over its
  dtype string, shape string and C-order bytes (``_leaf_digest``), and
  combines the leaf digests in sorted key-path order. These are the JAX
  package's semantics, so the same host arrays digest identically in
  both packages; a bfloat16 leaf (a torch tensor here, an ``ml_dtypes``
  array there) hashes its raw bytes under the dtype string
  ``"bfloat16"``.
- **Verified saves.** ``build_manifest`` records each item's digest at
  save time; ``verify_restored`` recomputes them from the restored
  values before any state is applied.
- **Quarantine.** A step that fails to decode or verify is renamed
  ``<step>.corrupt`` (never deleted: it is evidence), an observer event
  ``snapshot_corrupt`` fires, and restore walks back to the next older
  step (``utils/checkpoint.py``). With none verified, restore raises
  ``NoVerifiedSnapshotError``, which the CLI maps to ``EX_DATAERR`` (65).
- **fsck.** ``python -m mpi_opt_tpu_torch fsck DIR`` audits a sweep's
  durable state offline (``fsck_main``): it verifies every committed
  step's digests, surfaces torn steps, cross-checks a ledger journal
  against the newest verified snapshot (trial-granular for driver
  ledgers, boundary-granular for fused ones), quarantines with
  ``--repair``, and with ``--deep`` re-reads every file of every step
  and checks every entry of ``sweep.pt``'s zip archive against its
  CRC-32, entries a restore never reads included. The JSON and the exit
  codes are the JAX package's.

**Step layout.** One numeric directory per step under the checkpoint
directory, holding ``sweep.pt`` (``torch.save`` of host tensors, read
back with ``torch.load(weights_only=True)``), ``meta.json``,
``manifest.json`` and the commit marker ``COMMIT``. A step is written
into a temporary name, every file fsync'd, and renamed into place; the
marker is how a reader recognises a committed step. The JAX package's
``fsck`` reads orbax steps; this module's ``fsck_main`` reads these.
"""

from __future__ import annotations

import errno
import hashlib
import json
import os
from typing import Callable, Optional

from mpi_opt_tpu_torch.utils.exitcodes import EX_DATAERR  # noqa: F401

MANIFEST_VERSION = 1
SWEEP_FILE = "sweep.pt"
META_FILE = "meta.json"
MANIFEST_FILE = "manifest.json"
COMMIT_MARKER = "COMMIT"
STEP_FORMAT = "mpi_opt_tpu_torch.step/1"


class SnapshotCorruptError(RuntimeError):
    """One snapshot step failed decode or digest verification (internal
    to the walk-back; callers see quarantine and fallback)."""


class NoVerifiedSnapshotError(RuntimeError):
    """Resume found snapshot steps but none verified: every retained
    step was quarantined. Restarting cannot help; the CLI exits
    ``EX_DATAERR``."""

    def __init__(self, directory: str, quarantined: list):
        self.directory = directory
        self.quarantined = list(quarantined)
        super().__init__(
            f"no verified snapshot remains under {directory}: "
            f"{len(self.quarantined)} step(s) failed verification and were "
            f"quarantined ({', '.join(os.path.basename(q) for q in self.quarantined)}). "
            "Inspect the *.corrupt directories, then restart WITHOUT --resume "
            "to start fresh, or point at a different --checkpoint-dir (the "
            "renames are reversible)"
        )


# -- digests ----------------------------------------------------------------


def _flatten(tree, path=()):
    """(key path, leaf) pairs of a tree of dicts, lists and tuples, as
    ``jax.tree_util.tree_flatten_with_path`` gives them for the same
    tree: dict keys and sequence indices as strings, None an empty
    subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [e for k in tree for e in _flatten(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [e for i, v in enumerate(tree) for e in _flatten(v, path + (str(i),))]
    return [(path, tree)]


def _host_array(leaf):
    """(dtype string, numpy array of the same shape and bytes). A
    bfloat16 tensor is viewed as int16: numpy has no bfloat16."""
    import numpy as np
    import torch

    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy()
        arr = t.numpy()
        return str(arr.dtype), arr
    arr = np.asarray(leaf)
    return str(arr.dtype), arr


def _leaf_digest(leaf) -> str:
    """SHA-256 over (dtype, shape, C-order bytes) of one array leaf."""
    import numpy as np

    dtype, arr = _host_array(leaf)
    h = hashlib.sha256()
    h.update(dtype.encode())
    h.update(str(arr.shape).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _leaf_nbytes(leaf) -> int:
    import numpy as np

    nbytes = getattr(leaf, "nbytes", None)  # numpy arrays, torch tensors
    return int(nbytes) if nbytes is not None else np.asarray(leaf).nbytes


# total tree bytes above which leaf hashing fans out across threads
# (hashlib releases the GIL for large buffers)
_PARALLEL_DIGEST_BYTES = 64 << 20


def tree_digest(tree) -> str:
    """Content digest of a tree of arrays (numpy arrays or torch
    tensors), leaves in sorted key-path order. Large trees hash their
    leaves on a thread pool; the combined digest is the same either
    way."""
    entries = sorted(_flatten(tree), key=lambda e: e[0])
    leaves = [leaf for _, leaf in entries]
    if len(leaves) > 1 and sum(_leaf_nbytes(x) for x in leaves) >= _PARALLEL_DIGEST_BYTES:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1, len(leaves))) as ex:
            digests = list(ex.map(_leaf_digest, leaves))
    else:
        digests = [_leaf_digest(x) for x in leaves]
    h = hashlib.sha256()
    for (path, _leaf), d in zip(entries, digests):
        h.update("/".join(path).encode())
        h.update(d.encode())
    return h.hexdigest()


def json_digest(obj) -> str:
    """Digest of a JSON item, canonicalised through one json round trip
    (tuples become lists, int keys strings) so the save side hashes
    what the restore side reads."""
    canonical = json.loads(json.dumps(obj))
    return hashlib.sha256(json.dumps(canonical, sort_keys=True).encode()).hexdigest()


def build_manifest(json_items: dict, tree_items: dict) -> dict:
    """``{"version", "items": {name: {"kind": "json"|"tree", "digest"}}}``,
    traced as a ``digest`` span (op ``build``)."""
    from mpi_opt_tpu_torch.obs import trace

    with trace.span("digest", op="build", items=len(json_items) + len(tree_items)):
        items = {name: {"kind": "json", "digest": json_digest(v)} for name, v in json_items.items()}
        items.update({name: {"kind": "tree", "digest": tree_digest(v)}
                      for name, v in tree_items.items()})
        return {"version": MANIFEST_VERSION, "items": items}


def verify_restored(manifest: dict, json_items: dict, tree_items: dict) -> list:
    """Recompute the digests of restored values against ``manifest``;
    returns the problems (empty = verified), traced as a ``digest`` span
    (op ``verify``). An item the manifest lists but that was not
    restored is a problem too."""
    from mpi_opt_tpu_torch.obs import trace

    problems = []
    recorded = manifest.get("items", {})
    restored = {**json_items, **tree_items}
    with trace.span("digest", op="verify", items=len(recorded)):
        for name, entry in recorded.items():
            want = entry.get("digest")
            if name not in restored:
                problems.append(f"item {name!r}: recorded in manifest but not restored")
                continue
            got = (json_digest(restored[name]) if entry.get("kind") == "json"
                   else tree_digest(restored[name]))
            if got != want:
                problems.append(
                    f"item {name!r}: content digest mismatch "
                    f"(saved {str(want)[:12]}..., restored {got[:12]}...)"
                )
    for name in restored:
        if name not in recorded:
            problems.append(f"item {name!r}: present but not in manifest")
    return problems


# -- the step layout --------------------------------------------------------


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_file(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def _write_json(path: str, obj) -> None:
    _write_file(path, lambda f: f.write(json.dumps(obj).encode()))


def write_step(root: str, step: int, sweep: dict, meta: dict, manifest: dict) -> None:
    """Commit one step: write every item into ``.<step>.tmp<pid>``,
    fsync each file, write the commit marker, fsync, and rename the
    directory to ``<step>``. A kill before the rename leaves only the
    temporary directory, which no reader takes for a step. A step that
    already exists is never replaced (``FileExistsError``): a sweep
    saves each step once, and a restore quarantines a step it cannot
    verify before the sweep saves past it."""
    import shutil

    import torch

    final = os.path.join(root, str(step))
    if os.path.lexists(final):
        raise FileExistsError(errno.EEXIST, f"step {step} already exists", final)
    tmp = os.path.join(root, f".{step}.tmp{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        _write_file(os.path.join(tmp, SWEEP_FILE), lambda f: torch.save(sweep, f))
        _write_json(os.path.join(tmp, META_FILE), meta)
        _write_json(os.path.join(tmp, MANIFEST_FILE), manifest)
        _write_json(os.path.join(tmp, COMMIT_MARKER), {"step": int(step), "format": STEP_FORMAT})
        _fsync_dir(tmp)
        os.rename(tmp, final)
        _fsync_dir(root)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def read_step(root: str, step: int):
    """(manifest, meta, sweep) of one committed step, decoded but not
    verified. A file missing from a committed step is corruption, not
    an I/O blip: it raises ``SnapshotCorruptError``."""
    import torch

    step_dir = os.path.join(root, str(step))
    try:
        with open(os.path.join(step_dir, MANIFEST_FILE)) as f:
            manifest = json.load(f)
        with open(os.path.join(step_dir, META_FILE)) as f:
            meta = json.load(f)
        sweep = torch.load(os.path.join(step_dir, SWEEP_FILE), map_location="cpu", weights_only=True)
    except FileNotFoundError as e:
        raise SnapshotCorruptError(f"step {step}: {e}") from e
    return manifest, meta, sweep


def _committed_steps(root: str) -> list:
    """Numeric step directories under ``root`` that carry the commit
    marker, ascending."""
    return sorted(
        int(d) for d in os.listdir(root)
        if d.isdigit() and os.path.exists(os.path.join(root, d, COMMIT_MARKER))
    )


def _torn_steps(root: str) -> list:
    """Numeric step directories without the commit marker: never a step
    this layout wrote (a save renames only after the marker exists),
    so debris to surface."""
    return sorted(
        int(d) for d in os.listdir(root)
        if d.isdigit() and not os.path.exists(os.path.join(root, d, COMMIT_MARKER))
    )


def find_checkpoint_roots(directory: str) -> list:
    """Directories under ``directory`` (inclusive) that directly hold
    step directories: one root for a flat sweep, one per ``bracket_<b>``
    directory for Hyperband and BOHB."""
    roots = []
    for root, dirs, _files in os.walk(directory):
        if any(d.isdigit() for d in dirs) or any(".corrupt" in d for d in dirs):
            roots.append(root)
            # not into the step directories themselves
            dirs[:] = [d for d in dirs if not d.split(".")[0].isdigit()]
    return sorted(roots)


def verify_step(root: str, step: int) -> tuple:
    """(status, problems) for one committed step: ``"verified"`` (every
    manifest digest matches) or ``"corrupt"``."""
    try:
        manifest, meta, sweep = read_step(root, step)
    except Exception as e:
        return "corrupt", [f"restore failed: {type(e).__name__}: {e}"]
    problems = verify_restored(manifest, {"meta": meta}, {"sweep": sweep})
    return ("verified", []) if not problems else ("corrupt", problems)


def deep_verify_step(root: str, step: int) -> list:
    """``fsck --deep``: re-read every file of one committed step, and
    check every entry of its ``sweep.pt`` zip archive against the CRC-32
    the archive records. ``torch.load`` checks no CRC and reads only the
    entries it needs, and the manifest digests verify what a restore
    returns, so a flipped byte in an entry a restore never reads (the
    archive's ``serialization_id``, say) shows only here. Returns the
    problems (empty: every byte read back clean)."""
    import zipfile

    problems: list = []
    step_dir = os.path.join(root, str(step))
    for dirpath, _dirnames, filenames in os.walk(step_dir):
        for name in sorted(filenames):
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, step_dir)
            try:
                with open(path, "rb") as f:
                    while f.read(1 << 20):
                        pass
            except OSError as e:
                problems.append(f"{rel}: unreadable: {type(e).__name__}: {e}")
                continue
            if name != SWEEP_FILE:
                continue
            try:
                with zipfile.ZipFile(path) as z:
                    bad = z.testzip()
                if bad is not None:
                    problems.append(f"{rel}: archive entry {bad!r} fails its CRC-32")
            except (zipfile.BadZipFile, OSError, EOFError) as e:
                problems.append(f"{rel}: not a readable archive: {type(e).__name__}: {e}")
    return problems


def _read_meta(root: str, step: int) -> Optional[dict]:
    try:
        with open(os.path.join(root, str(step), META_FILE)) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return meta if isinstance(meta, dict) else None


def load_sweep_meta(root: str, step: int) -> Optional[dict]:
    """The ``meta.json`` of a FUSED sweep's step, or None for a
    driver-path step (its meta carries ``search``) or an unreadable
    one. fsck's fused ledger cross-check reads ``boundaries_done``
    from it."""
    meta = _read_meta(root, step)
    return None if meta is None or "search" in meta else meta


def load_search_state(root: str, step: int) -> Optional[dict]:
    """A driver-path step's search state (``meta["search"]``: the
    algorithm's and the backend's state), or None for a fused step."""
    meta = _read_meta(root, step)
    return None if meta is None else meta.get("search")


def _sniffs_as_ledger(path: str) -> bool:
    """Does line 1 look like a ledger header? (fsck's auto-detect gate;
    the sniff itself lives in ``ledger.store.sniff_header``)"""
    from mpi_opt_tpu_torch.ledger.store import sniff_header

    return sniff_header(path) is not None


def _sniffs_as_fused_ledger(path: str) -> bool:
    """Was this ledger written by a fused sweep? (picks the replay
    cross-check fsck runs: boundary-granular or trial-granular)"""
    from mpi_opt_tpu_torch.ledger.store import sniff_header

    header = sniff_header(path)
    return header is not None and header.get("config", {}).get("mode") == "fused"


# -- quarantine -------------------------------------------------------------


def quarantine_step(directory: str, step: int) -> Optional[str]:
    """Rename ``<directory>/<step>`` to ``<step>.corrupt`` (numbered on
    a collision). Returns the quarantine path, or None when the step
    directory no longer exists."""
    src = os.path.join(directory, str(step))
    if not os.path.isdir(src):
        return None
    dst = f"{src}.corrupt"
    n = 1
    while os.path.exists(dst):
        dst = f"{src}.corrupt.{n}"
        n += 1
    os.replace(src, dst)
    return dst


def list_quarantined(directory: str) -> list:
    """Quarantined step directories under ``directory`` (recursive)."""
    out = []
    for root, dirs, _files in os.walk(directory):
        for d in dirs:
            base = d.split(".corrupt")[0]
            if d != base and base.isdigit() and d[len(base):].startswith(".corrupt"):
                out.append(os.path.join(root, d))
    return sorted(out)


# -- corruption observer ----------------------------------------------------

_OBSERVER: Optional[Callable] = None


def set_observer(cb: Optional[Callable]) -> None:
    """Install ``cb(event, **fields)`` as the corruption-event sink (the
    CLI points it at its metrics stream and quarantine counter)."""
    global _OBSERVER
    _OBSERVER = cb


def clear_observer() -> None:
    set_observer(None)


def notify(event: str, **fields) -> None:
    """Report a corruption-layer event; falls back to a warning so a
    library caller still sees quarantines happen."""
    if _OBSERVER is not None:
        _OBSERVER(event, **fields)
        return
    import warnings

    warnings.warn(f"{event}: {fields}", RuntimeWarning, stacklevel=2)


# -- fsck -------------------------------------------------------------------


def _audit_ledger(ledger_path: str, explicit: bool, repair: bool, newest_verified,
                  newest_by_root: dict, repaired: list) -> dict:
    """The ledger half of fsck: the strict schema check; with
    ``repair``, the two recoverable shapes an append-kill leaves (a torn
    final line, a torn final boundary) truncated as a resume would; and,
    for an explicit ``--ledger`` that validates, the replay cross-check
    against the newest verified snapshot."""
    from mpi_opt_tpu_torch.ledger.report import fused_replay_consistency, replay_consistency
    from mpi_opt_tpu_torch.ledger.store import (
        LedgerError,
        SweepLedger,
        read_ledger,
        scan_boundaries,
        validate_ledger,
    )

    problems = validate_ledger(ledger_path)
    torn_tail = False
    torn_boundary = None
    if problems:
        try:
            _h, recs, n_torn = read_ledger(ledger_path, strict=False)
            torn_tail = n_torn > 0
            _by, _sz, _bp, torn_boundary = scan_boundaries(recs)
        except Exception:
            torn_tail, torn_boundary = False, None
        if (torn_tail or torn_boundary is not None) and repair:
            try:
                # the load truncates in place: that is the repair (one
                # operator process, no rank can race it)
                SweepLedger(ledger_path, read_only=False).close()
            except LedgerError:
                pass  # damage beyond the append-kill shapes: report only
            else:
                what = (["torn tail"] if torn_tail else []) + (
                    [f"torn boundary {torn_boundary}"] if torn_boundary is not None else [])
                repaired.append(f"{ledger_path} ({' + '.join(what)} truncated)")
                problems = validate_ledger(ledger_path)
    if explicit and not problems:
        if _sniffs_as_fused_ledger(ledger_path):
            # every boundary any root's newest verified snapshot records
            # complete must be fully journaled. The MAX over roots:
            # Hyperband's brackets snapshot apart but share one global
            # boundary sequence, and the furthest bracket binds
            done = [
                int(meta["boundaries_done"])
                for root, step in newest_by_root.items()
                for meta in [load_sweep_meta(root, step)]
                if meta is not None and "boundaries_done" in meta
            ]
            if done:
                problems += fused_replay_consistency(ledger_path, max(done))
        else:
            search = load_search_state(*newest_verified) if newest_verified else None
            if search is not None:
                problems += replay_consistency(ledger_path, search)
    return {"path": ledger_path, "problems": problems, "torn_tail": torn_tail,
            "torn_boundary": torn_boundary, "cross_checked": explicit}


def fsck_main(argv=None) -> int:
    """The ``mpi_opt_tpu_torch fsck`` subcommand (see cli.main dispatch).

    Exit 0: every committed step verified. Exit 1: a corrupt or torn
    step, or a damaged or lagging explicit ``--ledger``, found this run
    (with ``--repair`` they are quarantined or truncated, and the run
    still reports what it found: CI tells "clean" from "repaired").
    Usage errors exit 2."""
    import argparse

    p = argparse.ArgumentParser(
        prog="mpi_opt_tpu_torch fsck",
        description="audit a sweep's durable checkpoint state: verify snapshot manifests, "
        "surface torn saves, cross-check a ledger journal",
    )
    p.add_argument("directory", metavar="DIR", help="checkpoint directory")
    p.add_argument("--repair", action="store_true",
                   help="quarantine corrupt/torn steps (rename to <step>.corrupt) and truncate "
                   "a torn ledger tail, so a subsequent --resume restores the newest verified "
                   "step")
    p.add_argument("--deep", action="store_true",
                   help="additionally re-read every file of each committed step and check "
                   "every entry of its sweep.pt archive against its CRC-32, entries a restore "
                   "never reads included; slower (a full re-read)")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument("--ledger", default=None, metavar="PATH",
                   help="cross-check this ledger journal against the newest verified snapshot "
                   "(default: a single co-located *.jsonl ledger beside DIR, schema check "
                   "only)")
    args = p.parse_args(argv)
    directory = os.path.abspath(args.directory)
    if not os.path.isdir(directory):
        p.error(f"{args.directory!r} is not a directory")

    steps_out = []
    repaired: list = []
    newest_verified = None  # (root, step)
    newest_by_root: dict = {}  # root -> newest verified step
    rc = 0
    for root in find_checkpoint_roots(directory):
        rel = os.path.relpath(root, directory)
        for step in _torn_steps(root):
            rc = 1
            entry = {"root": rel, "step": step, "status": "torn",
                     "problems": [f"uncommitted save (no {COMMIT_MARKER} marker)"]}
            if args.repair:
                q = quarantine_step(root, step)
                if q:
                    repaired.append(q)
                    entry["quarantined_to"] = os.path.basename(q)
            steps_out.append(entry)
        for step in _committed_steps(root):
            status, problems = verify_step(root, step)
            if args.deep and status != "corrupt":
                deep_problems = deep_verify_step(root, step)
                if deep_problems:
                    status, problems = "corrupt", problems + deep_problems
            entry = {"root": rel, "step": step, "status": status, "problems": problems}
            if status == "corrupt":
                rc = 1
                if args.repair:
                    q = quarantine_step(root, step)
                    if q:
                        repaired.append(q)
                        entry["quarantined_to"] = os.path.basename(q)
            else:
                if newest_verified is None or step > newest_verified[1]:
                    newest_verified = (root, step)
                newest_by_root[root] = max(step, newest_by_root.get(root, -1))
            steps_out.append(entry)

    # an explicit --ledger gets the schema check and the replay
    # cross-check; a single co-located sibling that sniffs as a ledger
    # gets the schema check only: nothing proves it belongs to this
    # sweep, and a neighbour's journal must not fail a healthy tree
    ledger_path = args.ledger
    explicit = ledger_path is not None
    if ledger_path is None:
        parent = os.path.dirname(directory) or "."
        sibling = [os.path.join(parent, f) for f in sorted(os.listdir(parent))
                   if f.endswith(".jsonl") and _sniffs_as_ledger(os.path.join(parent, f))]
        if len(sibling) == 1:
            ledger_path = sibling[0]
    ledger_out = None
    if ledger_path is not None:
        ledger_out = _audit_ledger(ledger_path, explicit, args.repair, newest_verified,
                                   newest_by_root, repaired)
        # a repaired torn tail or boundary still counts as damage found
        # this run, as a repaired step does
        if explicit and (ledger_out["problems"] or ledger_out["torn_tail"]
                         or ledger_out["torn_boundary"] is not None):
            rc = 1

    report = {
        "dir": directory,
        "ok": rc == 0,
        "steps": steps_out,
        "newest_verified": None if newest_verified is None else {
            "root": os.path.relpath(newest_verified[0], directory),
            "step": newest_verified[1],
        },
        "repaired": [os.path.basename(q) for q in repaired],
        "quarantined": [os.path.relpath(q, directory) for q in list_quarantined(directory)],
        "ledger": ledger_out,
    }
    if args.json:
        print(json.dumps(report))
        return rc
    print(f"fsck {directory}: {'ok' if rc == 0 else 'CORRUPTION FOUND'}")
    for e in steps_out:
        loc = f"{e['root']}/{e['step']}" if e["root"] != "." else str(e["step"])
        line = f"  step {loc}: {e['status']}"
        if e["problems"]:
            line += f" ({'; '.join(e['problems'])})"
        if e.get("quarantined_to"):
            line += f" -> quarantined as {e['quarantined_to']}"
        print(line)
    if report["quarantined"]:
        print(f"  quarantined: {', '.join(report['quarantined'])}")
    if ledger_out is not None:
        status = "ok" if not ledger_out["problems"] else "; ".join(ledger_out["problems"])
        print(f"  ledger {ledger_out['path']}: {status}")
    if rc and not args.repair:
        print("  (re-run with --repair to quarantine bad steps, then --resume)")
    return rc

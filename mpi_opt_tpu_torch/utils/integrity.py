"""Snapshot integrity: content digests, manifests, quarantine, and the
port's on-disk step layout (port of the parts of
``mpi_opt_tpu/utils/integrity.py`` a fused sweep's snapshot needs).

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

**Step layout.** One numeric directory per step under the checkpoint
directory, holding ``sweep.pt`` (``torch.save`` of host tensors, read
back with ``torch.load(weights_only=True)``), ``meta.json``,
``manifest.json`` and the commit marker ``COMMIT``. A step is written
into a temporary name, every file fsync'd, and renamed into place; the
marker is how a reader recognises a committed step. The JAX package's
``fsck`` reads orbax steps, not these.
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


def verify_step(root: str, step: int) -> tuple:
    """(status, problems) for one committed step: ``"verified"`` (every
    manifest digest matches) or ``"corrupt"``."""
    try:
        manifest, meta, sweep = read_step(root, step)
    except Exception as e:
        return "corrupt", [f"restore failed: {type(e).__name__}: {e}"]
    problems = verify_restored(manifest, {"meta": meta}, {"sweep": sweep})
    return ("verified", []) if not problems else ("corrupt", problems)


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

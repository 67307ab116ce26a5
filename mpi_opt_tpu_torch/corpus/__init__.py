"""Cross-sweep knowledge corpus: the ledger archive as a queryable prior
(port of ``mpi_opt_tpu/corpus``; the index file, the spool and the wire
are the JAX package's).

Every sweep journals its trial history durably (ledger/), every service
tenant keeps a per-job ledger (service/), and the fused mode journals
at member granularity — so a working deployment accumulates a CORPUS of
evaluated (params, score, budget) facts. This package lets a new sweep
read it without a human naming one file:

- ``index``   — ``corpus index DIR``: a persistent, atomically-updated
  index of every ledger under DIR, keyed by (workload, space_hash,
  algorithm), with record counts, best scores, and a structural space
  fingerprint enabling fuzzy matching between different-hash spaces.
- ``match``   — the fingerprint + compatibility layer: exact identity
  stays the hash's business; structurally-overlapping spaces score as
  fuzzy candidates, per-record admission keeps foreign evidence inside
  the live domain.
- ``resolve`` — ``--warm-start auto[:DIR]``: exact-hash sources merge
  (dedup by canonical params, newest wins), fuzzy sources enter
  down-weighted at budget 0, stale/corrupt index entries degrade to
  ``corpus_skip`` events — a deleted ledger never kills a sweep;
- ``serve``   — ``--suggest-serve DIR``: the suggestion service, one
  resident process answering suggest/report/lookup traffic over a
  filesystem spool (or, with ``--http-port``, behind the HTTP front door
  of ``service/http.py``), its acquisition on the card;
- ``transport`` and ``client`` — the front door's wire protocol and
  ``suggest-client``, torch-free (and jax-free), so they start fast and
  ride in any outside sweep.

The exports below load on first use: ``suggest-client`` imports this
package without torch.
"""

from __future__ import annotations

import importlib

_EXPORTS = ("INDEX_NAME", "INDEX_VERSION", "build_index", "index_corpus", "index_path",
            "read_index", "write_index")

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module 'mpi_opt_tpu_torch.corpus' has no attribute {name!r}")
    return getattr(importlib.import_module("mpi_opt_tpu_torch.corpus.index"), name)

"""Cross-sweep knowledge corpus: the ledger archive as a queryable prior
(port of ``mpi_opt_tpu/corpus``: its index, matching and resolution,
which import no JAX; the index file is the JAX package's).

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
  ``corpus_skip`` events — a deleted ledger never kills a sweep.

The JAX package's suggestion service (``serve``, ``transport``,
``client``: ``--suggest-serve`` and ``suggest-client``) is not ported
yet.
"""

from __future__ import annotations

from mpi_opt_tpu_torch.corpus.index import (  # noqa: F401
    INDEX_NAME,
    INDEX_VERSION,
    build_index,
    index_corpus,
    index_path,
    read_index,
    write_index,
)

"""The suggestion service (port of ``mpi_opt_tpu/corpus/serve.py``): one
resident process answering suggest -> report -> lookup traffic over a
filesystem spool, backed by the batched TPE acquisition
(``ops/tpe.py``) and warm-started from the ledger corpus.

One process on the card serves suggestions for many outside sweeps that
bring their own evaluation capacity. The transport is the sweep
service's no-network shape: clients atomic-write request files, the
server atomic-writes responses (the JAX package's layout, so one spool
serves clients of both packages)::

    SDIR/requests/<req>.json    # {"id", "op", ...} (client-owned)
    SDIR/responses/<id>.json    # the answer (server-owned)
    SDIR/control/stop           # flag: finish the queue and exit 0

Ops: ``suggest`` (n unit-cube points and their typed params, ranked by
the acquisition), ``report`` (a completed outside evaluation: it enters
the observation ring, the corpus cache and, when the server journals,
the server's own ledger, which is itself corpus material for the next
index), and ``lookup`` (the ``CorpusCache`` view: exact hit, near-match
``fidelity: "prior"`` evidence, or miss).

The ring stays on the host; the acquisition runs on the server's device
(CUDA unless the caller asks for the CPU). Its draws come from CPU
generators seeded from the path ``(seed, suggested)``
(``algorithms/base.py::path_generator``), the counterpart of the JAX
package's ``fold_in(key(seed), suggested)``, so the same draws give the
same suggestions on either device. Each draw is a ``_draw_*`` method, as
in ``algorithms/``, so the parity tests can hand the server JAX's own
draws.

As a tenant (``--suggest-serve DIR`` submitted to ``serve``) every
served request beats the heartbeat and polls the cooperative slice hook,
so the scheduler time-slices it like a sweep: a drain parks it with exit
75, its ledger and ``--resume`` rebuild the ring on the next slice, and
the stop flag or an idle timeout completes it (exit 0).

This module imports torch only inside ``SuggestServer``: the spool
helpers ride in the torch-free clients.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from mpi_opt_tpu_torch.service.spool import _read_json, _write_json_atomic

#: the answer to a request the server cannot parse: the client gets a
#: response, not a timeout, and the queue never wedges on garbage
_MALFORMED = {"error": "malformed request (need JSON with id/op)"}


def spool_paths(sdir: str) -> dict:
    return {
        "requests": os.path.join(sdir, "requests"),
        "responses": os.path.join(sdir, "responses"),
        "control": os.path.join(sdir, "control"),
    }


def ensure_spool(sdir: str) -> dict:
    paths = spool_paths(sdir)
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    return paths


def stop_path(sdir: str) -> str:
    return os.path.join(sdir, "control", "stop")


#: responses a client never consumed (it timed out, or died after
#: writing its request) expire after this age; swept on idle ticks
_RESPONSE_TTL_S = 600.0
_RESPONSE_GC_EVERY_S = 60.0


def _sweep_responses(resp_dir: str, ttl_s: float = _RESPONSE_TTL_S) -> None:
    """Best-effort expiry of abandoned response files: clients unlink the
    answers they consume, so one older than the TTL has no reader left."""
    now = time.time()
    try:
        names = os.listdir(resp_dir)
    except OSError:
        return
    for name in names:
        path = os.path.join(resp_dir, name)
        try:
            if now - os.path.getmtime(path) > ttl_s:
                os.unlink(path)
        except OSError:
            pass  # consumed or replaced meanwhile: exactly the goal


class SuggestServer:
    """The acquisition state: a fixed-shape observation ring on the host
    (the TPE algorithm's layout) plus the corpus-backed near-match cache.
    Transport-free: ``handle`` answers one request dict; the serve loop
    and the HTTP front door own the transport."""

    def __init__(
        self,
        space,
        seed: int = 0,
        buffer_size: int = 512,
        n_startup: int = 10,
        config=None,
        device=None,
    ):
        from mpi_opt_tpu_torch.device import resolve_device
        from mpi_opt_tpu_torch.ledger.cache import CorpusCache
        from mpi_opt_tpu_torch.ops.tpe import TPEConfig

        self.space = space
        self.seed = seed
        self.n_startup = n_startup
        self.config = config or TPEConfig()
        self.buffer_size = buffer_size
        self.device = resolve_device(device)
        self._obs_unit = np.zeros((buffer_size, space.dim), dtype=np.float32)
        self._obs_score = np.zeros(buffer_size, dtype=np.float32)
        self._valid = np.zeros(buffer_size, dtype=bool)
        self._n_obs = 0
        self._suggested = 0  # the draw path's counter: every batch draws afresh
        self._next_id = 0  # the journaled report serial
        self.cache = CorpusCache(space)
        if self.device.type == "cuda":
            import torch

            # bring the card up now, so the first acquisition a client
            # waits on does not pay for the CUDA context
            torch.zeros(1, device=self.device)

    # -- draws (replaced by the parity tests) -----------------------------

    def _draw_unit(self, path, n: int) -> np.ndarray:
        """``float32[n, d]`` uniform rows (JAX: ``space.sample_unit``)."""
        from mpi_opt_tpu_torch.algorithms.base import path_generator

        return self.space.sample_unit(path_generator(path), n).numpy()

    def _draw_tpe(self, path, m: int, d: int):
        """One acquisition's draws (``ops/tpe.py::draw_tpe``)."""
        from mpi_opt_tpu_torch.algorithms.base import path_generator
        from mpi_opt_tpu_torch.ops.tpe import draw_tpe

        return draw_tpe(path_generator(path), m, d, self.config)

    # -- state feeds -------------------------------------------------------

    def _push(self, unit: np.ndarray, score: float) -> None:
        slot = self._n_obs % self.buffer_size
        self._obs_unit[slot] = np.asarray(unit, dtype=np.float32)
        self._obs_score[slot] = score
        self._valid[slot] = True
        self._n_obs += 1

    def ingest(self, observations) -> int:
        """Corpus warm start, in ascending score order so a prior that
        overflows the ring evicts its own worst rows first."""
        finite = [o for o in observations if np.isfinite(o.score)]
        finite.sort(key=lambda o: o.score)
        for o in finite:
            self._push(o.unit, float(o.score))
        return len(finite)

    def seed_from_ledger(self, records) -> int:
        """Resume: rebuild the ring and the cache from the server's own
        journaled reports, and continue the report serial past them. The
        draw counter is not rebuilt (as in the JAX package): a resumed
        server draws from ``(seed, 0)`` again."""
        from mpi_opt_tpu_torch.ledger.warmstart import observations_from_records

        obs, _skips = observations_from_records(records, self.space)
        n = self.ingest(obs)
        self.cache.seed_from(records)
        self.cache.seed_prior(records)
        if records:
            self._next_id = 1 + max(int(r["trial_id"]) for r in records)
        return n

    # -- ops ---------------------------------------------------------------

    def suggest(self, n: int) -> dict:
        from mpi_opt_tpu_torch.algorithms.tpe import suggest_from_ring

        n = max(1, min(int(n), self.config.n_candidates))
        path = (self.seed, self._suggested)
        if self._n_obs < self.n_startup:
            unit = self._draw_unit(path, n)
        else:
            # n rounded up to a power of two, as the JAX package bounds its
            # compiled variants: the greedy picks' prefix is the same
            block = 1 << (n - 1).bit_length()
            draws = self._draw_tpe(path, self.buffer_size, self.space.dim)
            ring = (self._obs_unit, self._obs_score, self._valid)
            unit = suggest_from_ring(draws, ring, min(block, self.config.n_candidates),
                                     self.config, self.device)[:n]
        self._suggested += n
        return {
            "units": [[float(v) for v in row] for row in unit],
            "params": [self.space.canonical_params(self.space.materialize_row(row))
                       for row in unit],
            "n_obs": self._n_obs,
        }

    def report(self, req: dict, ledger=None, meta=None) -> dict:
        """One outside evaluation enters the ring, the cache and (with a
        ledger) the journal. ``params`` (canonical dict) or ``unit`` (row
        list) names the point; a non-finite score journals as failed and
        never enters the ring. ``meta`` rides the journal record verbatim
        (the HTTP front door stamps its idempotency key there, so a
        restarted server rebuilds its dedup index from the journal)."""
        from mpi_opt_tpu_torch.ledger.warmstart import _decode_params
        from mpi_opt_tpu_torch.trial import TrialResult, failed_result

        score = float(req.get("score", float("nan")))
        budget = int(req.get("budget") or 0)
        if req.get("unit") is not None:
            unit = np.asarray(req["unit"], dtype=np.float32)
            params = self.space.materialize_row(unit)
        elif req.get("params") is not None:
            params = _decode_params(self.space, dict(req["params"]))
            unit = self.space.params_to_unit(params)
        else:
            return {"error": "report needs params or unit"}
        tid = self._next_id
        self._next_id += 1
        if np.isfinite(score):
            result = TrialResult(trial_id=tid, score=score, step=budget, wall_time=0.0)
            self._push(unit, score)
        else:
            result = failed_result(trial_id=tid, step=budget, error="non-finite reported score")
        self.cache.put(params, result)
        if ledger is not None:
            # fsync-durable BEFORE the ack: a client that saw the ack finds
            # its evidence in the ledger after any crash
            ledger.record_trial(result, self.space.canonical_params(params), meta=meta)
        return {"ok": result.ok, "trial_id": tid, "n_obs": self._n_obs}

    def lookup(self, req: dict) -> dict:
        """The ``CorpusCache`` view: exact, then prior, then miss; a prior
        is never a result substitute (its ``fidelity`` says so)."""
        from mpi_opt_tpu_torch.ledger.warmstart import _decode_params

        params = _decode_params(self.space, dict(req.get("params") or {}))
        budget = int(req.get("budget") or 0)
        exact = self.cache.get(params, budget, trial_id=-1)
        if exact is not None:
            return {"hit": "exact", "score": exact.score, "step": exact.step}
        prior = self.cache.get_prior(params, trial_id=-1)
        if prior is not None:
            return {
                "hit": "prior",
                "score": prior.score,
                "step": prior.step,
                "fidelity": prior.extra["fidelity"],
                "prior_kind": prior.extra["prior_kind"],
            }
        return {"hit": None}

    def handle(self, req: dict, ledger=None, meta=None) -> dict:
        op = req.get("op")
        try:
            if op == "suggest":
                return self.suggest(int(req.get("n") or 1))
            if op == "report":
                return self.report(req, ledger=ledger, meta=meta)
            if op == "lookup":
                return self.lookup(req)
        except (KeyError, TypeError, ValueError) as e:
            # a bad point or params shape is the client's error: answer it,
            # never take down the server every other client rides on
            return {"error": f"{type(e).__name__}: {e}"}
        except Exception as e:
            from mpi_opt_tpu_torch.ledger.store import LedgerError

            if isinstance(e, LedgerError):
                return {"error": str(e)}
            raise
        return {"error": f"unknown op {op!r}"}


def serve_loop(
    server: SuggestServer,
    sdir: str,
    metrics,
    ledger=None,
    # the idle poll is the serving latency floor for a serial client (it
    # writes its next request only after reading the last response)
    poll_seconds: float = 0.01,
    idle_timeout: Optional[float] = None,
    max_requests: Optional[int] = None,
) -> dict:
    """Answer requests until stop, idle or drain. Returns the summary
    dict; raises ``SweepInterrupted`` on a drain request (the caller maps
    it to the exit-75 park, as a sweep's)."""
    from mpi_opt_tpu_torch.health import heartbeat, shutdown
    from mpi_opt_tpu_torch.health.shutdown import SweepInterrupted

    paths = ensure_spool(sdir)
    served = suggestions = reports = 0
    last_activity = time.monotonic()
    next_gc = time.monotonic() + _RESPONSE_GC_EVERY_S
    stopped = stop_seen = False
    while True:
        if not stop_seen and os.path.exists(stop_path(sdir)):
            # latch and consume: finish what is queued, then exit 0; the
            # unlink keeps a stale flag from stopping the next server
            stop_seen = True
            try:
                os.unlink(stop_path(sdir))
            except OSError:
                pass
        try:
            pending = sorted(f for f in os.listdir(paths["requests"]) if f.endswith(".json"))
        except OSError:
            pending = []  # a transient listing failure: the next poll retries
        if not pending:
            if stop_seen:
                stopped = True
                break
            if shutdown.requested():
                raise SweepInterrupted(shutdown.active_signal(), at=f"request {served}")
            if max_requests is not None and served >= max_requests:
                stopped = True
                break
            if idle_timeout is not None and time.monotonic() - last_activity >= idle_timeout:
                stopped = True
                break
            # idle housekeeping: expire abandoned responses
            if time.monotonic() >= next_gc:
                _sweep_responses(paths["responses"])
                next_gc = time.monotonic() + _RESPONSE_GC_EVERY_S
            time.sleep(poll_seconds)
            continue
        for fname in pending:
            rpath = os.path.join(paths["requests"], fname)
            req = _read_json(rpath)
            if req is None or not req.get("id"):
                # a torn client write or garbage: answer under the file's
                # stem so the writer still gets a response
                rid = fname[: -len(".json")]
                ans = dict(_MALFORMED, id=rid)
            else:
                rid = str(req["id"])
                ans = dict(server.handle(req, ledger=ledger), id=rid)
            # respond, then unlink: a crash between the two re-serves the
            # request on restart; the client takes the first answer it reads
            _write_json_atomic(os.path.join(paths["responses"], f"{rid}.json"), ans)
            try:
                os.unlink(rpath)
            except OSError:
                pass
            served += 1
            last_activity = time.monotonic()
            op = (req or {}).get("op")
            if op == "suggest":
                suggestions += len(ans.get("params") or [])
            elif op == "report":
                reports += 1
            metrics.log("suggest_request", op=op, served=served, n_obs=server._n_obs,
                        error=ans.get("error"))
            # the tenant's liveness pulse and cooperative slice point: every
            # served request is a boundary the sweep service can slice at
            heartbeat.beat(stage="suggest", served=served, reports=reports)
            shutdown.poll_slice(f"request {served}")
            if shutdown.requested():
                raise SweepInterrupted(shutdown.active_signal(), at=f"request {served}")
            if max_requests is not None and served >= max_requests:
                stopped = True
                break
        if stopped:
            break
    summary = {
        "served": served,
        "suggestions": suggestions,
        "reports": reports,
        "n_obs": server._n_obs,
        "stopped": stopped,
    }
    metrics.log("suggest_stop", **summary)
    return summary

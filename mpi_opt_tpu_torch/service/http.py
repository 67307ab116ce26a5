"""The overload-safe HTTP front door (port of
``mpi_opt_tpu/service/http.py``; stdlib ``http.server`` only).

A REST shim over the two spool surfaces, the suggestion service
(suggest/report/lookup, ``corpus/serve.py::SuggestServer``) and the
sweep service (submit/status/cancel, ``service/spool.py::Spool``), in
which the spool stays the durability layer and fencing tokens stay the
authority: the front door holds no durable state of its own. What it
adds:

- **batched wire protocol**: one ``POST /v1/batch`` carries many ops,
  and the whole batch shares ONE journal fsync
  (``SweepLedger.batched()``);
- **bounded admission**: a fixed-depth queue between the HTTP handler
  threads and the one executor thread that owns the acquisition state;
  past the bound the server sheds with a typed 503 and Retry-After
  (``http_shed``) instead of queueing without bound;
- **idempotency window**: every envelope carries a client-made key; a
  byte-identical retry is answered from a bounded dedup window
  (``http_replayed``), so reports journal exactly once; the same key
  with another body digest is refused (409), never replayed. For report
  ops the ledger is the durable half of the window: each journaled
  report carries ``(idem_key, idem_op)``, and a restarted server
  rebuilds the index from its own journal, so a client retrying into the
  restart cannot journal twice;
- **deadline scheduling**: an envelope's ``deadline_ts`` is checked at
  dequeue; work that aged past it in the queue is expired with a typed
  504 (``http_expired``) instead of served late;
- **circuit breaker**: a per-client strike window over sheds and key
  conflicts; a retry storm trips it (``breaker_open``) and the client
  gets fast 429s for the cooldown instead of amplifying the overload.

Threading: handler threads (``ThreadingHTTPServer``) only parse, check
and enqueue; the caller's thread runs ``serve_http``'s executor loop and
is the only thread that touches the ``SuggestServer`` (and so the card),
the ledger and the spool. The ring needs no lock, and the drain works as
in ``corpus/serve.py::serve_loop`` (a heartbeat beat and a slice poll a
batch; a drain raises ``SweepInterrupted`` out of ``serve_http``). On
the way out ``serve_http`` shuts the HTTP server down, answers whatever
is still queued and joins the serving thread, so nothing of one tenant
reaches the next slice of the server's process.

Every ``do_*`` handler body is one ``try/except Exception`` that answers
a typed 500 (sweeplint's ``http-handler-contained`` checks it): a
handler raise must answer an error, never kill the serving thread.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
import time
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from mpi_opt_tpu_torch.corpus.serve import ensure_spool, stop_path
from mpi_opt_tpu_torch.corpus.transport import WIRE_VERSION, ops_digest
from mpi_opt_tpu_torch.service.spool import _write_json_atomic

#: hard cap on ops per batch (bounds executor hold time and body size)
MAX_BATCH_OPS = 1024
#: hard cap on request body bytes (a malformed giant upload must cost a
#: bounded read to refuse)
MAX_BODY_BYTES = 8 << 20

ENDPOINT_FILE = "http.json"


def endpoint_path(sdir: str) -> str:
    return os.path.join(sdir, "control", ENDPOINT_FILE)


class _Work:
    """One admitted batch: the handler thread parks on ``event``; the
    executor fills ``status``/``response`` then sets it. ``waiters``
    counts handler threads sharing this work (a concurrent retry of
    the same key attaches instead of re-enqueueing)."""

    __slots__ = (
        "key", "client", "digest", "deadline_ts", "ops",
        "enqueued_at", "event", "status", "response", "waiters",
    )

    def __init__(self, env: dict):
        self.key = str(env["key"])
        self.client = str(env.get("client") or "unknown")
        self.digest = str(env["digest"])
        self.deadline_ts = env.get("deadline_ts")
        self.ops = env["ops"]
        self.enqueued_at = time.monotonic()
        self.event = threading.Event()
        self.status = None
        self.response = None
        self.waiters = 1


def _error_body(kind: str, detail: str) -> dict:
    return {"error": {"kind": kind, "detail": detail}}


class FrontDoor:
    """Transport-free core: admission, dedup, breaker, execution. The
    HTTP handler calls :meth:`admit` / :meth:`peek_status`; the
    executor loop calls :meth:`run_one`. Unit-testable without a
    socket."""

    def __init__(
        self,
        suggest=None,
        ledger=None,
        spool=None,
        metrics=None,
        queue_depth: int = 64,
        window_size: int = 512,
        shed_retry_after_s: float = 0.25,
        breaker_strikes: int = 32,
        breaker_window_s: float = 10.0,
        breaker_cooldown_s: float = 5.0,
        max_wait_s: float = 120.0,
    ):
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if window_size < 1:
            raise ValueError(f"window_size must be >= 1, got {window_size}")
        self.suggest = suggest
        self.ledger = ledger
        self.spool = spool
        self.metrics = metrics
        self.queue: queue.Queue = queue.Queue(maxsize=queue_depth)
        self.window_size = window_size
        self.shed_retry_after_s = shed_retry_after_s
        self.breaker_strikes = breaker_strikes
        self.breaker_window_s = breaker_window_s
        self.breaker_cooldown_s = breaker_cooldown_s
        self.max_wait_s = max_wait_s
        # handler-side shared state; the executor touches it too, so
        # every access is under this one lock (never held across an
        # execute or a metrics write)
        self._lock = threading.Lock()
        self._window: OrderedDict = OrderedDict()  # key -> {digest, response}
        self._pending: dict = {}  # key -> _Work
        self._strikes: dict = {}  # client -> deque[monotonic ts]
        self._breaker_until: dict = {}  # client -> monotonic deadline
        # metrics handles are not promised thread-safe; one small lock
        # serializes handler-thread and executor-thread log calls
        self._mlock = threading.Lock()
        # durable idempotency index for REPORT ops: (key, op_idx) ->
        # {"trial_id", "status"}; seeded from the ledger's own records
        # so the window survives a server SIGKILL (executor-only state)
        self._journal_index: dict = {}
        if ledger is not None:
            for rec in getattr(ledger, "records", []):
                k, i = rec.get("idem_key"), rec.get("idem_op")
                if k is not None and i is not None:
                    self._journal_index[(str(k), int(i))] = {
                        "trial_id": rec.get("trial_id"),
                        "status": rec.get("status"),
                    }
        self.counters = {
            "batches": 0, "ops": 0, "suggestions": 0, "reports": 0,
            "shed": 0, "replayed": 0, "expired": 0, "conflicts": 0,
            "breaker_trips": 0, "errors": 0,
        }

    # -- observability ----------------------------------------------------

    def _log(self, _event: str, **fields) -> None:
        if self.metrics is None:
            return
        with self._mlock:
            self.metrics.log(_event, **fields)

    # -- breaker ----------------------------------------------------------

    def _strike(self, client: str, now: float) -> bool:
        """One abuse mark (a shed, a key conflict) against ``client``;
        called under ``self._lock``. Past the threshold inside the
        window, the breaker opens for the cooldown; returns True on the
        trip (the caller logs breaker_open outside the lock)."""
        dq = self._strikes.setdefault(client, deque())
        dq.append(now)
        while dq and now - dq[0] > self.breaker_window_s:
            dq.popleft()
        if len(dq) >= self.breaker_strikes and client not in self._breaker_until:
            self._breaker_until[client] = now + self.breaker_cooldown_s
            self.counters["breaker_trips"] += 1
            dq.clear()
            return True
        return False

    def _breaker_open_for(self, client: str, now: float) -> Optional[float]:
        """Seconds until this client's breaker closes, or None."""
        until = self._breaker_until.get(client)
        if until is None:
            return None
        if now >= until:
            del self._breaker_until[client]
            return None
        return until - now

    # -- admission (handler threads) --------------------------------------

    def validate(self, env) -> Optional[tuple]:
        """Envelope schema check; returns a (status, body, retry_after)
        refusal or None when the envelope is admissible."""
        if not isinstance(env, dict):
            return 400, _error_body("malformed", "body must be a JSON object"), None
        try:
            if int(env.get("version") or 1) > WIRE_VERSION:
                return 400, _error_body(
                    "malformed",
                    f"wire version {env['version']} is newer than this "
                    f"server's {WIRE_VERSION}",
                ), None
        except (TypeError, ValueError):
            return 400, _error_body("malformed", "version must be an integer"), None
        key = env.get("key")
        if not isinstance(key, str) or not key or len(key) > 128:
            return 400, _error_body(
                "malformed", "need a non-empty string idempotency 'key'"
            ), None
        ops = env.get("ops")
        if not isinstance(ops, list) or not ops:
            return 400, _error_body("malformed", "need a non-empty 'ops' list"), None
        if len(ops) > MAX_BATCH_OPS:
            return 400, _error_body(
                "malformed", f"{len(ops)} ops exceed the {MAX_BATCH_OPS}-op batch cap"
            ), None
        if not all(isinstance(o, dict) for o in ops):
            return 400, _error_body("malformed", "every op must be an object"), None
        digest = ops_digest(ops)
        if env.get("digest") is not None and env["digest"] != digest:
            return 400, _error_body(
                "malformed", "digest does not match the ops body"
            ), None
        env["digest"] = digest
        ddl = env.get("deadline_ts")
        if ddl is not None:
            try:
                env["deadline_ts"] = float(ddl)
            except (TypeError, ValueError):
                return 400, _error_body("malformed", "deadline_ts must be a number"), None
        return None

    def admit(self, env: dict) -> tuple:
        """The handler-thread path: breaker -> dedup window -> pending
        attach -> bounded enqueue -> wait. Returns ``(status, body,
        retry_after)`` — always an answer, never an unbounded block."""
        refused = self.validate(env)
        if refused is not None:
            return refused
        key = str(env["key"])
        client = str(env.get("client") or "unknown")
        now = time.monotonic()
        tripped = False
        with self._lock:
            wait_s = self._breaker_open_for(client, now)
            if wait_s is not None:
                body = _error_body(
                    "breaker_open",
                    f"client {client!r} tripped the retry-storm breaker; "
                    f"retry after {wait_s:.2f}s",
                )
                return 429, body, wait_s
            hit = self._window.get(key)
            if hit is not None:
                if hit["digest"] != env["digest"]:
                    self.counters["conflicts"] += 1
                    tripped = self._strike(client, now)
                    status_body = (
                        409,
                        _error_body(
                            "key_conflict",
                            "idempotency key reused with a different body "
                            "— retries must be byte-identical",
                        ),
                        None,
                    )
                else:
                    self.counters["replayed"] += 1
                    status_body = (200, dict(hit["response"], replayed=True), None)
            else:
                work = self._pending.get(key)
                if work is not None:
                    if work.digest != env["digest"]:
                        self.counters["conflicts"] += 1
                        tripped = self._strike(client, now)
                        status_body = (
                            409,
                            _error_body(
                                "key_conflict",
                                "idempotency key already in flight with a "
                                "different body",
                            ),
                            None,
                        )
                    else:
                        # a concurrent retry of an in-flight batch rides
                        # the SAME work item: both waiters get the one
                        # executed answer — exactly-once by construction
                        work.waiters += 1
                        self.counters["replayed"] += 1
                        status_body = ("wait-replay", work, None)
                else:
                    work = _Work(env)
                    try:
                        self.queue.put_nowait(work)
                    except queue.Full:
                        self.counters["shed"] += 1
                        tripped = self._strike(client, now)
                        body = _error_body(
                            "overloaded",
                            f"admission queue full ({self.queue.maxsize}); "
                            f"retry after {self.shed_retry_after_s}s",
                        )
                        status_body = (503, body, self.shed_retry_after_s)
                    else:
                        self._pending[key] = work
                        status_body = ("wait", work, None)
        # log OUTSIDE the lock (metrics handles do I/O)
        if tripped:
            self._log("breaker_open", client=client, cooldown_s=self.breaker_cooldown_s)
        status, body, retry_after = status_body
        if status == 503:
            self._log("http_shed", client=client, queue_depth=self.queue.maxsize)
            return 503, body, retry_after
        if status == 200 and body.get("replayed"):
            self._log("http_replayed", client=client)
            return 200, body, None
        if status in ("wait", "wait-replay"):
            replay = status == "wait-replay"
            if replay:
                self._log("http_replayed", client=client)
            return self._await(body, replay=replay)
        return status, body, retry_after

    def _await(self, work: _Work, replay: bool = False) -> tuple:
        """Park the handler thread until the executor answers (bounded:
        the deadline plus grace, else ``max_wait_s``)."""
        if work.deadline_ts is not None:
            timeout = max(0.0, work.deadline_ts - time.time()) + 10.0
        else:
            timeout = self.max_wait_s
        if not work.event.wait(timeout):
            # the executor is wedged or the wait budget is gone; answer
            # overloaded (typed, retryable) — if the work does execute
            # later, the window replays it to the retry
            return 503, _error_body(
                "overloaded", f"no executor answer within {timeout:.0f}s"
            ), self.shed_retry_after_s
        body = work.response
        if replay and work.status == 200:
            body = dict(body, replayed=True)
        return work.status, body, None

    # -- execution (the one executor thread) -------------------------------

    def run_one(self, work: _Work) -> None:
        """Execute one admitted batch and answer its waiters. One
        journal fsync for the whole batch; the fsync happens BEFORE the
        answer is published (journal-before-ack at batch granularity)."""
        now = time.time()
        wait_s = time.monotonic() - work.enqueued_at
        if work.deadline_ts is not None and now > work.deadline_ts:
            self.counters["expired"] += 1
            self._finish(
                work,
                504,
                _error_body(
                    "deadline_expired",
                    f"batch aged {wait_s:.3f}s in queue, past its deadline — "
                    "expired instead of served late",
                ),
                record=False,
            )
            self._log("http_expired", client=work.client, queue_wait_s=round(wait_s, 4))
            return
        results = []
        failed = None
        try:
            batch_cm = (
                self.ledger.batched()
                if self.ledger is not None and any(
                    o.get("op") == "report" for o in work.ops
                )
                else contextlib.nullcontext()
            )
            with batch_cm:
                for i, op_req in enumerate(work.ops):
                    results.append(self._execute_op(op_req, work.key, i))
        except Exception as e:  # noqa: BLE001 - containment, see below
            from mpi_opt_tpu_torch.health.shutdown import SweepInterrupted

            if isinstance(e, SweepInterrupted):
                # the drain signal must reach serve_http's caller; the
                # waiters get a typed retryable answer first so clients
                # fail over to the restarted/peer server immediately
                self._finish(
                    work, 503, _error_body("overloaded", "server draining"),
                    record=False,
                )
                raise
            self.counters["errors"] += 1
            self._finish(
                work, 500,
                _error_body("internal", f"{type(e).__name__}: {e}"),
                record=False,
            )
            self._log("http_error", client=work.client, detail=f"{type(e).__name__}: {e}")
            return
        n_sugg = sum(
            len(r.get("params") or [])
            for r, o in zip(results, work.ops)
            if o.get("op") == "suggest"
        )
        n_rep = sum(1 for o in work.ops if o.get("op") == "report")
        self.counters["batches"] += 1
        self.counters["ops"] += len(work.ops)
        self.counters["suggestions"] += n_sugg
        self.counters["reports"] += n_rep
        response = {
            "key": work.key,
            "replayed": False,
            "queue_wait_s": round(wait_s, 6),
            "results": results,
        }
        self._finish(work, 200, response, record=True)
        self._log(
            "http_request",
            client=work.client,
            ops=len(work.ops),
            suggestions=n_sugg,
            reports=n_rep,
            queue_wait_s=round(wait_s, 4),
        )

    def _finish(self, work: _Work, status: int, body: dict, record: bool) -> None:
        with self._lock:
            if record:
                self._window[work.key] = {"digest": work.digest, "response": body}
                while len(self._window) > self.window_size:
                    self._window.popitem(last=False)
            self._pending.pop(work.key, None)
        work.status = status
        work.response = body
        work.event.set()

    def _execute_op(self, req: dict, key: str, op_idx: int) -> dict:
        op = req.get("op")
        if op in ("suggest", "report", "lookup"):
            if self.suggest is None:
                return {"error": "no suggestion backend on this front door"}
            if op == "report" and self.ledger is not None:
                prior = self._journal_index.get((key, op_idx))
                if prior is not None:
                    # the durable half of the idempotency window: this
                    # exact (key, op) is already journaled — answer from
                    # the journal, never re-journal (exactly-once even
                    # across a server SIGKILL + restart)
                    return {
                        "ok": prior.get("status") == "ok",
                        "trial_id": prior.get("trial_id"),
                        "n_obs": self.suggest._n_obs,
                        "journal_replayed": True,
                    }
                ans = self.suggest.handle(
                    req, ledger=self.ledger,
                    meta={"idem_key": key, "idem_op": op_idx},
                )
                if not ans.get("error") and ans.get("trial_id") is not None:
                    self._journal_index[(key, op_idx)] = {
                        "trial_id": ans["trial_id"],
                        "status": "ok" if ans.get("ok") else "failed",
                    }
                return ans
            return self.suggest.handle(req, ledger=self.ledger)
        if op in ("submit", "status", "cancel"):
            return self._service_op(req)
        return {"error": f"unknown op {op!r}"}

    def _service_op(self, req: dict) -> dict:
        from mpi_opt_tpu_torch.service.spool import SpoolError

        if self.spool is None:
            return {
                "error": "no service spool on this front door "
                "(start the server with --http-state-dir DIR)"
            }
        op = req.get("op")
        try:
            if op == "submit":
                argv = req.get("argv")
                if not isinstance(argv, list) or not argv:
                    return {"error": "submit needs a non-empty 'argv' list"}
                deadline_ts = req.get("deadline_ts")
                job = self.spool.submit(
                    [str(a) for a in argv],
                    tenant=str(req.get("tenant") or "default"),
                    priority=int(req.get("priority") or 0),
                    deadline_ts=None if deadline_ts is None else float(deadline_ts),
                )
                return {"job": job, "tenant": req.get("tenant") or "default",
                        "state": "queued"}
            if op == "status":
                return self.service_status()
            if op == "cancel":
                job = req.get("job")
                if not job:
                    return {"error": "cancel needs a 'job' id"}
                return {"job": job, "state": self.spool.cancel(str(job)),
                        "cancel": True}
        except (SpoolError, TypeError, ValueError) as e:
            # a bad job id / malformed field is the CLIENT's error:
            # answer it (the tenant_reject moral), never crash the
            # executor every other client is riding on
            return {"error": f"{type(e).__name__}: {e}"}
        return {"error": f"unknown service op {op!r}"}

    def service_status(self) -> dict:
        if self.spool is None:
            return {"error": "no service spool on this front door"}
        from mpi_opt_tpu_torch.service.client import _collect_status

        return _collect_status(self.spool)

    def health(self) -> dict:
        return {
            "ok": True,
            "queue": self.queue.qsize(),
            "queue_depth": self.queue.maxsize,
            "counters": dict(self.counters),
        }


class FrontDoorHandler(BaseHTTPRequestHandler):
    """Thin HTTP skin over :class:`FrontDoor` (reachable as
    ``self.server.front``). Contract (machine-checked by sweeplint's
    ``http-handler-contained``): each ``do_*`` body is ONE try/except
    Exception that answers a typed error — a handler bug must cost one
    500 answer, never the serving thread."""

    server_version = "mpi-opt-frontdoor/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass  # the metrics stream is the access log; stderr stays quiet

    def _answer(self, status: int, body: dict, retry_after=None) -> None:
        raw = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        if retry_after is not None:
            self.send_header("Retry-After", f"{retry_after:.3f}")
        self.end_headers()
        self.wfile.write(raw)

    def _read_body(self):
        length = int(self.headers.get("Content-Length") or 0)
        if length > MAX_BODY_BYTES:
            return None
        raw = self.rfile.read(length) if length else b""
        try:
            return json.loads(raw) if raw else {}
        except ValueError:
            return None

    def do_POST(self) -> None:  # noqa: N802 - stdlib casing
        try:
            front = self.server.front
            path = self.path.split("?", 1)[0].rstrip("/")
            if path == "/v1/stop":
                self.server.stop_requested.set()
                self._answer(200, {"stop": True})
                return
            single = {
                "/v1/suggest": "suggest", "/v1/report": "report",
                "/v1/lookup": "lookup", "/v1/submit": "submit",
                "/v1/cancel": "cancel",
            }
            if path != "/v1/batch" and path not in single:
                self._answer(404, _error_body("malformed", f"no endpoint {path}"))
                return
            body = self._read_body()
            if body is None:
                self._answer(
                    400, _error_body("malformed", "body must be JSON under 8 MiB")
                )
                return
            if path == "/v1/batch":
                env = body
            else:
                # single-op REST shape: envelope fields ride beside the
                # op's own; the answer shape is the batch's (one result)
                from mpi_opt_tpu_torch.corpus.transport import make_key

                op_fields = {
                    k: v for k, v in body.items()
                    if k not in ("key", "client", "deadline_ts", "version", "digest")
                }
                env = {
                    "version": WIRE_VERSION,
                    "key": body.get("key") or make_key(),
                    "client": body.get("client"),
                    "deadline_ts": body.get("deadline_ts"),
                    "ops": [dict(op_fields, op=single[path])],
                }
            status, out, retry_after = front.admit(env)
            self._answer(status, out, retry_after)
        except Exception as e:  # noqa: BLE001 - handler containment
            with contextlib.suppress(Exception):
                self._answer(500, _error_body("internal", f"{type(e).__name__}: {e}"))

    def do_GET(self) -> None:  # noqa: N802 - stdlib casing
        try:
            front = self.server.front
            path = self.path.split("?", 1)[0].rstrip("/")
            if path == "/v1/healthz":
                self._answer(200, front.health())
            elif path == "/v1/status":
                # read-only spool scan: safe from a handler thread (the
                # spool's primitives are atomic reads), so status never
                # queues behind suggestion traffic
                self._answer(200, front.service_status())
            else:
                self._answer(404, _error_body("malformed", f"no endpoint {path}"))
        except Exception as e:  # noqa: BLE001 - handler containment
            with contextlib.suppress(Exception):
                self._answer(500, _error_body("internal", f"{type(e).__name__}: {e}"))


def serve_http(
    front: FrontDoor,
    sdir: str,
    metrics,
    host: str = "127.0.0.1",
    port: int = 0,
    poll_seconds: float = 0.05,
    idle_timeout: Optional[float] = None,
    max_batches: Optional[int] = None,
) -> dict:
    """Bind, publish the endpoint file, and run the executor loop in
    THIS thread until stop/idle/drain — the same lifecycle contract as
    corpus/serve.serve_loop: a drain request raises SweepInterrupted
    (the caller maps it to the EX_TEMPFAIL park), the stop flag (POST
    /v1/stop, or the spool's control/stop file) and the idle timeout
    complete it. Returns the summary dict.

    The bound port is published atomically to ``SDIR/control/http.json``
    so clients (and the bench/drill) discover ``--http-port 0``
    ephemeral binds without racing the bind itself."""
    from mpi_opt_tpu_torch.health import heartbeat, shutdown
    from mpi_opt_tpu_torch.health.shutdown import SweepInterrupted

    ensure_spool(sdir)

    class _Server(ThreadingHTTPServer):
        # the default socketserver backlog (5) makes the KERNEL the shed
        # point under a connection burst — clients see RSTs instead of
        # the admission queue's typed 503 + Retry-After. A deep listen
        # backlog keeps the bounded queue the one place overload is
        # answered; the handler threads it admits are parked waiters,
        # not runnable work
        request_queue_size = 128

    httpd = _Server((host, port), FrontDoorHandler)
    httpd.daemon_threads = True
    httpd.front = front
    httpd.stop_requested = threading.Event()
    front.metrics = metrics
    bound_port = httpd.server_address[1]
    _write_json_atomic(
        endpoint_path(sdir),
        {"host": host, "port": bound_port,
         "url": f"http://{host}:{bound_port}", "pid": os.getpid()},
    )
    metrics.log("http_serve", port=bound_port, queue_depth=front.queue.maxsize)
    server_thread = threading.Thread(
        target=httpd.serve_forever, kwargs={"poll_interval": 0.1},
        name="frontdoor-http", daemon=True,
    )
    server_thread.start()
    last_activity = time.monotonic()
    stop_seen = stopped = False
    try:
        while True:
            if not stop_seen and (
                httpd.stop_requested.is_set() or os.path.exists(stop_path(sdir))
            ):
                # latch AND consume, like serve_loop: finish what is
                # admitted, then exit 0; a stale flag must not stop the
                # NEXT server on this spool
                stop_seen = True
                try:
                    os.unlink(stop_path(sdir))
                except OSError:
                    pass
            try:
                work = front.queue.get(timeout=poll_seconds)
            except queue.Empty:
                if stop_seen:
                    stopped = True
                    break
                if shutdown.requested():
                    raise SweepInterrupted(
                        shutdown.active_signal(),
                        at=f"batch {front.counters['batches']}",
                    )
                if max_batches is not None and front.counters["batches"] >= max_batches:
                    stopped = True
                    break
                if (
                    idle_timeout is not None
                    and time.monotonic() - last_activity >= idle_timeout
                ):
                    stopped = True
                    break
                continue
            front.run_one(work)
            last_activity = time.monotonic()
            # the tenant's liveness pulse + cooperative slice point:
            # every answered batch is a natural boundary, so the sweep
            # service can time-slice an HTTP front door like a sweep
            heartbeat.beat(
                stage="http",
                served=front.counters["batches"],
                reports=front.counters["reports"],
            )
            shutdown.poll_slice(f"batch {front.counters['batches']}")
            if shutdown.requested():
                raise SweepInterrupted(
                    shutdown.active_signal(),
                    at=f"batch {front.counters['batches']}",
                )
            if max_batches is not None and front.counters["batches"] >= max_batches:
                stopped = True
                break
    finally:
        httpd.shutdown()
        server_thread.join()
        httpd.server_close()
        # a batch still queued is never executed now: answer it (typed,
        # retryable) so its parked handler thread ends with the server
        while True:
            try:
                work = front.queue.get_nowait()
            except queue.Empty:
                break
            front._finish(work, 503, _error_body("overloaded", "server stopping"), record=False)
        try:
            os.unlink(endpoint_path(sdir))
        except OSError:
            pass
    summary = {
        "served": front.counters["batches"],
        "ops": front.counters["ops"],
        "suggestions": front.counters["suggestions"],
        "reports": front.counters["reports"],
        "shed": front.counters["shed"],
        "replayed": front.counters["replayed"],
        "expired": front.counters["expired"],
        "breaker_trips": front.counters["breaker_trips"],
        "n_obs": None if front.suggest is None else front.suggest._n_obs,
        "stopped": stopped,
    }
    metrics.log("http_stop", **summary)
    return summary

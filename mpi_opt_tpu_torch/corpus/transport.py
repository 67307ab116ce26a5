"""The HTTP front door's wire protocol and its typed transport faults
(port of ``mpi_opt_tpu/corpus/transport.py``; the same wire, so a
client of either package talks to a front door of either).

Torch-free and jax-free: it rides in every client. One batched envelope
carries many operations per HTTP request::

    POST /v1/batch   {"version": 1, "key": <idempotency key>,
                      "client": <caller id>, "digest": <ops sha256>,
                      "deadline_ts": <abs epoch s | null>,
                      "ops": [{"op": "suggest"|"report"|"lookup"|
                               "submit"|"status"|"cancel", ...}, ...]}
    -> 200           {"key": ..., "replayed": bool, "queue_wait_s": ...,
                      "results": [<one answer dict per op>, ...]}

Batching is the throughput lever: the filesystem spool pays one file
round trip per operation, while here a batch of reports shares one HTTP
round trip and one journal fsync (``service/http.py`` wraps the batch in
``SweepLedger.batched()``).

Overload answers are typed: a client tells "the server answered (maybe
with a refusal)" from "the transport failed" by exception class, never
by string matching. The HTTP status mapping is fixed wire schema:

- 503 -> :class:`Overloaded` (admission queue full; honors Retry-After)
- 429 -> :class:`BreakerOpen` (per-client circuit breaker; Retry-After)
- 504 -> :class:`DeadlineExpired` (the batch aged past its deadline
  before execution: the server expired it instead of serving it late)
- 409 -> :class:`KeyConflict` (same idempotency key, different body:
  refused, never replayed; a retry must be byte-identical)
- 400 -> :class:`RequestRefused` (malformed envelope)
- connect/read failures, torn bodies -> :class:`Unreachable` /
  :class:`TornResponse`

``is_retryable`` walks the ``__cause__`` chain so a wrapped fault
classifies like its root cause. The chaos seam (``set_net_fault_injector``
/ ``net_fault``) sits inside :class:`HttpTransport` where a real network
would fail; ``workloads/chaos.py::inject_net`` installs seeded schedules
of refused connections, torn responses and delayed replies.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Callable, Optional

WIRE_VERSION = 1
DEFAULT_TIMEOUT_S = 30.0


# -- typed faults ---------------------------------------------------------


class TransportFault(RuntimeError):
    """Base: the conversation with the server did not produce a usable
    answer. ``retryable`` says whether an idempotent retry can help;
    ``retry_after`` carries the server's Retry-After hint (seconds)
    when one was sent."""

    retryable = True

    def __init__(self, message: str, retry_after: Optional[float] = None):
        super().__init__(message)
        self.retry_after = retry_after


class Unreachable(TransportFault):
    """Connection refused / reset / DNS failure: no server answered.
    Retryable — the drill shape is 'server SIGKILLed, client retries
    to its restart'."""


class TornResponse(TransportFault):
    """The server (or the network) died mid-reply: short read, invalid
    JSON body. The request MAY have executed — which is exactly why
    every envelope carries an idempotency key: the retry is answered
    from the server's dedup window instead of re-executing."""


class Overloaded(TransportFault):
    """HTTP 503: the bounded admission queue shed this request. The
    server is alive and SAYING it is saturated — back off for
    ``retry_after`` and retry."""


class BreakerOpen(TransportFault):
    """HTTP 429: this client tripped the per-client circuit breaker
    (retry storm). Retryable only after the cooldown."""


class DeadlineExpired(TransportFault):
    """HTTP 504: the batch's deadline passed before execution; the
    server expired it instead of serving it late. NOT retryable — the
    answer would be just as late."""

    retryable = False


class RequestRefused(TransportFault):
    """HTTP 400: the envelope itself is malformed. A retry of the same
    bytes re-refuses."""

    retryable = False


class KeyConflict(RequestRefused):
    """HTTP 409: idempotency key reuse with a DIFFERENT body digest.
    The dedup window answers only byte-identical retries; anything else
    is a client bug surfaced loudly, never replayed."""


def is_retryable(e: BaseException) -> bool:
    """Can an idempotent retry of the same envelope help? Walks the
    explicit ``raise X from e`` cause chain (the resources.py
    discipline) so a wrapped fault classifies like its root cause."""
    depth = 0
    while isinstance(e, BaseException) and depth < 8:
        if isinstance(e, TransportFault):
            return e.retryable
        e = e.__cause__
        depth += 1
    return False


# -- envelope helpers -----------------------------------------------------


def make_key() -> str:
    """A client-generated idempotency key: 128 random bits. Generated
    ONCE per logical request and reused verbatim on every retry — the
    key identifies the intent, not the attempt."""
    return os.urandom(16).hex()


def ops_digest(ops: list) -> str:
    """The body fingerprint the server checks on key reuse: canonical
    JSON (sorted keys) so a semantically identical retry hashes
    identically regardless of dict construction order."""
    return hashlib.sha256(
        json.dumps(ops, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()


def envelope(
    ops: list,
    key: Optional[str] = None,
    client: Optional[str] = None,
    deadline_s: Optional[float] = None,
) -> dict:
    """Build one batched request envelope. ``deadline_s`` is relative
    seconds from now; the wire carries the ABSOLUTE ``deadline_ts`` so
    queue wait on the server side counts against it."""
    env = {
        "version": WIRE_VERSION,
        "key": key or make_key(),
        "client": client or f"pid-{os.getpid()}",
        "digest": ops_digest(ops),
        "deadline_ts": None if deadline_s is None else time.time() + deadline_s,
        "ops": list(ops),
    }
    return env


# -- chaos seam -----------------------------------------------------------
#
# Direct-call injector hook in the utils/resources.py style: a seeded
# schedule installed for a drill (workloads/chaos.py inject_net),
# uninstalled in a finally. Stages: "connect" (before the TCP connect),
# "send" (before the request body is written), "read" (before the
# response is read) — the three places a real network fails.

_NET_FAULTS: Optional[Callable[[str, str], None]] = None


def set_net_fault_injector(fn: Optional[Callable[[str, str], None]]) -> None:
    global _NET_FAULTS
    _NET_FAULTS = fn


def net_fault(stage: str, url: str) -> None:
    if _NET_FAULTS is not None:
        _NET_FAULTS(stage, url)


# -- the transport --------------------------------------------------------


class HttpTransport:
    """One server endpoint, stdlib ``http.client`` only. ``call`` POSTs
    a JSON payload and returns the decoded JSON answer or raises a
    typed fault; it never returns a half-answer."""

    def __init__(self, base_url: str, timeout: float = DEFAULT_TIMEOUT_S):
        from urllib.parse import urlparse

        u = urlparse(base_url)
        if u.scheme not in ("http", ""):
            raise ValueError(f"only http:// endpoints are supported, got {base_url!r}")
        if not u.hostname:
            raise ValueError(f"no host in url {base_url!r}")
        self.host = u.hostname
        self.port = u.port or 80
        self.timeout = timeout
        self.base_url = f"http://{self.host}:{self.port}"

    def call(self, path: str, payload: Optional[dict] = None, method: str = "POST") -> dict:
        import http.client

        url = f"{self.base_url}{path}"
        conn = http.client.HTTPConnection(self.host, self.port, timeout=self.timeout)
        try:
            try:
                net_fault("connect", url)
                conn.connect()
                net_fault("send", url)
                body = None if payload is None else json.dumps(payload).encode()
                headers = {"Content-Type": "application/json"} if body else {}
                conn.request(method, path, body=body, headers=headers)
            except TransportFault:
                raise
            except (ConnectionError, OSError) as e:
                raise Unreachable(f"{url}: {e}") from e
            try:
                net_fault("read", url)
                resp = conn.getresponse()
                status = resp.status
                retry_after = _parse_retry_after(resp.getheader("Retry-After"))
                raw = resp.read()
            except TransportFault:
                raise
            except (ConnectionError, OSError, http.client.HTTPException) as e:
                # the reply never arrived whole: the request MAY have
                # executed — the idempotency key makes the retry safe
                raise TornResponse(f"{url}: {e}") from e
        finally:
            conn.close()
        try:
            ans = json.loads(raw) if raw else {}
        except ValueError as e:
            raise TornResponse(f"{url}: invalid JSON body ({e})") from e
        if status == 200:
            return ans
        detail = (ans.get("error") or {}).get("detail") if isinstance(ans, dict) else None
        msg = f"{url}: HTTP {status}" + (f" ({detail})" if detail else "")
        if status == 503:
            raise Overloaded(msg, retry_after=retry_after)
        if status == 429:
            raise BreakerOpen(msg, retry_after=retry_after)
        if status == 504:
            raise DeadlineExpired(msg)
        if status == 409:
            raise KeyConflict(msg)
        if status in (400, 404, 405):
            raise RequestRefused(msg)
        # anything else (500s from a contained handler fault) is
        # transport-shaped: the answer is unusable, a retry may land on
        # a healthy code path or a restarted server
        raise TornResponse(msg)


def _parse_retry_after(value: Optional[str]) -> Optional[float]:
    if value is None:
        return None
    try:
        return max(0.0, float(value))
    except ValueError:
        return None


def _jitter(key: str, attempt: int) -> float:
    """Deterministic jitter factor in [0.5, 1.5): seeded by (key,
    attempt) so retry storms from N clients decorrelate without any
    wall-clock or RNG dependence (same discipline as spool.retry_io's
    bounded backoff, but reproducible in drills)."""
    h = hashlib.sha256(f"retry:{key}:{attempt}".encode()).digest()
    return 0.5 + int.from_bytes(h[:8], "big") / 2**64


def call_with_retries(
    transport: HttpTransport,
    path: str,
    payload: dict,
    retries: int = 6,
    backoff_s: float = 0.05,
    max_backoff_s: float = 2.0,
    sleep=time.sleep,
) -> dict:
    """POST ``payload`` with capped jittered backoff on RETRYABLE
    transport faults, honoring Retry-After when the server sent one.
    The payload (and with it the idempotency key) is reused verbatim on
    every attempt — that is what makes the retry safe: a replay is
    answered from the server's dedup window, so reports journal exactly
    once no matter how many attempts the network cost. Non-retryable
    faults (DeadlineExpired, KeyConflict, RequestRefused) raise
    immediately."""
    key = str(payload.get("key") or "")
    attempt = 0
    while True:
        try:
            return transport.call(path, payload)
        except TransportFault as e:
            if not e.retryable or attempt >= retries:
                raise
            delay = min(backoff_s * (2**attempt), max_backoff_s) * _jitter(key, attempt)
            if e.retry_after is not None:
                delay = max(delay, e.retry_after)
            sleep(delay)
            attempt += 1

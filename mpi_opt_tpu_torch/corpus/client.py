"""``python -m mpi_opt_tpu_torch suggest-client``: the suggestion
service's thin client (port of ``mpi_opt_tpu/corpus/client.py``).

Torch-free and jax-free, like every service client: ``__main__``
dispatches it before torch loads. Two transports share one answer
schema, and both speak the JAX package's formats, so this client drives
a server of either package:

- the filesystem spool (requests are atomic JSON file drops, responses
  polled reads), so an outside sweep in any language can drive the
  suggestion tenant by copying this short protocol;
- the HTTP front door (``--url http://HOST:PORT``, ``service/http.py``):
  batched ops, idempotent retries with capped jittered backoff honoring
  Retry-After, and a typed fault funnel (``corpus/transport.py``) that
  tells "the server answered" from "the transport failed".

Subcommands::

    suggest-client --dir SDIR suggest -n 8
    suggest-client --url http://127.0.0.1:8713 suggest -n 8
    suggest-client --dir SDIR report --params '{"lr": 0.1}' --score 0.93 [--budget 20]
    suggest-client --dir SDIR lookup --params '{"lr": 0.1}' [--budget 20]
    suggest-client --dir SDIR stop
    suggest-client --dir SDIR bench --rounds 32 --batch 16
    suggest-client --url URL bench --rounds 32 --batch 16 --burst 4

``bench`` is the measured scenario: over the spool it is BENCH config 6
(serial suggest -> report round trips); over HTTP it is BENCH config 7
(``--burst`` concurrent conversations of a batched suggest and its
batched reports: one HTTP request and one journal fsync a report batch),
printing suggestions/s, p50/p95 round trips and the server-side queue
wait. :class:`SuggestHttpClient` also memoizes ``lookup`` answers by
params key, and clears the memo on ``report``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import OrderedDict
from typing import Optional

from mpi_opt_tpu_torch.service.spool import _read_json, _write_json_atomic


def request(sdir: str, payload: dict) -> str:
    """Drop one request; returns its id (nanosecond-stamped like spool
    job ids, so lexicographic order is submission order)."""
    rid = payload.get("id") or f"req-{time.time_ns():020d}-{os.getpid() % 100000:05d}"
    req_dir = os.path.join(sdir, "requests")
    os.makedirs(req_dir, exist_ok=True)
    _write_json_atomic(
        os.path.join(req_dir, f"{rid}.json"), dict(payload, id=rid)
    )
    return rid


def wait_response(
    sdir: str, rid: str, timeout: float = 30.0, poll: float = 0.01
) -> Optional[dict]:
    """Poll for the response; None on timeout (server down or wedged —
    the caller decides whether that is an error)."""
    path = os.path.join(sdir, "responses", f"{rid}.json")
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        ans = _read_json(path)
        if ans is not None:
            try:
                os.unlink(path)  # consume: responses are single-reader
            except OSError:
                pass
            return ans
        time.sleep(poll)
    return None


def round_trip(sdir: str, payload: dict, timeout: float = 30.0) -> dict:
    rid = request(sdir, payload)
    ans = wait_response(sdir, rid, timeout=timeout)
    if ans is None:
        raise TimeoutError(
            f"no response to {payload.get('op')!r} within {timeout}s — is a "
            f"suggestion server (--suggest-serve {sdir}) running?"
        )
    return ans


def request_stop(sdir: str) -> None:
    ctrl = os.path.join(sdir, "control")
    os.makedirs(ctrl, exist_ok=True)
    with open(os.path.join(ctrl, "stop"), "w") as f:
        f.write("")


def _synthetic_score(params: dict) -> float:
    """The bench's stand-in objective: a deterministic quadratic bowl
    over the numeric dims (closer to mid-range scores higher), so the
    served acquisition has a real surface to learn during the bench."""
    score = 0.0
    n = 0
    for v in params.values():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        score -= (float(v) - 0.5) ** 2
        n += 1
    return score if n else 0.0


def bench(sdir: str, rounds: int, batch: int, timeout: float = 60.0) -> dict:
    """``rounds`` suggest→report round trips of ``batch`` suggestions,
    every suggestion reported back: suggestions/s over the whole
    conversation plus p50/p95 per-request round-trip seconds."""
    trips: list = []

    def timed(payload):
        t0 = time.perf_counter()
        ans = round_trip(sdir, payload, timeout=timeout)
        trips.append(time.perf_counter() - t0)
        if ans.get("error"):
            raise RuntimeError(f"server refused {payload.get('op')!r}: {ans['error']}")
        return ans

    timed({"op": "suggest", "n": batch})  # warm the server's first suggestion
    t0 = time.perf_counter()
    n_suggestions = 0
    for _ in range(rounds):
        ans = timed({"op": "suggest", "n": batch})
        got = ans.get("params") or []
        n_suggestions += len(got)
        for params in got:
            timed(
                {
                    "op": "report",
                    "params": params,
                    "score": _synthetic_score(params),
                    "budget": 1,
                }
            )
    wall = time.perf_counter() - t0
    trips_sorted = sorted(trips)

    def pct(p):
        return trips_sorted[min(len(trips_sorted) - 1, int(p * len(trips_sorted)))]

    return {
        "rounds": rounds,
        "batch": batch,
        "suggestions": n_suggestions,
        "requests": len(trips),
        "wall_s": round(wall, 3),
        "suggestions_per_sec": round(n_suggestions / max(wall, 1e-9), 2),
        "round_trip_p50_s": round(pct(0.50), 4),
        "round_trip_p95_s": round(pct(0.95), 4),
    }


# -- the HTTP mode --------------------------------------------------------


def discover_url(sdir: str, timeout: float = 10.0, poll: float = 0.05) -> str:
    """Resolve a front door's URL from its spool's endpoint file
    (``SDIR/control/http.json``, written atomically after the bind) —
    how clients find an ``--http-port 0`` ephemeral server without
    racing the bind."""
    from mpi_opt_tpu_torch.service.http import endpoint_path

    path = endpoint_path(sdir)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        doc = _read_json(path)
        if doc and doc.get("url"):
            return str(doc["url"])
        time.sleep(poll)
    raise TimeoutError(
        f"no HTTP endpoint published at {path} within {timeout}s — is a "
        f"front door (--suggest-serve SDIR --http-port N) running?"
    )


class SuggestHttpClient:
    """One client's conversation with the front door: batched envelopes,
    idempotent retries, and a bounded lookup memo.

    Every :meth:`batch` generates ONE idempotency key and reuses it
    verbatim across retries, so a torn response or a server restart
    mid-request can never double-journal a report. ``lookup`` answers
    memoize by canonical params key; ``report`` clears the memo — a
    report shifts the server's near-match priors for OTHER keys too, so
    per-key invalidation would serve stale priors."""

    def __init__(
        self,
        url: str,
        client_id: Optional[str] = None,
        timeout: float = 30.0,
        retries: int = 6,
        backoff_s: float = 0.05,
        cache_size: int = 256,
        sleep=time.sleep,
    ):
        from mpi_opt_tpu_torch.corpus import transport

        self.transport = transport.HttpTransport(url, timeout=timeout)
        self.client_id = client_id or f"pid-{os.getpid()}"
        self.retries = retries
        self.backoff_s = backoff_s
        self.cache_size = cache_size
        self._sleep = sleep
        self._lookup_memo: "OrderedDict" = OrderedDict()
        self.stats = {"batches": 0, "replayed": 0, "lookup_hits": 0}

    def batch(self, ops: list, deadline_s: Optional[float] = None) -> dict:
        from mpi_opt_tpu_torch.corpus import transport

        env = transport.envelope(ops, client=self.client_id, deadline_s=deadline_s)
        ans = transport.call_with_retries(
            self.transport,
            "/v1/batch",
            env,
            retries=self.retries,
            backoff_s=self.backoff_s,
            sleep=self._sleep,
        )
        self.stats["batches"] += 1
        if ans.get("replayed"):
            self.stats["replayed"] += 1
        return ans

    def _one(self, op: dict, deadline_s: Optional[float] = None) -> dict:
        return self.batch([op], deadline_s=deadline_s)["results"][0]

    def suggest(self, n: int = 1, deadline_s: Optional[float] = None) -> dict:
        return self._one({"op": "suggest", "n": int(n)}, deadline_s=deadline_s)

    def report(self, params: dict, score: float, budget: int = 0) -> dict:
        ans = self._one(
            {"op": "report", "params": params, "score": float(score),
             "budget": int(budget)}
        )
        self._lookup_memo.clear()
        return ans

    def lookup(self, params: dict, budget: int = 0) -> dict:
        key = json.dumps(
            {"params": params, "budget": int(budget)},
            sort_keys=True, separators=(",", ":"),
        )
        hit = self._lookup_memo.get(key)
        if hit is not None:
            self._lookup_memo.move_to_end(key)
            self.stats["lookup_hits"] += 1
            return dict(hit)
        ans = self._one({"op": "lookup", "params": params, "budget": int(budget)})
        if not ans.get("error"):
            self._lookup_memo[key] = dict(ans)
            while len(self._lookup_memo) > self.cache_size:
                self._lookup_memo.popitem(last=False)
        return ans

    def stop(self) -> dict:
        return self.transport.call("/v1/stop", {})


def bench_http(
    url: str,
    rounds: int,
    batch: int,
    burst: int = 4,
    timeout: float = 60.0,
    deadline_s: Optional[float] = None,
) -> dict:
    """BENCH config 7's measured scenario: ``burst`` concurrent clients
    each run ``rounds`` conversations of [one suggest batch, then ALL
    its reports in one batched request] — open-loop enough to keep the
    admission queue non-empty, while every report still journals
    exactly once. Reports suggestions/s over the whole conversation,
    client round-trip p50/p95, and the SERVER-side p95 queue wait (from
    each answer's ``queue_wait_s`` — the number the shedding bound is
    judged on)."""
    import threading

    trips: list = []
    waits: list = []
    counts = {"suggestions": 0, "requests": 0, "replayed": 0}
    lock = threading.Lock()
    errors: list = []

    def one_client(idx: int) -> None:
        cli = SuggestHttpClient(
            url, client_id=f"bench-{os.getpid()}-{idx}", timeout=timeout
        )
        try:
            for _ in range(rounds):
                t0 = time.perf_counter()
                ans = cli.batch([{"op": "suggest", "n": batch}],
                                deadline_s=deadline_s)
                dt = time.perf_counter() - t0
                sugg = ans["results"][0]
                if sugg.get("error"):
                    raise RuntimeError(f"suggest refused: {sugg['error']}")
                got = sugg.get("params") or []
                ops = [
                    {"op": "report", "params": p,
                     "score": _synthetic_score(p), "budget": 1}
                    for p in got
                ]
                t1 = time.perf_counter()
                rep = cli.batch(ops, deadline_s=deadline_s) if ops else None
                dt2 = time.perf_counter() - t1
                with lock:
                    trips.append(dt)
                    waits.append(float(ans.get("queue_wait_s") or 0.0))
                    counts["requests"] += 1
                    counts["suggestions"] += len(got)
                    if rep is not None:
                        trips.append(dt2)
                        waits.append(float(rep.get("queue_wait_s") or 0.0))
                        counts["requests"] += 1
                        counts["replayed"] += int(bool(rep.get("replayed")))
        except Exception as e:  # noqa: BLE001 - a bench worker reports, never hangs the join
            with lock:
                errors.append(f"client {idx}: {type(e).__name__}: {e}")

    # Warm the server outside the timed window: the first suggest runs
    # the startup sampler; reporting it pushes n_obs past n_startup, so
    # the SECOND suggest runs the acquisition for the first time (the
    # card's first launches of it) — one-time costs the steady-state
    # number must not absorb.
    warm = SuggestHttpClient(url, client_id="bench-warmup", timeout=timeout)
    got = warm.suggest(batch).get("params") or []
    warm.batch(
        [{"op": "report", "params": p, "score": _synthetic_score(p), "budget": 1}
         for p in got]
    )
    warm.suggest(batch)
    t0 = time.perf_counter()
    threads = [
        threading.Thread(target=one_client, args=(i,), daemon=True)
        for i in range(burst)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(timeout * rounds, 120.0))
    wall = time.perf_counter() - t0
    if errors:
        raise RuntimeError("; ".join(errors[:3]))
    trips_sorted = sorted(trips) or [0.0]
    waits_sorted = sorted(waits) or [0.0]

    def pct(xs, p):
        return xs[min(len(xs) - 1, int(p * len(xs)))]

    return {
        "rounds": rounds,
        "batch": batch,
        "burst": burst,
        "suggestions": counts["suggestions"],
        "requests": counts["requests"],
        "replayed": counts["replayed"],
        "wall_s": round(wall, 3),
        "suggestions_per_sec": round(counts["suggestions"] / max(wall, 1e-9), 2),
        "round_trip_p50_s": round(pct(trips_sorted, 0.50), 4),
        "round_trip_p95_s": round(pct(trips_sorted, 0.95), 4),
        "queue_wait_p50_s": round(pct(waits_sorted, 0.50), 4),
        "queue_wait_p95_s": round(pct(waits_sorted, 0.95), 4),
    }


def client_main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="mpi_opt_tpu_torch suggest-client",
        description="drive a suggestion server (--suggest-serve) over "
        "its filesystem spool or its HTTP front door (--url)",
    )
    p.add_argument(
        "--dir",
        metavar="SDIR",
        help="the suggestion spool directory (shared with the server)",
    )
    p.add_argument(
        "--url",
        metavar="URL",
        help="HTTP front door endpoint (http://HOST:PORT); with --dir "
        "and no --url, the spool's control/http.json is NOT consulted — "
        "the filesystem protocol is used",
    )
    p.add_argument("--timeout", type=float, default=30.0, help="response wait")
    sub = p.add_subparsers(dest="op", required=True)
    sp = sub.add_parser("suggest", help="ask for acquisition-ranked points")
    sp.add_argument("-n", type=int, default=1, help="suggestions to fetch")
    rp = sub.add_parser("report", help="report one completed evaluation")
    rp.add_argument("--params", required=True, help="canonical params JSON")
    rp.add_argument("--score", type=float, required=True)
    rp.add_argument("--budget", type=int, default=0)
    lp = sub.add_parser("lookup", help="exact/near-match prior lookup")
    lp.add_argument("--params", required=True, help="canonical params JSON")
    lp.add_argument("--budget", type=int, default=0)
    sub.add_parser("stop", help="flag the server to finish and exit 0")
    bp = sub.add_parser("bench", help="measured suggest→report round trips")
    bp.add_argument("--rounds", type=int, default=16)
    bp.add_argument("--batch", type=int, default=16)
    bp.add_argument(
        "--burst", type=int, default=4,
        help="concurrent clients (HTTP mode only; the spool bench is serial)",
    )
    args = p.parse_args(argv)
    if not args.dir and not args.url:
        p.error("need --dir SDIR (filesystem spool) or --url URL (HTTP)")

    from mpi_opt_tpu_torch.corpus import transport
    from mpi_opt_tpu_torch.utils.exitcodes import EX_PROTOCOL, EX_UNAVAILABLE

    try:
        if args.url:
            return _http_main(args, p)
        if args.op == "stop":
            request_stop(args.dir)
            print(json.dumps({"stop": True}))
            return 0
        if args.op == "bench":
            print(json.dumps(bench(args.dir, args.rounds, args.batch, args.timeout)))
            return 0
        payload: dict = {"op": args.op}
        if args.op == "suggest":
            payload["n"] = args.n
        else:
            try:
                payload["params"] = json.loads(args.params)
            except ValueError as e:
                p.error(f"--params must be JSON: {e}")
            payload["budget"] = args.budget
            if args.op == "report":
                payload["score"] = args.score
        ans = round_trip(args.dir, payload, timeout=args.timeout)
    except transport.RequestRefused as e:
        # the server ANSWERED with a typed protocol refusal (409/400):
        # retrying the same bytes re-refuses — distinct exit code so
        # scripts never blind-retry a client bug
        print(str(e), file=sys.stderr)
        return EX_PROTOCOL
    except transport.TransportFault as e:
        # retries exhausted (or a non-retryable expiry): the service is
        # unavailable from here — sysexits EX_UNAVAILABLE
        print(str(e), file=sys.stderr)
        return EX_UNAVAILABLE
    except (TimeoutError, RuntimeError) as e:
        print(str(e), file=sys.stderr)
        return 1
    print(json.dumps(ans))
    return 0 if not ans.get("error") else 1


def _http_main(args, p) -> int:
    """The --url route of ``client_main`` (same answer schema as the
    spool route; transport faults propagate to client_main's funnel)."""
    if args.op == "bench":
        print(
            json.dumps(
                bench_http(
                    args.url, args.rounds, args.batch,
                    burst=args.burst, timeout=args.timeout,
                )
            )
        )
        return 0
    cli = SuggestHttpClient(args.url, timeout=args.timeout)
    if args.op == "stop":
        print(json.dumps(cli.stop()))
        return 0
    if args.op == "suggest":
        ans = cli.suggest(args.n)
    else:
        try:
            params = json.loads(args.params)
        except ValueError as e:
            p.error(f"--params must be JSON: {e}")
        if args.op == "report":
            ans = cli.report(params, args.score, args.budget)
        else:
            ans = cli.lookup(params, args.budget)
    print(json.dumps(ans))
    return 0 if not ans.get("error") else 1

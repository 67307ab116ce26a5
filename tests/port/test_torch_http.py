"""The port's HTTP front door (``mpi_opt_tpu_torch/service/http.py``), its
wire (``corpus/transport.py``), its client (``corpus/client.py``) and the
network-fault drills (``workloads/chaos.py::inject_net``) against the JAX
package's, on the CPU.

- ``ops_digest``, the envelope's fields, ``_jitter``, ``is_retryable``
  and the ``NetFaultInjector`` schedules equal the JAX functions', called
  live; ``call_with_retries`` and the status -> fault mapping are
  ``tests/test_http.py``'s cases on the port.
- ``FrontDoor``: ``tests/test_http.py``'s admission cases (validation,
  replay, the 409, window eviction, shed then breaker, the wedged
  executor, the in-flight attach, the 504), a report batch costing one
  fsync, and a restarted front door replaying reports from its journal.
- Over a real socket (127.0.0.1, port 0): the two end-to-end cases, the
  sweep service's ops through ``--http-state-dir``'s spool, the JAX
  client against the port's front door and the port's client against the
  JAX one.
"""

import contextlib
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import mpi_opt_tpu.corpus.transport as jtransport
import mpi_opt_tpu.workloads.chaos as jchaos
from mpi_opt_tpu.corpus.client import SuggestHttpClient as JSuggestHttpClient
from mpi_opt_tpu_torch.corpus import transport
from mpi_opt_tpu_torch.corpus.client import SuggestHttpClient, discover_url
from mpi_opt_tpu_torch.corpus.serve import SuggestServer
from mpi_opt_tpu_torch.ledger import SweepLedger
from mpi_opt_tpu_torch.service.http import FrontDoor, _Work, endpoint_path, serve_http
from mpi_opt_tpu_torch.service.spool import Spool
from mpi_opt_tpu_torch.utils.metrics import MetricsLogger, null_logger
from mpi_opt_tpu_torch.workloads import chaos, get_workload

_FAST_SLEEP = lambda s: time.sleep(min(s, 0.01))  # noqa: E731 - test retry pacing


def live_space():
    return get_workload("quadratic").default_space()


def _env(ops, key=None, client="t", deadline_s=None):
    return transport.envelope(ops, key=key, client=client, deadline_s=deadline_s)


def _noop_ops(tag="a"):
    # an unknown op executes without a backend: its answer is a per-op
    # error, which is what the admission cases need
    return [{"op": "noop", "tag": tag}]


@contextlib.contextmanager
def executor_thread(front):
    """Drive a FrontDoor's queue as serve_http's caller thread does,
    without a socket."""
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            try:
                work = front.queue.get(timeout=0.01)
            except queue.Empty:
                continue
            front.run_one(work)

    th = threading.Thread(target=loop, daemon=True)
    th.start()
    try:
        yield
    finally:
        stop.set()
        th.join(timeout=5)


def _suggest_front(tmp_path, name="fd", **fd_kw):
    space = live_space()
    led = SweepLedger(str(tmp_path / f"{name}.jsonl"))
    led.ensure_header({"mode": "suggest", "algorithm": "tpe", "workload": "quadratic",
                       "backend": "suggest", "seed": 0, "space_hash": space.space_hash()},
                      space_spec=space.spec())
    return FrontDoor(suggest=SuggestServer(space, seed=0, device="cpu"), ledger=led, **fd_kw), led


@contextlib.contextmanager
def front_door(tmp_path, name="fd", metrics=None, **fd_kw):
    """A served front door: serve_http in a thread, the URL read from the
    endpoint file, stopped by POST /v1/stop."""
    front, led = _suggest_front(tmp_path, name=name, **fd_kw)
    sdir = str(tmp_path / f"{name}-spool")
    box = {}

    def run():
        try:
            box["summary"] = serve_http(front, sdir, metrics or null_logger(), poll_seconds=0.01)
        except BaseException as e:  # noqa: BLE001 - surfaced after the join
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        url = discover_url(sdir, timeout=20)
        yield url, front, led, sdir, box
    finally:
        with contextlib.suppress(Exception):
            transport.HttpTransport(url, timeout=5).call("/v1/stop", {})
        th.join(timeout=20)
        led.close()
        if "error" in box:
            raise box["error"]


def _ledger_lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f.read().splitlines()[1:]]


# -- the wire against the JAX package's ------------------------------------


OPS = [
    [{"op": "report", "score": 1.0, "params": {"lr": 0.1, "reg": 0.2}}],
    [{"params": {"reg": 0.2, "lr": 0.1}, "score": 1.0, "op": "report"}],
    [{"op": "suggest", "n": 3}, {"op": "lookup", "params": {"lr": 2.5}, "budget": 9}],
    [{"op": "submit", "argv": ["--workload", "quadratic"], "tenant": "ü"}],
]


@pytest.mark.parametrize("ops", OPS)
def test_ops_digest_and_envelope_equal_jax(ops):
    assert transport.ops_digest(ops) == jtransport.ops_digest(ops)
    e, j = (m.envelope(ops, key="k", client="c", deadline_s=None) for m in (transport, jtransport))
    assert e == j and transport.WIRE_VERSION == jtransport.WIRE_VERSION
    assert transport.ops_digest(OPS[0]) == transport.ops_digest(OPS[1])  # key order
    fresh = transport.envelope(ops, deadline_s=5.0)
    assert len(fresh["key"]) == 32 and fresh["client"] == f"pid-{os.getpid()}"
    assert abs(fresh["deadline_ts"] - (time.time() + 5.0)) < 1.0


def test_jitter_equals_jax():
    vals = [transport._jitter(k, a) for k in ("k", "other", "") for a in range(16)]
    assert vals == [jtransport._jitter(k, a) for k in ("k", "other", "") for a in range(16)]
    assert all(0.5 <= v < 1.5 for v in vals) and len(set(vals)) > 40


def test_faults_and_retryability_equal_jax():
    names = ("TransportFault", "Unreachable", "TornResponse", "Overloaded", "BreakerOpen",
             "DeadlineExpired", "RequestRefused", "KeyConflict")
    for name in names:
        tcls, jcls = getattr(transport, name), getattr(jtransport, name)
        assert tcls.retryable == jcls.retryable, name
        assert [c.__name__ for c in tcls.__mro__] == [c.__name__ for c in jcls.__mro__]
        assert transport.is_retryable(tcls("x")) == jtransport.is_retryable(jcls("x"))
        wrapped = RuntimeError("wrapped")
        wrapped.__cause__ = tcls("x")
        assert transport.is_retryable(wrapped) == tcls.retryable
    assert transport.is_retryable(RuntimeError("plain")) is False
    assert transport._parse_retry_after("1.5") == 1.5 and transport._parse_retry_after("x") is None


@pytest.mark.parametrize("refuse,torn,delay,seed,window", [
    (1, 1, 0, 3, None), (3, 2, 4, 0, 50), (5, 5, 5, 7, 12), (0, 0, 2, 1, 4)])
def test_net_fault_ordinals_equal_jax(refuse, torn, delay, seed, window):
    """The same per-stage ordinals fire in both packages' injectors."""
    fired = []
    for mod, tmod in ((chaos, transport), (jchaos, jtransport)):
        inj = mod.NetFaultInjector(refuse=refuse, torn=torn, delay=delay, delay_s=0.0, seed=seed,
                                   ops_window=window)
        out = []
        for i in range(60):
            stage = ("connect", "send", "read")[i % 3]
            try:
                inj(stage, "http://x")
                out.append(None)
            except tmod.TransportFault as e:
                out.append(type(e).__name__)
        fired.append((out, inj.faults_fired))
    assert fired[0] == fired[1]


def test_inject_net_installs_and_uninstalls_the_seam(tmp_path):
    injector, uninstall = chaos.inject_net(refuse=1, seed=0)
    try:
        assert transport._NET_FAULTS is injector
        with pytest.raises(transport.Unreachable, match="chaos: injected connection refused"):
            transport.HttpTransport("http://127.0.0.1:9", timeout=1).call("/v1/batch", {})
    finally:
        uninstall()
    assert transport._NET_FAULTS is None


class _StubTransport:
    def __init__(self, faults):
        self.faults = list(faults)
        self.payloads = []

    def call(self, path, payload):
        self.payloads.append(payload)
        if self.faults:
            raise self.faults.pop(0)
        return {"ok": True, "key": payload["key"]}


def test_call_with_retries_reuses_payload_and_honors_retry_after():
    stub = _StubTransport([transport.Unreachable("refused"),
                           transport.Overloaded("shed", retry_after=0.7)])
    delays = []
    env = _env(_noop_ops())
    ans = transport.call_with_retries(stub, "/v1/batch", env, retries=6, backoff_s=0.01,
                                      sleep=delays.append)
    assert ans["ok"] is True and ans["key"] == env["key"]
    # the same payload (and key) every attempt: the retry is idempotent
    assert all(p is env for p in stub.payloads) and len(stub.payloads) == 3
    assert len(delays) == 2 and delays[1] >= 0.7  # Retry-After is a floor
    assert delays[0] == pytest.approx(0.01 * jtransport._jitter(env["key"], 0))


def test_call_with_retries_raises_nonretryable_immediately_and_exhausts():
    stub = _StubTransport([transport.KeyConflict("409")])
    with pytest.raises(transport.KeyConflict):
        transport.call_with_retries(stub, "/v1/batch", _env(_noop_ops()), sleep=lambda s: None)
    assert len(stub.payloads) == 1
    stub = _StubTransport([transport.TornResponse("torn")] * 3)
    with pytest.raises(transport.TornResponse):
        transport.call_with_retries(stub, "/v1/batch", _env(_noop_ops()), retries=2,
                                    sleep=lambda s: None)
    assert len(stub.payloads) == 3  # the first attempt and 2 retries


class _CannedHandler(BaseHTTPRequestHandler):
    def log_message(self, *a):  # noqa: D102
        pass

    def do_POST(self):  # noqa: N802
        try:
            self.rfile.read(int(self.headers.get("Content-Length") or 0))
            if self.path == "/torn":
                raw, code = b"{half a reply", 200
            else:
                code = int(self.path.rsplit("/", 1)[1])
                raw = (b'{"ok": true}' if code == 200 else
                       json.dumps({"error": {"kind": "canned", "detail": "x"}}).encode())
            self.send_response(code)
            if code in (503, 429):
                self.send_header("Retry-After", "1.5")
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)
        except Exception:  # noqa: BLE001 - a canned server answers or drops
            pass


def test_transport_status_mapping():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _CannedHandler)
    th = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05}, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    t = transport.HttpTransport(url, timeout=5)
    try:
        assert t.call("/code/200", {}) == {"ok": True}
        for code, exc in [(503, transport.Overloaded), (429, transport.BreakerOpen),
                          (504, transport.DeadlineExpired), (409, transport.KeyConflict),
                          (400, transport.RequestRefused), (404, transport.RequestRefused),
                          (500, transport.TornResponse)]:
            with pytest.raises(exc) as ei:
                t.call(f"/code/{code}", {})
            if code in (503, 429):
                assert ei.value.retry_after == 1.5
        with pytest.raises(transport.TornResponse):
            t.call("/torn", {})
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=5)
    with pytest.raises(transport.Unreachable):  # nobody answers now
        t.call("/code/200", {})
    with pytest.raises(ValueError):
        transport.HttpTransport("https://127.0.0.1:1")


# -- FrontDoor admission (no socket) -------------------------------------------


def test_validate_refuses_malformed_envelopes():
    front = FrontDoor()
    bad = [
        "not a dict",
        {"key": "k", "ops": []},
        {"key": "", "ops": _noop_ops()},
        {"ops": _noop_ops()},
        {"key": "k", "ops": "nope"},
        {"key": "k", "ops": [1, 2]},
        {"key": "k", "ops": _noop_ops(), "version": 99},
        {"key": "k", "ops": _noop_ops(), "digest": "feed"},
        {"key": "k", "ops": _noop_ops(), "deadline_ts": "soon"},
        {"key": "k", "ops": [{"op": "x"}] * 1025},
    ]
    for env in bad:
        refused = front.validate(env)
        assert refused is not None and refused[0] == 400, env
    assert front.validate({"key": "k", "ops": _noop_ops()}) is None


def test_admit_executes_then_replays_byte_identical_retry():
    front = FrontDoor()
    env = _env(_noop_ops())
    with executor_thread(front):
        status, body, _ = front.admit(env)
        assert status == 200 and body["replayed"] is False
        assert "unknown op" in body["results"][0]["error"]
        status2, body2, _ = front.admit(dict(env))
        assert status2 == 200 and body2["replayed"] is True
        assert body2["results"] == body["results"]
    assert front.counters["batches"] == 1 and front.counters["replayed"] == 1


def test_same_key_different_body_is_409_never_replayed():
    front = FrontDoor()
    env = _env(_noop_ops("a"))
    with executor_thread(front):
        assert front.admit(env)[0] == 200
        status, body, _ = front.admit(_env(_noop_ops("b"), key=env["key"]))
    assert status == 409 and body["error"]["kind"] == "key_conflict"
    assert front.counters["conflicts"] == 1 and front.counters["batches"] == 1


def test_window_evicts_oldest_and_reexecutes_evicted_key():
    front = FrontDoor(window_size=2)
    envs = [_env(_noop_ops(t)) for t in "abc"]
    with executor_thread(front):
        for env in envs:
            assert front.admit(env)[0] == 200
        assert len(front._window) == 2  # "a" evicted
        status, body, _ = front.admit(dict(envs[0]))
        assert status == 200 and body["replayed"] is False  # executed again
    assert front.counters["batches"] == 4 and front.counters["replayed"] == 0


def test_shed_at_queue_bound_then_breaker_trips():
    front = FrontDoor(queue_depth=1, breaker_strikes=2, breaker_cooldown_s=30.0)
    front.queue.put_nowait(object())  # wedge the queue at capacity
    s1, b1, ra1 = front.admit(_env(_noop_ops("a"), client="storm"))
    assert s1 == 503 and b1["error"]["kind"] == "overloaded" and ra1 == front.shed_retry_after_s
    s2, _, _ = front.admit(_env(_noop_ops("b"), client="storm"))
    assert s2 == 503  # the second strike trips the breaker
    s3, b3, ra3 = front.admit(_env(_noop_ops("c"), client="storm"))
    assert s3 == 429 and b3["error"]["kind"] == "breaker_open" and ra3 > 0
    s4, b4, _ = front.admit(_env(_noop_ops("d"), client="calm"))  # another client is not punished
    assert s4 == 503 and b4["error"]["kind"] == "overloaded"
    assert front.counters["shed"] == 3 and front.counters["breaker_trips"] == 1


def test_wedged_executor_answers_typed_503_not_a_hang():
    front = FrontDoor(max_wait_s=0.05)  # nobody drains the queue
    t0 = time.monotonic()
    status, body, retry_after = front.admit(_env(_noop_ops()))
    assert status == 503 and "no executor answer" in body["error"]["detail"]
    assert retry_after is not None and time.monotonic() - t0 < 5.0


def test_concurrent_same_key_retry_attaches_to_inflight_work():
    front = FrontDoor()
    env = _env(_noop_ops())
    answers = []

    def admit(e):
        answers.append(front.admit(e))

    t1 = threading.Thread(target=admit, args=(dict(env),), daemon=True)
    t1.start()
    deadline = time.monotonic() + 5
    while not front._pending and time.monotonic() < deadline:
        time.sleep(0.005)
    assert front._pending  # the first admit is parked in flight
    t2 = threading.Thread(target=admit, args=(dict(env),), daemon=True)
    t2.start()
    while front._pending[env["key"]].waiters < 2 and time.monotonic() < deadline:
        time.sleep(0.005)
    with executor_thread(front):
        t1.join(timeout=5)
        t2.join(timeout=5)
    assert sorted(a[0] for a in answers) == [200, 200]
    # one execution answered both waiters; the attached retry is marked
    assert front.counters["batches"] == 1
    assert sorted(a[1]["replayed"] for a in answers) == [False, True]


def test_deadline_expired_at_dequeue_is_504():
    front = FrontDoor()
    env = _env(_noop_ops(), deadline_s=-0.5)  # late on arrival
    with executor_thread(front):
        status, body, _ = front.admit(env)
    assert status == 504 and body["error"]["kind"] == "deadline_expired"
    assert front.counters["expired"] == 1 and front.counters["batches"] == 0


# -- the durable half: reports journal exactly once ------------------------------


def test_report_batch_costs_one_fsync_and_stamps_idem_meta(tmp_path, monkeypatch):
    front, led = _suggest_front(tmp_path)
    params = front.suggest.suggest(3)["params"]
    env = _env([{"op": "report", "params": p, "score": 0.5, "budget": 1} for p in params],
               key="k-batch")
    assert front.validate(env) is None
    fsyncs = []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: (fsyncs.append(fd), real_fsync(fd)))
    work = _Work(env)
    front.run_one(work)
    assert work.status == 200
    assert [r["trial_id"] for r in work.response["results"]] == [0, 1, 2]
    assert len(fsyncs) == 1  # three journaled reports, one fsync
    assert [(r["idem_key"], r["idem_op"]) for r in _ledger_lines(led.path)] == [
        ("k-batch", 0), ("k-batch", 1), ("k-batch", 2)]
    led.close()


def test_restarted_front_door_replays_reports_from_its_journal(tmp_path):
    front, led = _suggest_front(tmp_path)
    params = front.suggest.suggest(2)["params"]
    ops = [{"op": "report", "params": p, "score": 0.25, "budget": 1} for p in params]
    with executor_thread(front):
        status, body, _ = front.admit(_env(ops, key="k-durable"))
        assert status == 200 and not any(r.get("error") for r in body["results"])
    assert len(_ledger_lines(led.path)) == 2
    led.close()  # the first server is gone; its journal survives
    led2 = SweepLedger(str(led.path))
    server2 = SuggestServer(live_space(), seed=0, device="cpu")
    server2.seed_from_ledger(led2.records)
    front2 = FrontDoor(suggest=server2, ledger=led2)
    # the client's retry reaches the restart with the same key: the
    # journal-seeded index answers it without journaling again
    work = _Work(transport.envelope(ops, key="k-durable", client="t"))
    front2.run_one(work)
    assert work.status == 200
    assert all(r.get("journal_replayed") for r in work.response["results"])
    assert [r["trial_id"] for r in work.response["results"]] == [0, 1]
    assert len(_ledger_lines(led2.path)) == 2  # exactly once, across the restart
    led2.close()


# -- end to end over a real socket ------------------------------------------------


def test_e2e_suggest_report_lookup_deadline_and_lifecycle(tmp_path):
    mpath = tmp_path / "fd-metrics.jsonl"
    metrics = MetricsLogger(path=str(mpath))
    with front_door(tmp_path, metrics=metrics) as (url, front, led, sdir, box):
        cli = SuggestHttpClient(url, client_id="e2e", timeout=10, sleep=_FAST_SLEEP)
        params = cli.suggest(3)["params"]
        assert len(params) == 3
        rep = cli.batch([{"op": "report", "params": p, "score": 0.5, "budget": 1} for p in params])
        assert [r["trial_id"] for r in rep["results"]] == [0, 1, 2]
        # the lookup memo: a second hit never leaves the process
        before = front.counters["ops"]
        first = cli.lookup(params[0], budget=1)
        again = cli.lookup(params[0], budget=1)
        assert again == first and first["hit"] == "exact" and cli.stats["lookup_hits"] == 1
        assert front.counters["ops"] == before + 1
        # a report clears the memo (priors moved for every key)
        cli.report(params[1], 0.75, budget=1)
        cli.lookup(params[0], budget=1)
        assert front.counters["ops"] == before + 3
        # single-op REST endpoints share the batch machinery
        t = transport.HttpTransport(url, timeout=10)
        one = t.call("/v1/suggest", {"n": 2, "client": "e2e-rest"})
        assert len(one["results"][0]["params"]) == 2
        health = t.call("/v1/healthz", method="GET")
        assert health["ok"] is True and health["queue_depth"] == front.queue.maxsize
        with pytest.raises(transport.DeadlineExpired):  # expired, never served late
            t.call("/v1/batch", _env([{"op": "suggest", "n": 1}], deadline_s=-0.5))
        with pytest.raises(transport.RequestRefused):
            t.call("/v1/nope", {})
        assert "no service spool" in t.call("/v1/status", method="GET")["error"]
    assert box["summary"]["stopped"] is True
    assert box["summary"]["reports"] == 4 and box["summary"]["expired"] == 1
    assert not os.path.exists(endpoint_path(sdir))  # the endpoint file is retired
    with open(mpath) as f:
        events = [json.loads(line)["event"] for line in f]
    for name in ("http_serve", "http_request", "http_expired", "http_stop"):
        assert name in events, name


def test_e2e_chaos_net_faults_keep_reports_exactly_once(tmp_path):
    with front_door(tmp_path, name="chaos") as (url, front, led, sdir, box):
        cli = SuggestHttpClient(url, client_id="chaos", timeout=10, sleep=_FAST_SLEEP)
        params = cli.suggest(2)["params"]
        ops = [{"op": "report", "params": p, "score": 0.5, "budget": 1} for p in params]
        # op 0 is refused; op 1 executes but its reply is torn; op 2 is
        # answered from the window
        injector, uninstall = chaos.inject_net(refuse=1, torn=1, seed=3)
        try:
            rep = cli.batch(ops)
        finally:
            uninstall()
        assert injector.faults_fired == {"refuse": 1, "torn": 1, "delay": 0}
        assert not any(r.get("error") for r in rep["results"])
        assert rep["replayed"] is True  # the torn attempt had executed
    seen = [(r["idem_key"], r["idem_op"]) for r in _ledger_lines(led.path)]
    assert len(seen) == len(set(seen)) == 2  # one record a report, ever


def test_service_ops_ride_the_spool(tmp_path):
    """submit/status/cancel through the front door act on the sweep
    service's spool (``--http-state-dir``), the JAX package's format."""
    import mpi_opt_tpu.service.spool as jspool

    spool = Spool(str(tmp_path / "state"))
    with front_door(tmp_path, spool=spool) as (url, front, led, sdir, box):
        t = transport.HttpTransport(url, timeout=10)
        sub = t.call("/v1/submit", {"argv": ["--workload", "quadratic"], "tenant": "a"})
        job = sub["results"][0]["job"]
        assert sub["results"][0]["state"] == "queued"
        queued = jspool.Spool(str(tmp_path / "state")).pending_jobs()
        assert [os.path.basename(q) for q in queued] == [f"{job}.json"]
        status = t.call("/v1/status", method="GET")
        assert [j["job"] for j in status["jobs"]] == [job]
        cancel = t.call("/v1/cancel", {"job": job})["results"][0]
        assert cancel["cancel"] is True and cancel["job"] == job
        bad = t.call("/v1/batch", _env([{"op": "submit"}, {"op": "cancel"}]))["results"]
        assert bad == [{"error": "submit needs a non-empty 'argv' list"},
                       {"error": "cancel needs a 'job' id"}]


@pytest.mark.parametrize("direction", ["jax-client-port-door", "port-client-jax-door"])
def test_clients_of_both_packages_talk_to_either_front_door(tmp_path, direction):
    if direction == "jax-client-port-door":
        ctx, Client = _port_front_door(tmp_path), JSuggestHttpClient
    else:
        ctx, Client = _jax_front_door(tmp_path), SuggestHttpClient
    with ctx as (url, led_path):
        cli = Client(url, client_id=direction, timeout=10, sleep=_FAST_SLEEP)
        params = cli.suggest(3)["params"]
        rep = cli.batch([{"op": "report", "params": p, "score": 0.5, "budget": 1} for p in params])
        assert [r["trial_id"] for r in rep["results"]] == [0, 1, 2]
        assert cli.lookup(params[0], budget=1)["hit"] == "exact"
        assert cli.lookup(params[0], budget=7)["hit"] == "prior"
        again = cli.transport.call("/v1/batch", transport.envelope(
            [{"op": "report", "params": params[0], "score": 0.5, "budget": 1}], key="fixed"))
        replay = cli.transport.call("/v1/batch", transport.envelope(
            [{"op": "report", "params": params[0], "score": 0.5, "budget": 1}], key="fixed"))
        assert replay["replayed"] is True and replay["results"] == again["results"]
    assert len(_ledger_lines(led_path)) == 4


@contextlib.contextmanager
def _port_front_door(tmp_path):
    with front_door(tmp_path) as (url, _front, led, _sdir, _box):
        yield url, led.path


@contextlib.contextmanager
def _jax_front_door(tmp_path):
    from mpi_opt_tpu.corpus.client import discover_url as jdiscover
    from mpi_opt_tpu.corpus.serve import SuggestServer as JSuggestServer
    from mpi_opt_tpu.ledger import SweepLedger as JSweepLedger
    from mpi_opt_tpu.service.http import FrontDoor as JFrontDoor
    from mpi_opt_tpu.service.http import serve_http as jserve_http
    from mpi_opt_tpu.utils.metrics import null_logger as jnull
    from mpi_opt_tpu.workloads import get_workload as jget

    space = jget("quadratic").default_space()
    led = JSweepLedger(str(tmp_path / "jax.jsonl"))
    led.ensure_header({"mode": "suggest", "algorithm": "tpe", "workload": "quadratic",
                       "backend": "suggest", "seed": 0, "space_hash": space.space_hash()},
                      space_spec=space.spec())
    front = JFrontDoor(suggest=JSuggestServer(space, seed=0), ledger=led)
    sdir = str(tmp_path / "jax-spool")
    th = threading.Thread(target=jserve_http, args=(front, sdir, jnull()),
                          kwargs={"poll_seconds": 0.01}, daemon=True)
    th.start()
    url = jdiscover(sdir, timeout=20)
    try:
        yield url, led.path
    finally:
        with contextlib.suppress(Exception):
            jtransport.HttpTransport(url, timeout=5).call("/v1/stop", {})
        th.join(timeout=20)
        led.close()

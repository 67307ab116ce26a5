"""The port's suggestion service (``mpi_opt_tpu_torch/corpus/serve.py``,
``ledger/cache.py::CorpusCache``, ``--suggest-serve`` and
``suggest-client``) against the JAX package's, on the CPU.

- ``SuggestServer``, fed JAX's own draws (``torch_port_jax_draws.py``),
  against the JAX ``SuggestServer`` on one request sequence: the startup
  branch (units bit-equal), the acquisition branch with the power-of-two
  block rounding (units within 1 f32 ulp at the cube's scale, 2^-23: a
  candidate is a centre plus a jitter times a width, so its rounding is
  absolute), the clamp of ``n`` to ``n_candidates`` (the first picks
  within that while the acquisition
  stays separated, ROADMAP Queue 3's top-k tie trap; all ``C``
  candidates either way), reports by params, by unit and non-finite,
  lookups exact, prior and miss, and a resume by ``seed_from_ledger``,
  which draws from ``(seed, 0)`` again in both packages. The journaled
  records are bit-equal, except a unit-named report's float params,
  within 1 ulp (LogUniform's ``exp``, Queue 3).
- ``CorpusCache`` against the JAX one on the same records.
- The spool: one spool serves both packages' clients and servers; the
  stop flag drains the queue and is consumed; abandoned responses expire.
- The CLI: ``--suggest-serve`` and the ``--http-*`` flags refuse what the
  JAX CLI refuses, with its messages; ``suggest-client`` starts without
  torch, and ``corpus/transport.py`` and ``corpus/client.py`` import none.
- A suggestion tenant under ``serve --platform cpu``: parked at its slice
  budget (exit 75) and resumed until its idle timeout, it journals the
  records of one unparked run fed the same requests.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mpi_opt_tpu.ops.tpe as jtpe
import mpi_opt_tpu.space as jspace
import mpi_opt_tpu_torch.cli as cli
import mpi_opt_tpu_torch.ops.tpe as ttpe
import mpi_opt_tpu_torch.space as tspace
import torch_port_jax_draws as jd
from mpi_opt_tpu.corpus import client as jclient
from mpi_opt_tpu.corpus.serve import SuggestServer as JSuggestServer
from mpi_opt_tpu.corpus.serve import serve_loop as jserve_loop
from mpi_opt_tpu.ledger import CorpusCache as JCorpusCache
from mpi_opt_tpu.ledger import SweepLedger as JSweepLedger
from mpi_opt_tpu.trial import TrialResult as JResult
from mpi_opt_tpu.utils.metrics import null_logger as jnull_logger
from mpi_opt_tpu_torch.algorithms.base import Observation
from mpi_opt_tpu_torch.corpus import client
from mpi_opt_tpu_torch.corpus.serve import (
    SuggestServer,
    _sweep_responses,
    ensure_spool,
    serve_loop,
    stop_path,
)
from mpi_opt_tpu_torch.ledger import CorpusCache, SweepLedger
from mpi_opt_tpu_torch.service.scheduler import SweepService
from mpi_opt_tpu_torch.service.spool import Spool
from mpi_opt_tpu_torch.trial import TrialResult
from mpi_opt_tpu_torch.utils.metrics import MetricsLogger, null_logger
from mpi_opt_tpu_torch.workloads import get_workload

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HEADER = {"mode": "suggest", "algorithm": "tpe", "workload": "quadratic", "backend": "suggest",
          "seed": 0}


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


#: one f32 ulp at 1.0, the cube's scale: a candidate is a centre plus a
#: jitter times a width, so its rounding is absolute, not relative to it
UNIT_ULP = float(np.spacing(np.float32(1.0)))


def _units_close(got, want) -> None:
    np.testing.assert_allclose(np.float32(got), np.float32(want), rtol=0, atol=UNIT_ULP)


def _params_close(tp: dict, jp: dict) -> None:
    """Materialized params: ints and choices equal, floats within 1 f32
    ulp (LogUniform's ``exp`` differs by one on some inputs)."""
    assert tp.keys() == jp.keys()
    for k in tp:
        if isinstance(tp[k], float):
            assert _ulps(tp[k], jp[k]) <= 1, (k, tp[k], jp[k])
        else:
            assert tp[k] == jp[k], k


def _ledger(mod, path, space):
    led = mod(str(path))
    led.ensure_header({**HEADER, "space_hash": space.space_hash()}, space_spec=space.spec())
    return led


def _records(path):
    """A ledger's records without ``ts`` and ``sweep_id`` (per run)."""
    with open(path) as f:
        recs = [json.loads(x) for x in f.read().splitlines()[1:]]
    return [{k: v for k, v in r.items() if k not in ("ts", "sweep_id")} for r in recs]


def _pair(seed=5):
    """(JAX server, port server) over the draws module's four-parameter
    space at its C candidates, a 32-row ring and 6 startup points."""
    kw = dict(seed=seed, buffer_size=32, n_startup=6)
    return (JSuggestServer(jd.space(jspace), config=jtpe.TPEConfig(n_candidates=jd.C), **kw),
            SuggestServer(jd.space(tspace), config=ttpe.TPEConfig(n_candidates=jd.C), device="cpu",
                          **kw))


@pytest.fixture
def jax_draws(monkeypatch):
    jd.install(monkeypatch)


def _both(js, ts, req, jled=None, tled=None):
    return js.handle(dict(req), ledger=jled), ts.handle(dict(req), ledger=tled)


# -- the server against the JAX server -------------------------------------


def test_suggest_server_equals_jax(tmp_path, jax_draws):
    js, ts = _pair()
    jled = _ledger(JSweepLedger, tmp_path / "jax.jsonl", js.space)
    tled = _ledger(SweepLedger, tmp_path / "port.jsonl", ts.space)
    # the startup branch: JAX's uniform draws, bit-equal rows
    a, b = _both(js, ts, {"op": "suggest", "n": 3})
    np.testing.assert_array_equal(np.float32(b["units"]), np.float32(a["units"]))
    for tp, jp in zip(b["params"], a["params"]):
        _params_close(tp, jp)
    # reports by params (JAX's suggestions), by unit, and non-finite
    for i, p in enumerate(a["params"]):
        ra, rb = _both(js, ts, {"op": "report", "params": p, "score": jd.score(p, 1), "budget": 1},
                       jled, tled)
        assert ra == rb
    ra, rb = _both(js, ts, {"op": "report", "unit": a["units"][0], "score": 0.25, "budget": 3},
                   jled, tled)
    assert ra == rb
    ra, rb = _both(js, ts, {"op": "report", "params": a["params"][1], "score": float("nan"),
                            "budget": 1}, jled, tled)
    assert ra == rb and ra["ok"] is False
    assert _both(js, ts, {"op": "report", "score": 1.0}) == ({"error": "report needs params or unit"},) * 2
    for _ in range(2):  # past n_startup after these
        a, _ = _both(js, ts, {"op": "suggest", "n": 2})
        for p in a["params"]:
            _both(js, ts, {"op": "report", "params": p, "score": jd.score(p, 2), "budget": 2},
                  jled, tled)
    assert js._n_obs == ts._n_obs >= js.n_startup
    np.testing.assert_array_equal(ts._obs_score, js._obs_score)
    assert _ulps(ts._obs_unit, js._obs_unit) <= 1
    # the acquisition branch: n rounded up to a block of 4, and n = 1
    for n in (3, 1):
        a, b = _both(js, ts, {"op": "suggest", "n": n})
        assert len(a["units"]) == len(b["units"]) == n and a["n_obs"] == b["n_obs"]
        _units_close(b["units"], a["units"])
        for tp, jp in zip(b["params"], a["params"]):
            assert tp.keys() == jp.keys()
            for k in tp:  # a 1-ulp unit moves a float param by a few ulps
                assert tp[k] == pytest.approx(jp[k], rel=1e-5), k
    # the clamp: n beyond n_candidates serves all C candidates, the first
    # picks within 1 ulp while the running acquisition stays separated
    a, b = _both(js, ts, {"op": "suggest", "n": 1000})
    ua, ub = np.float32(a["units"]), np.float32(b["units"])
    assert ua.shape == ub.shape == (jd.C, 4)
    _units_close(ub[:8], ua[:8])
    _units_close(ub[np.lexsort(ub.T)], ua[np.lexsort(ua.T)])
    # lookups: exact at the reported budget, prior at another, miss
    reported = _records(tmp_path / "jax.jsonl")[0]["params"]
    for req in ({"op": "lookup", "params": reported, "budget": 1},
                {"op": "lookup", "params": reported, "budget": 99},
                {"op": "lookup", "params": {"lr": 0.5, "momentum": 0.6, "layers": 2, "act": "relu"}},
                {"op": "nope"}):
        ja, ta = _both(js, ts, req)
        assert ja == ta, req
    assert _both(js, ts, {"op": "lookup", "params": reported, "budget": 1})[1]["hit"] == "exact"
    assert _both(js, ts, {"op": "lookup", "params": reported, "budget": 99})[1]["hit"] == "prior"
    jled.close()
    tled.close()
    # the journals: bit-equal, but a unit-named report's float params
    want, got = _records(tmp_path / "jax.jsonl"), _records(tmp_path / "port.jsonl")
    assert len(got) == len(want) == 9
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 3:  # the report by unit: params materialized by each package
            _params_close(g.pop("params"), w.pop("params"))
        assert g == w, i
    assert [r["status"] for r in got].count("failed") == 1


def test_resume_rebuilds_the_ring_and_repeats_the_draws_as_jax(tmp_path, jax_draws):
    js, ts = _pair(seed=2)
    jled = _ledger(JSweepLedger, tmp_path / "jax.jsonl", js.space)
    tled = _ledger(SweepLedger, tmp_path / "port.jsonl", ts.space)
    first = None
    for _ in range(4):
        a, _ = _both(js, ts, {"op": "suggest", "n": 2})
        first = first or a
        for p in a["params"]:
            _both(js, ts, {"op": "report", "params": p, "score": jd.score(p, 1), "budget": 1},
                  jled, tled)
    jled.close()
    tled.close()
    # each package resumes from its own journal
    jr, tr = _pair(seed=2)
    jled, tled = JSweepLedger(str(tmp_path / "jax.jsonl")), SweepLedger(str(tmp_path / "port.jsonl"))
    assert tr.seed_from_ledger(tled.records) == jr.seed_from_ledger(jled.records) == 8
    assert tr._next_id == jr._next_id == 8 and tr._n_obs == jr._n_obs == 8
    assert tr._suggested == jr._suggested == 0
    np.testing.assert_array_equal(tr._obs_score, jr._obs_score)
    assert _ulps(tr._obs_unit, jr._obs_unit) <= 1
    # the draw counter is not rebuilt: the resumed servers draw from
    # (seed, 0) again, the key the first suggestion used, now through
    # the acquisition
    paths = []
    real = SuggestServer._draw_tpe
    ts_draw = lambda self, path, m, d: (paths.append(path), real(self, path, m, d))[1]  # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SuggestServer, "_draw_tpe", ts_draw)
        a, b = _both(jr, tr, {"op": "suggest", "n": 2})
    assert paths == [(2, 0)]
    _units_close(b["units"], a["units"])
    assert a["units"] != first["units"]  # same key, other branch
    ra, rb = _both(jr, tr, {"op": "report", "params": a["params"][0], "score": 0.5, "budget": 1},
                   jled, tled)
    assert ra == rb and rb["trial_id"] == 8
    jled.close()
    tled.close()


def test_acquisition_engages_after_startup():
    """Past ``n_startup`` the served units come from the acquisition."""
    space = get_workload("quadratic").default_space()
    cold = SuggestServer(space, seed=3, n_startup=4, device="cpu")
    warm = SuggestServer(space, seed=3, n_startup=4, device="cpu")
    n = warm.ingest([Observation(unit=np.full(2, 0.3, np.float32), score=float(s), budget=1)
                     for s in [*range(6), float("nan")]])
    assert n == 6 and warm._n_obs == 6
    assert not np.allclose(cold.suggest(4)["units"], warm.suggest(4)["units"])


def test_server_needs_a_card_unless_asked_for_the_cpu():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SuggestServer(get_workload("quadratic").default_space())


# -- CorpusCache against the JAX one ----------------------------------------


def test_corpus_cache_equals_jax():
    spaces = (jd.space(jspace), jd.space(tspace))
    caches = (JCorpusCache(spaces[0]), CorpusCache(spaces[1]))
    p = {"lr": 0.1, "momentum": 0.9, "layers": 2, "act": "tanh"}
    q = {"lr": 0.02, "momentum": 0.6, "layers": 3, "act": "relu"}
    recs = [{"status": "ok", "score": 0.4, "step": 10, "params": p, "wall_s": 1.5},
            {"status": "failed", "score": None, "step": 10, "params": q},
            {"status": "ok", "score": 0.7, "step": 270, "params": p},
            {"status": "ok", "score": 0.1, "step": 5, "params": {"lr": 0.1}}]  # no live dims

    def run(cache, Result):
        out = [cache.seed_from(recs[:3])]
        out.append(cache.seed_prior([{**recs[0], "params": q}], fuzzy=True))
        out.append(cache.seed_prior(recs))
        out.append(cache.seed_prior([{**recs[2], "score": 0.9, "step": 999}], fuzzy=True))
        for params, budget in ((p, 10), (p, 270), (p, 11), (q, 10)):
            hit = cache.get(params, budget, trial_id=7)
            out.append(None if hit is None else (hit.trial_id, hit.score, hit.step, hit.extra))
        for params in (p, q, {**q, "layers": 4}):
            pr = cache.get_prior(params, trial_id=3)
            out.append(None if pr is None else (pr.score, pr.step, pr.extra))
        cache.put(q, Result(trial_id=1, score=0.55, step=30, wall_time=2.0))
        cache.put(p, Result(trial_id=2, score=float("nan"), step=40, wall_time=1.0,
                            status="failed", error="x"))
        out.append((cache.get(q, 30, 9).score, cache.get_prior(q, 9).extra, cache.get_prior(q, 9).step))
        out.append((len(cache), cache.n_prior, cache.hits, cache.prior_hits))
        return out

    assert run(caches[1], TrialResult) == run(caches[0], JResult)


# -- the spool, both ways --------------------------------------------------


@contextlib.contextmanager
def _spool_server(server, sdir, loop, logger, ledger=None):
    box = {}

    def run():
        box.update(loop(server, str(sdir), logger, ledger=ledger, poll_seconds=0.01,
                        idle_timeout=30.0))

    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        yield box
    finally:
        client.request_stop(str(sdir))
        th.join(timeout=30)
        assert not th.is_alive()


@pytest.mark.parametrize("direction", ["jax-client-port-server", "port-client-jax-server"])
def test_one_spool_serves_both_packages(tmp_path, direction):
    space = get_workload("quadratic").default_space()
    sdir = tmp_path / "sugg"
    if direction == "jax-client-port-server":
        server, loop, logger, cl = SuggestServer(space, seed=0, device="cpu"), serve_loop, null_logger(), jclient
        led = _ledger(SweepLedger, tmp_path / "l.jsonl", space)
    else:
        from mpi_opt_tpu.workloads import get_workload as jget

        jsp = jget("quadratic").default_space()
        server, loop, logger, cl = JSuggestServer(jsp, seed=0), jserve_loop, jnull_logger(), client
        led = _ledger(JSweepLedger, tmp_path / "l.jsonl", jsp)
    with _spool_server(server, sdir, loop, logger, ledger=led) as summary:
        ans = cl.round_trip(str(sdir), {"op": "suggest", "n": 3})
        assert len(ans["params"]) == len(ans["units"]) == 3
        for p in ans["params"]:
            assert cl.round_trip(str(sdir), {"op": "report", "params": p, "score": 0.5,
                                             "budget": 1})["ok"] is True
        assert cl.round_trip(str(sdir), {"op": "lookup", "params": ans["params"][0],
                                         "budget": 1})["hit"] == "exact"
        lk = cl.round_trip(str(sdir), {"op": "lookup", "params": ans["params"][0], "budget": 9})
        assert lk["hit"] == "prior" and lk["fidelity"] == "prior"
        assert "error" in cl.round_trip(str(sdir), {"op": "nope"})
        # a torn request file is answered under its stem, never wedges
        with open(sdir / "requests" / "req-torn.json", "w") as f:
            f.write("{half")
        assert cl.wait_response(str(sdir), "req-torn", timeout=10)["error"].startswith("malformed")
    assert summary["stopped"] and summary["reports"] == 3 and summary["served"] == 8
    led.close()
    assert [r["trial_id"] for r in _records(tmp_path / "l.jsonl")] == [0, 1, 2]


def test_stop_drains_pending_and_consumes_the_flag(tmp_path):
    sdir = str(tmp_path / "sugg")
    ensure_spool(sdir)
    rid = client.request(sdir, {"op": "suggest", "n": 2})  # queued first
    client.request_stop(sdir)  # then stop, before any server runs
    server = SuggestServer(get_workload("quadratic").default_space(), seed=0, device="cpu")
    summary = serve_loop(server, sdir, null_logger(), poll_seconds=0.01)
    assert summary["stopped"] and summary["served"] == 1
    ans = client.wait_response(sdir, rid, timeout=5)
    assert ans is not None and len(ans["params"]) == 2  # answered, not dropped
    assert not os.path.exists(stop_path(sdir))  # the flag is consumed


def test_sweep_responses_expires_only_stale_files(tmp_path):
    old, new = tmp_path / "old.json", tmp_path / "new.json"
    old.write_text("{}")
    new.write_text("{}")
    past = time.time() - 3600
    os.utime(old, (past, past))
    _sweep_responses(str(tmp_path), ttl_s=600)
    assert not old.exists() and new.exists()


# -- the CLI ------------------------------------------------------------------


def _usage_cases(d):
    q = ["--workload", "quadratic"]
    s = [*q, "--suggest-serve", d]
    return [
        [*s, "--fused"],
        [*s, "--chaos", "exc=0.1"],
        [*q, "--suggest-idle-timeout", "1"],
        [*s, "--suggest-idle-timeout", "0"],
        [*q, "--http-port", "0"],
        [*s, "--http-port", "70000"],
        [*s, "--http-port", "0", "--http-queue", "0"],
        [*q, "--http-state-dir", d],
        [*s, "--ledger", os.path.join(d, "held.jsonl")],
    ]


@pytest.mark.parametrize("case", range(9))
def test_cli_usage_errors_equal_jax(tmp_path, case, capsys):
    import mpi_opt_tpu.cli as jcli

    d = str(tmp_path / "sugg")
    space = get_workload("quadratic").default_space()
    led = _ledger(SweepLedger, tmp_path / "sugg" / "held.jsonl", space)
    led.record_trial(TrialResult(trial_id=0, score=0.5, step=1, wall_time=0.0),
                     space.canonical_params({"lr": 0.1, "reg": 0.2}))
    led.close()
    argv = _usage_cases(d)[case]
    errs = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
        with pytest.raises(SystemExit) as e:
            main([*argv, *extra])
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1])
    assert errs[0] == errs[1]
    assert not os.path.exists(os.path.join(d, "requests"))  # refused before serving


def test_suggest_serve_cli_runs_on_the_cpu(tmp_path, capsys):
    """The CLI's suggest path in this process: header, reports journaled,
    a ``--resume`` that rebuilds the ring, the summary line."""
    d, led = str(tmp_path / "sugg"), str(tmp_path / "l.jsonl")
    ensure_spool(d)
    client.request(d, {"op": "suggest", "n": 2, "id": "req-1"})
    client.request(d, {"op": "report", "params": {"lr": 0.1, "reg": 0.2}, "score": 0.5,
                       "budget": 1, "id": "req-2"})
    client.request_stop(d)
    argv = ["--workload", "quadratic", "--suggest-serve", d, "--ledger", led, "--device", "cpu",
            "--seed", "3"]
    assert cli.main(argv) == 0
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert out[-1]["served"] == 2 and out[-1]["reports"] == 1 and out[-1]["backend"] == "suggest"
    assert [e["event"] for e in out[:1]] == ["suggest_serve"]
    with open(led) as f:
        header = json.loads(f.readline())
    assert header["config"] == {"mode": "suggest", "algorithm": "tpe", "workload": "quadratic",
                                "backend": "suggest", "seed": 3,
                                "space_hash": get_workload("quadratic").default_space().space_hash(),
                                "warm_start": None}
    client.request_stop(d)
    assert cli.main([*argv, "--resume"]) == 0
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert {"event": "ledger_replay", "completed": 1}.items() <= next(
        e for e in out if e.get("event") == "ledger_replay").items()
    assert out[-1]["n_obs"] == 1


def test_transport_and_client_import_no_torch():
    code = ("import sys\nimport mpi_opt_tpu_torch.corpus.transport, mpi_opt_tpu_torch.corpus.client\n"
            "assert 'torch' not in sys.modules, 'torch'\n"
            "assert not [m for m in sys.modules if m == 'jax' or m.startswith('mpi_opt_tpu.')]\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr


def test_suggest_client_starts_without_torch(tmp_path):
    """``python -m mpi_opt_tpu_torch suggest-client`` loads neither torch
    nor the CLI module, and its usage errors are the JAX client's."""
    code = ("import runpy, sys; sys.argv = ['x', 'suggest-client', '--dir', sys.argv[1], 'stop']\n"
            "try:\n    runpy.run_module('mpi_opt_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n    assert e.code == 0\n"
            "assert 'torch' not in sys.modules and 'mpi_opt_tpu_torch.cli' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == {"stop": True} and os.path.exists(stop_path(str(tmp_path)))


@pytest.mark.parametrize("argv", [[], ["bench"], ["--dir", "d", "report", "--params", "{", "--score", "1"]])
def test_client_usage_errors_equal_jax(argv, capsys):
    from mpi_opt_tpu.corpus.client import client_main as jclient_main

    errs = []
    for main in (client.client_main, jclient_main):
        with pytest.raises(SystemExit) as e:
            main(list(argv))
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1])
    assert errs[0] == errs[1]


# -- the tenant under the port's sweep service ---------------------------------


def _traffic(sdir, n=6):
    """The requests both runs are fed: a suggestion, then a report of a
    fixed point (the records do not depend on what was suggested)."""
    for i in range(n):
        ans = client.round_trip(sdir, {"op": "suggest", "n": 2}, timeout=60)
        assert len(ans["params"]) == 2
        client.round_trip(sdir, {"op": "report", "params": {"lr": 0.01 * (i + 1), "reg": 0.1 * i},
                                 "score": 0.1 * i, "budget": 1}, timeout=60)


def test_suggest_tenant_parks_and_resumes_to_the_unparked_records(tmp_path):
    state, sdir = tmp_path / "state", str(tmp_path / "sugg")
    spool = Spool(str(state))
    job = spool.submit(["--workload", "quadratic", "--suggest-serve", sdir,
                        "--suggest-idle-timeout", "2"], tenant="ext")
    svc = SweepService(str(state), slice_boundaries=3, poll_seconds=0.02, drain_on_empty=True,
                       device="cpu", metrics=MetricsLogger(path=str(state / "server-metrics.jsonl")))
    th = threading.Thread(target=_traffic, args=(sdir,), daemon=True)
    th.start()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = svc.serve()
    th.join(timeout=60)
    assert rc == 0 and not th.is_alive()
    st = spool.tenant(job).status
    assert st["state"] == "done" and st["slices"] >= 3, st
    parked = _records(spool.tenant(job).ledger)
    # one unparked run, fed the same requests
    ref_dir, ref_led = str(tmp_path / "ref"), str(tmp_path / "ref.jsonl")
    th = threading.Thread(target=_traffic, args=(ref_dir,), daemon=True)
    th.start()
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["--workload", "quadratic", "--suggest-serve", ref_dir,
                         "--suggest-idle-timeout", "2", "--ledger", ref_led, "--device", "cpu"]) == 0
    th.join(timeout=60)
    assert parked == _records(ref_led) and [r["trial_id"] for r in parked] == list(range(6))

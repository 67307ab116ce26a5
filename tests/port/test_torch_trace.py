"""Span tracing in the port (``obs/trace.py``, ``obs/report.py``,
``obs/bubbles.py``) against the JAX package's: the tracer's contract
(nesting and self time per thread, null mode, the heartbeat's phase),
the spans a traced fused PBT sweep emits, equal to the JAX sweep's as a
multiset of (span, op, parent) once the port's own step-phase spans
(``obs/events.py::PORT_SPANS``) are dropped (the port has no XLA
compile, so no ``compile`` spans), and the attribution: the JAX ``attribute`` and
``bench_attribution`` and the port's copies give equal dicts on one
recorded stream."""

import collections
import json
import threading
import time

import jax  # noqa: F401  (pinned to the CPU by tests/conftest.py)
import numpy as np
import pytest
import torch

import mpi_opt_tpu.ledger.store as jstore
import mpi_opt_tpu.obs.report as jreport
from mpi_opt_tpu.obs import trace as jtrace
from mpi_opt_tpu.train.fused_pbt import fused_pbt as jax_fused_pbt
from mpi_opt_tpu.workloads import get_workload as jax_get_workload
from mpi_opt_tpu_torch import cli, get_workload
from mpi_opt_tpu_torch.health import heartbeat
from mpi_opt_tpu_torch.ledger import SweepLedger
from mpi_opt_tpu_torch.obs import events, report, trace
from mpi_opt_tpu_torch.train import engine, staging
from mpi_opt_tpu_torch.train.fused_asha import fused_sha
from mpi_opt_tpu_torch.train.fused_pbt import fused_pbt
from mpi_opt_tpu_torch.utils.metrics import MetricsLogger

PBT_KW = dict(population=4, generations=2, steps_per_gen=2, seed=0, gen_chunk=1)


@pytest.fixture(autouse=True)
def _untraced():
    saved = trace.save()
    trace.deconfigure()
    yield
    trace.deconfigure(saved)
    heartbeat.deconfigure()


class Sink:
    """A span sink that also records each span's parent: the emitting
    thread's innermost open span when the record is logged."""

    def __init__(self, module):
        self.module, self.recs = module, []

    def log(self, event, **fields):
        st = getattr(self.module._LOCAL, "stack", None) or []
        self.recs.append(dict(event=event, _parent=st[-1][0] if st else None, **fields))

    def multiset(self):
        return collections.Counter((r["span"], r.get("op"), r["_parent"]) for r in self.recs
                                   if r["span"] != "compile" and r["span"] not in events.PORT_SPANS)


def test_spans_nest_and_self_times_sum_per_thread():
    sink = Sink(trace)
    trace.configure(sink, rank=1)

    def worker():
        with trace.span("stage_out"):
            with trace.span("journal", n=1):
                time.sleep(0.01)

    with trace.span("train", launch=1) as sp:
        t = threading.Thread(target=worker)
        t.start()
        with trace.span("boundary", op="rung_cut"):
            assert trace.current_phase() == "boundary:rung_cut"
            time.sleep(0.01)
        with trace.span("stage_wait"):
            t.join()
        sp["flops"] = 5
    by = {r["span"]: r for r in sink.recs}
    assert set(by) == {"train", "boundary", "stage_wait", "stage_out", "journal"}
    assert by["boundary"]["op"] == "rung_cut" and by["train"]["flops"] == 5
    assert by["train"]["rank"] == 1
    main, other = by["train"]["tid"], by["stage_out"]["tid"]
    assert main != other and by["journal"]["tid"] == other
    assert [by[k]["_parent"] for k in ("boundary", "stage_wait", "journal", "stage_out", "train")] == [
        "train", "train", "stage_out", None, None]
    # self time: the duration less the direct children's, per thread
    kids = by["boundary"]["dur_s"] + by["stage_wait"]["dur_s"]
    assert by["train"]["self_s"] == pytest.approx(by["train"]["dur_s"] - kids, abs=2e-6)
    assert by["stage_out"]["self_s"] == pytest.approx(
        by["stage_out"]["dur_s"] - by["journal"]["dur_s"], abs=2e-6)
    assert trace.current_phase() is None


def test_null_mode_does_no_json_work(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("json.dumps called with tracing off")

    monkeypatch.setattr(json, "dumps", boom)
    assert not trace.enabled()
    with trace.span("train", launch=1) as sp:
        assert trace.current_phase() == "train"
        trace.note_device(sp, "cpu")
        assert "device" not in sp
    assert trace.current_phase() is None


def test_a_failing_sink_warns_once_and_never_raises():
    class Broken:
        def log(self, *a, **k):
            raise OSError("disk gone")

    trace.configure(Broken())
    with pytest.warns(UserWarning, match="span emission failed"):
        with trace.span("train"):
            pass
    with trace.span("train"):  # quiet from now on
        pass


def test_current_phase_feeds_the_heartbeat(tmp_path):
    path = str(tmp_path / "beat.json")
    heartbeat.configure(path)
    with trace.span("stage_in", members=3):
        heartbeat.beat(stage="x")
    assert heartbeat.read_beat(path)["phase"] == "stage_in"
    with engine.boundary_span("rung_cut", rung=1):
        assert heartbeat.read_beat(path)["phase"] == "boundary:rung_cut"
    heartbeat.beat(stage="y")
    assert heartbeat.read_beat(path)["phase"] is None


def test_pbt_span_multiset_equals_jax(tmp_path):
    """The same traced fashion_mlp PBT sweep (one generation a launch,
    snapshots and a ledger) through both packages: setup, the FLOP
    probe, a train and a journal span a launch, a save with its digest
    build inside, the closing save_wait."""
    space_hash = lambda wl: wl.default_space().space_hash()
    header = lambda wl: {"mode": "fused", "seed": 0, "space_hash": space_hash(wl)}
    jwl = jax_get_workload("fashion_mlp", n_train=256, n_val=128)
    jsink = Sink(jtrace)
    jled = jstore.SweepLedger(str(tmp_path / "jax.jsonl"))
    jled.ensure_header(header(jwl))
    prior = jtrace.configure(jsink)
    try:
        jax_fused_pbt(jwl, checkpoint_dir=str(tmp_path / "jck"), ledger=jled, **PBT_KW)
    finally:
        jtrace.deconfigure(prior)
        jled.close()
    twl = get_workload("fashion_mlp", n_train=256, n_val=128)
    tsink = Sink(trace)
    tled = SweepLedger(str(tmp_path / "port.jsonl"))
    tled.ensure_header(header(twl))
    trace.configure(tsink)
    try:
        fused_pbt(twl, checkpoint_dir=str(tmp_path / "tck"), ledger=tled, device="cpu", **PBT_KW)
    finally:
        tled.close()
    assert tsink.multiset() == jsink.multiset()
    assert tsink.multiset()[("train", None, None)] == 2
    trains = [r for r in tsink.recs if r["span"] == "train"]
    assert [r["launch"] for r in trains] == [1, 2] and all(r["flops"] > 0 for r in trains)
    setup = next(r for r in tsink.recs if r["span"] == "setup" and "op" not in r)
    assert setup["device"] == "cpu" and setup["workload"] == "fashion_mlp"


@pytest.fixture(scope="module")
def wave_stream(tmp_path_factory):
    """A recorded stream: a traced fashion_mlp SHA sweep in waves of 3
    (stage_in, stage_out, stage_wait, boundary and train spans)."""
    path = str(tmp_path_factory.mktemp("stream") / "m.jsonl")
    m = MetricsLogger(path=path)
    prior = trace.configure(m)
    try:
        res = fused_sha(get_workload("fashion_mlp", n_train=256, n_val=128), n_trials=8, min_budget=2,
                        max_budget=8, eta=2, seed=3, wave_size=3, device="cpu")
    finally:
        trace.deconfigure(prior)
        m.close()
    return path, res


def test_wave_sweep_spans(wave_stream):
    path, res = wave_stream
    spans = [r for r in report.load_stream(path) if r["event"] == "span"]
    count = collections.Counter(r["span"] for r in spans)
    assert count["train"] == 3 and count["stage_wait"] == 3  # one interval a rung
    assert count["stage_in"] == count["stage_out"] == res["waves_run"] == 6
    assert count[("boundary")] == 2
    assert sum(r["bytes"] for r in spans if r["span"] in ("stage_in", "stage_out")) == res["staged_bytes"]
    last = max((r for r in spans if r["span"] == "stage_wait"), key=lambda r: r["ts"])
    assert last["wait_s"] == pytest.approx(res["stage_wait_s"], abs=1e-6)


def test_attribution_equals_jax_on_one_stream(wave_stream):
    """``attribute`` and ``bench_attribution`` of the port (copies) and
    of the JAX package on the same stream, at an explicit cap."""
    path, _ = wave_stream
    streams = {"m.jsonl": report.load_stream(path)}
    assert streams["m.jsonl"] == jreport.load_stream(path)
    got = report.attribute(streams, peak_tflops=100.0)
    assert got == jreport.attribute(streams, peak_tflops=100.0)
    assert got["compile"] == {"cold": {"count": 0, "total_s": 0.0},
                              "persistent": {"count": 0, "total_s": 0.0}}
    assert got["staging"]["stage_outs"] == 6 and got["roofline"]["peak_source"] == "cli"
    assert report.bench_attribution(path, 100.0) == jreport.bench_attribution(path, 100.0)


def test_the_cap_table_names_only_the_h100():
    from mpi_opt_tpu_torch.obs import bubbles

    assert bubbles.CALIBRATED_PEAK_TFLOPS == {"NVIDIA H100 80GB HBM3": 989.0}
    spans = [{"span": "setup", "device": "NVIDIA H100 80GB HBM3", "ts": 1.0, "dur_s": 0.1}]
    assert bubbles.resolve_peak(spans) == (989.0, "calibration:NVIDIA H100 80GB HBM3")
    assert bubbles.resolve_peak([{**spans[0], "device": "cpu"}]) == (None, None)


def test_cli_trace_then_render(tmp_path, capsys):
    """``--trace --metrics-file`` through the CLI, then the ``trace``
    subcommand: a text table, and one JSON object with --json."""
    m = str(tmp_path / "m.jsonl")
    rc = cli.main(["--workload", "fashion_mlp", "--algorithm", "pbt", "--fused", "--population", "4",
                   "--generations", "2", "--steps-per-generation", "2", "--gen-chunk", "1",
                   "--device", "cpu", "--trace", "--metrics-file", m])
    assert rc == 0 and not trace.enabled()  # the sink is restored on the way out
    capsys.readouterr()
    assert cli.main(["trace", m]) == 0
    text = capsys.readouterr().out
    assert text.startswith("trace: 1 stream(s)") and "train" in text and "setup" in text
    assert cli.main(["trace", str(tmp_path), "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["phases"]["train"]["count"] == 2 and rep["coverage"] > 0


def test_measured_train_peak_and_envelope(tmp_path):
    path = tmp_path / "m.jsonl"
    lines = [{"event": "span", "span": "train", "mem_peak_bytes": 900, "ts": 1.0, "dur_s": 1.0},
             {"event": "span", "span": "stage_out", "mem_peak_bytes": 1200, "ts": 2.0, "dur_s": 1.0},
             {"event": "span", "span": "save", "mem_peak_bytes": 5000, "ts": 3.0, "dur_s": 1.0}]
    path.write_text("\n".join(json.dumps(x) for x in lines) + "\n{torn")
    assert staging.measured_train_peak(str(path)) == 1200
    assert staging.measured_train_peak(str(tmp_path / "missing.jsonl")) is None
    tr = get_workload("fashion_mlp", n_train=256, n_val=128).make_trainer(device="cpu")
    rep = staging.envelope_report(tr, 4, str(path))
    assert rep["per_member_bytes"] == tr.member_bytes()
    assert rep["static_pop_bytes"] == 4 * tr.member_bytes() and rep["measured_peak_bytes"] == 1200
    assert rep["measured_over_static"] == round(1200 / (4 * tr.member_bytes()), 4)


def test_untraced_sweeps_pay_no_flop_probe(monkeypatch):
    from mpi_opt_tpu_torch.utils import flops

    def boom(*a, **k):
        raise AssertionError("FLOP probe paid untraced")

    monkeypatch.setattr(flops, "population_sweep_flops", boom)
    res = fused_pbt(get_workload("fashion_mlp", n_train=256, n_val=128), device="cpu", **PBT_KW)
    assert np.isfinite(res["best_score"]) and torch.is_tensor(res["state"].step)

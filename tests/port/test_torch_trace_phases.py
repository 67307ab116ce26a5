"""The tracer's records on the device trace's clock and in memory
(``obs/trace.py``), and the step-phase spans of the population trainer
(``train/population.py``): what a record carries, when records reach
the sink (at a launch boundary, at ``deconfigure``, when a span raised,
never inside a step), null mode, the spans a traced fused PBT sweep
emits, resident and in waves, and the heartbeat's phase at every beat,
which the new spans leave as it was."""

import collections
import contextlib
import io
import json
import threading
import time
import types

import pytest
import torch

from mpi_opt_tpu_torch import get_workload
from mpi_opt_tpu_torch.health import heartbeat
from mpi_opt_tpu_torch.obs import events, trace
from mpi_opt_tpu_torch.train import population
from mpi_opt_tpu_torch.train.common import launch_boundary
from mpi_opt_tpu_torch.train.fused_pbt import fused_pbt
from mpi_opt_tpu_torch.utils import metrics
from mpi_opt_tpu_torch.utils.metrics import MetricsLogger

# two generations of three steps, members in launches of two
SWEEP = dict(population=4, generations=2, steps_per_gen=3, seed=0, member_chunk=2, device="cpu")


@pytest.fixture(autouse=True)
def _untraced():
    saved = trace.save()
    trace.deconfigure()
    yield
    trace.deconfigure(saved)
    heartbeat.clear_beat_listener()
    heartbeat.deconfigure()


class Sink(MetricsLogger):
    """A metrics logger over a stream in memory; ``recs`` is what it
    has written."""

    def __init__(self):
        super().__init__(stream=io.StringIO())

    @property
    def recs(self):
        return [json.loads(line) for line in self._stream.getvalue().splitlines()]

    def spans(self, name=None):
        return [r for r in self.recs if r["event"] == "span" and name in (None, r["span"])]


def _workload():
    return get_workload("fashion_mlp", n_train=256, n_val=128)


def test_records_carry_the_clock_the_thread_and_the_parent(tmp_path):
    m = MetricsLogger(path=str(tmp_path / "m.jsonl"))
    trace.configure(m)
    before = time.time_ns()
    with trace.span("train", launch=1):
        with trace.span("update"):
            time.sleep(0.002)
    after = time.time_ns()
    worker = {}

    def run():
        with trace.span("stage_out"):
            worker.update(os_tid=threading.get_native_id(), ident=threading.get_ident())

    t = threading.Thread(target=run)
    t.start()
    t.join()
    trace.deconfigure()
    m.close()
    recs = {r["span"]: r for r in map(json.loads, open(tmp_path / "m.jsonl"))}
    upd, train, out = recs["update"], recs["train"], recs["stage_out"]
    assert before <= train["t0_ns"] <= upd["t0_ns"] <= upd["t1_ns"] <= train["t1_ns"] <= after
    assert upd["t1_ns"] - upd["t0_ns"] >= 2_000_000
    for r in (upd, train, out):
        assert abs(r["ts"] - r["t1_ns"] / 1e9) <= 1e-3  # the end, taken at exit
        assert r["dur_s"] == pytest.approx((r["t1_ns"] - r["t0_ns"]) / 1e9, abs=1e-4)
    assert (upd["parent"], train["parent"], out["parent"]) == ("train", None, None)
    assert (upd["os_tid"], upd["thread_ident"]) == (threading.get_native_id(), threading.get_ident())
    assert (out["os_tid"], out["thread_ident"]) == (worker["os_tid"], worker["ident"])
    # ``t`` is the span's end on the sink's own clock, not the write's
    assert train["t"] == pytest.approx(upd["t"], abs=0.01) and train["t"] >= upd["t"]


def test_nothing_reaches_the_sink_inside_a_step():
    """Two steps and an eval write nothing; the launch boundary writes
    them all, and ``deconfigure`` what is left."""
    sink = Sink()
    trace.configure(sink)
    wl = _workload()
    trainer = wl.make_trainer(device="cpu").launching(2)
    gen = torch.Generator().manual_seed(0)
    state = trainer.init_population(gen, 4)
    hp = population.OptHParams.defaults(4)
    data = wl.data()
    tx, ty = (torch.as_tensor(data[k]) for k in ("train_x", "train_y"))
    with trace.span("train", launch=1):
        trainer.train_segment(state, hp, tx, ty, gen, 2)
        trainer.eval_population(state, torch.as_tensor(data["val_x"]), torch.as_tensor(data["val_y"]))
        assert sink.recs == []
    assert sink.recs == [] and len(sink._held) == 16
    launch_boundary("unit", final=True)
    count = collections.Counter(r["span"] for r in sink.spans())
    assert count == {"batch": 2, "forward": 4, "backward": 4, "update": 4, "eval": 1, "train": 1}
    with trace.span("journal", n=1):
        pass
    assert len(sink.recs) == sum(count.values())
    trace.deconfigure()
    assert sink.spans()[-1]["span"] == "journal"


def test_the_boundary_writes_before_its_heartbeat(tmp_path):
    sink = Sink()
    trace.configure(sink)
    heartbeat.configure(str(tmp_path / "beat.json"))
    seen = []
    heartbeat.set_beat_listener(lambda rec: seen.append(len(sink.recs)))
    with trace.span("update"):
        pass
    launch_boundary("unit", final=True)
    assert seen == [1]


def test_a_span_that_raised_reaches_the_sink_at_once():
    sink = Sink()
    trace.configure(sink)
    with trace.span("batch"):
        pass
    with pytest.raises(RuntimeError):
        with trace.span("train", launch=1):
            with trace.span("update"):
                raise RuntimeError("device lost")
    # the raised spans and everything pending before them, no deconfigure
    assert [r["span"] for r in sink.spans()] == ["batch", "update", "train"]


def test_the_logger_writes_held_records_in_order_and_in_bounds(monkeypatch):
    """A logged record follows the spans held before it, and past
    ``MAX_HELD`` held records the logger writes them without a flush."""
    monkeypatch.setattr(metrics, "MAX_HELD", 3)
    sink = Sink()
    trace.configure(sink)
    with trace.span("batch"):
        pass
    sink.log("heartbeat", n=1)
    assert [(r["event"], r.get("span")) for r in sink.recs] == [("span", "batch"), ("heartbeat", None)]
    for _ in range(2):
        with trace.span("update"):
            pass
    assert len(sink.recs) == 2
    with trace.span("update"):
        pass
    assert len(sink.spans("update")) == 3


def test_null_mode_builds_no_record(monkeypatch):
    # a tracer whose clock module has perf_counter alone (any other clock
    # read raises) and whose record maker raises
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(perf_counter=time.perf_counter))

    def no_record(*args, **kwargs):
        raise AssertionError("a record was made untraced")

    monkeypatch.setattr(trace, "_emit", no_record)
    assert not trace.enabled()
    with trace.span("train", launch=1):
        with trace.span("forward"):
            assert trace.current_phase() == "forward"
    assert trace.current_phase() is None


def _sweep(sink, **kw):
    trace.configure(sink)
    try:
        return fused_pbt(_workload(), **SWEEP, **kw)
    finally:
        trace.deconfigure()


@pytest.mark.parametrize("mode", ["resident", "waves"])
def test_a_traced_sweep_emits_the_step_phases(mode):
    sink = Sink()
    kw = dict(gen_chunk=1, step_chunk=2) if mode == "resident" else dict(wave_size=2)
    _sweep(sink, **kw)
    spans = sink.spans()
    g, s, chunks = SWEEP["generations"], SWEEP["steps_per_gen"], 2
    waves = 1 if mode == "resident" else 2
    count = collections.Counter(r["span"] for r in spans if r["span"] in events.PORT_SPANS)
    # one batch a step (a wave draws its step's batch too), one forward,
    # backward and update a chunk of a step, one eval a generation or a wave
    assert count == {"batch": g * s * waves, "forward": g * s * chunks, "backward": g * s * chunks,
                     "update": g * s * chunks, "eval": g * waves}
    # every phase inside the launch's (or the wave interval's) train span
    assert {r["parent"] for r in spans if r["span"] in events.PORT_SPANS} == {"train"}
    trains = [r for r in spans if r["span"] == "train"]
    for r in spans:
        if r["span"] in events.PORT_SPANS:
            assert any(t["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] <= t["t1_ns"] for t in trains)
    # the chunks of one step run in order: forward, backward, update
    main = [r["span"] for r in sorted(spans, key=lambda r: r["t0_ns"])
            if r["span"] in ("forward", "backward", "update")]
    assert main == ["forward", "backward", "update"] * (g * s * chunks)


@contextlib.contextmanager
def _without_step_phases(monkeypatch):
    """The trainer with its step-phase spans taken out, as the tracer
    was before them."""
    real = trace.span

    def span(name, **attrs):
        return contextlib.nullcontext(attrs) if name in events.PORT_SPANS else real(name, **attrs)

    with monkeypatch.context() as m:
        m.setattr(population, "trace", types.SimpleNamespace(span=span))
        yield


@pytest.mark.parametrize("mode", ["resident", "waves"])
def test_the_heartbeat_phase_at_each_beat_is_unchanged(mode, tmp_path, monkeypatch):
    """Every beat of a traced sweep reads the phase it reads without the
    step-phase spans: the beats lie outside them."""
    kw = dict(gen_chunk=1, step_chunk=2) if mode == "resident" else dict(wave_size=2)

    def beats():
        seen = []
        heartbeat.configure(str(tmp_path / "beat.json"))
        heartbeat.set_beat_listener(lambda rec: seen.append(
            (rec["progress"].get("stage"), rec["phase"], threading.current_thread() is threading.main_thread())))
        _sweep(Sink(), **kw)
        heartbeat.clear_beat_listener()
        # the main thread's in order; the staging worker's interleave
        return [b for b in seen if b[2]] + sorted(b for b in seen if not b[2])

    got = beats()
    with _without_step_phases(monkeypatch):
        want = beats()
    assert got == want and len(got) >= 4
    assert not {phase for _, phase, _ in got} & events.PORT_SPANS


def test_records_from_many_threads_reach_the_sink_once_each():
    """More threads than cores make spans while others flush, with the
    interpreter switching threads every microsecond: every record is
    written exactly once."""
    import sys

    sink = Sink()
    trace.configure(sink)
    n_threads, per_thread = 16, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def make(k):
            for i in range(per_thread):
                with trace.span("update", n=k * per_thread + i):
                    pass
                if i % 50 == 0:
                    trace.flush()

        threads = [threading.Thread(target=make, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    trace.deconfigure()
    got = sorted(r["n"] for r in sink.spans("update"))
    assert got == list(range(n_threads * per_thread))

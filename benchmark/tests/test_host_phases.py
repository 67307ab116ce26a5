"""The reader of the joined trace (``benchmark/host_phases.py``) on a
synthetic sub-window: a main thread's step phases, autograd's thread
launching the backward, and device operations with the gaps between
them. Times below are microseconds after the trace's base."""

from __future__ import annotations

import importlib.util
import json
import os
import threading
import types

import pytest

from benchmark import host_phases

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BASE_NS = 1_760_000_000_000_000_000
MAIN = threading.main_thread()
AUTOGRAD_TID = 3_000_000_001  # a pthread id's low bits past 2**31
NEW = ("batch_idle_pct", "forward_idle_pct", "backward_idle_pct", "update_idle_pct",
       "other_idle_pct", "stage_in_idle_pct", "eval_idle_pct", "update_device_ms_per_step")

#: the main thread's spans: a train span holding one step's phases
SPANS = [("train", 0, 1000), ("batch", 10, 100), ("forward", 100, 300), ("backward", 300, 500),
         ("update", 500, 900)]
#: (device start, end, launch time, launching thread): the ids the trace
#: gives, the main thread's pthread id's low 32 bits and autograd's
OPS = [(50, 150, 20, "main"), (200, 350, 150, "main"), (400, 450, 320, "autograd"),
       (600, 700, 550, "main"), (820, 830, 560, "main"), (950, 960, 905, "main")]


def _span(name, a, b, base=BASE_NS, thread=MAIN):
    return {"event": "span", "span": name, "t0_ns": base + a * 1000, "t1_ns": base + b * 1000,
            "os_tid": thread.native_id, "thread_ident": thread.ident}


def _doc(ops=OPS, base=BASE_NS, shift_us=0.0):
    tids = {"main": MAIN.ident & 0xFFFFFFFF, "autograd": AUTOGRAD_TID & 0xFFFFFFFF}
    events = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": 1, "args": {"name": "x"}}]
    for corr, (a, b, launch, who) in enumerate(ops, start=1):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1,
                       "tid": tids[who], "ts": launch + shift_us, "dur": 3.0,
                       "args": {"correlation": corr, "cbid": 211}})
        events.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "pid": 0, "tid": 7,
                       "ts": a + shift_us, "dur": float(b - a), "args": {"correlation": corr}})
    return {"baseTimeNanoseconds": base, "traceEvents": events}


def _analyse(doc=None, spans=None):
    spans = [_span(*s) for s in SPANS] if spans is None else spans
    return host_phases.analyse(_doc() if doc is None else doc, spans, (MAIN.native_id, MAIN.ident))


def test_a_gap_inside_an_update_span_counts_to_update():
    got = _analyse()
    idle = got["idle_us"]
    # gaps: [150, 200) forward; [350, 400) backward; [450, 600) backward 50
    # + update 100; [700, 820) inside update; [830, 950) update 70 + train 50
    assert idle == pytest.approx({"forward": 50, "backward": 100, "update": 290, "train": 50})
    assert got["gap_us"] == pytest.approx(490)


def test_a_gap_straddling_backward_and_update_splits_by_overlap():
    ops = [(400, 450, 320, "autograd"), (600, 700, 550, "main")]
    got = _analyse(_doc(ops))
    assert got["idle_us"] == pytest.approx({"backward": 50, "update": 100})


def test_a_launch_from_a_thread_without_spans_takes_the_main_thread_s_span():
    got = _analyse()
    # k3 is launched by autograd's thread at 320, inside main's backward
    assert got["device_us"] == pytest.approx({"batch": 100, "forward": 150, "backward": 50,
                                              "update": 110, "train": 10})
    # a thread that holds spans of its own keeps its launches
    worker = types.SimpleNamespace(native_id=AUTOGRAD_TID + 5, ident=AUTOGRAD_TID)
    spans = [_span(*s) for s in SPANS] + [_span("stage_out", 310, 330, thread=worker)]
    assert _analyse(spans=spans)["device_us"]["stage_out"] == pytest.approx(50)


def test_base_time_nanoseconds_is_honoured():
    ref = _analyse()
    # the same moments written against another base
    moved = _analyse(_doc(base=BASE_NS - 7_000_000_123, shift_us=7_000_000.123))
    assert moved["idle_us"] == pytest.approx(ref["idle_us"])
    assert moved["device_us"] == pytest.approx(ref["device_us"])
    # a base the spans are not on puts every gap in no span
    off = _analyse(_doc(base=BASE_NS + 10**12))
    assert set(off["idle_us"]) == {None}


def test_gaps_sum_to_the_device_span_less_busy_and_edges_are_nobody_s():
    got = _analyse()
    busy = sum(b - a for a, b, _, _ in OPS)
    assert got["device_span_us"] == 960 - 50
    assert got["gap_us"] == pytest.approx(got["device_span_us"] - busy)
    assert got["main_cover_us"] == pytest.approx({"batch": 50, "forward": 200, "backward": 200,
                                                  "update": 400, "train": 60})
    assert got["tail_us"] == pytest.approx(60)  # k6 ends at 960, update closed at 900


def test_spans_without_the_clock_fields_read_nothing():
    spans = [{"event": "span", "span": name, "ts": 1.0, "dur_s": 0.1} for name, _, _ in SPANS]
    assert _analyse(spans=spans) is None


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"m_{name}", os.path.join(ROOT, "benchmark", "metrics",
                                                                               name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _run(tmp_path, cell="cnn_pbt_resident", subwindow=True, spans=None):
    path = tmp_path / "subwindow.pt.trace.json"
    path.write_text(json.dumps(_doc()))
    return types.SimpleNamespace(
        name=cell, spans=[_span(*s) for s in SPANS] if spans is None else spans,
        subwindow=types.SimpleNamespace(path=str(path)) if subwindow else None,
        profile={"window_s": 0.002, "kernels": []} if subwindow else None,
        cell={"profile": {"steps": 2}})


def test_the_metrics_of_a_cell(tmp_path, monkeypatch):
    monkeypatch.setattr(host_phases, "subwindow_holds_its_work", lambda run: True)
    run = _run(tmp_path)
    got = {n: _reader(n)(run) for n in NEW}
    # percent of the 2000 us sub-window; train's 50 us go to other
    assert got == pytest.approx({"batch_idle_pct": 0.0, "forward_idle_pct": 2.5,
                                 "backward_idle_pct": 5.0, "update_idle_pct": 14.5,
                                 "other_idle_pct": 2.5, "stage_in_idle_pct": 0.0,
                                 "eval_idle_pct": 0.0, "update_device_ms_per_step": 0.055})
    # the idle metrics sum to the gaps, the cells they are named in or not
    assert sum(got[n] for n in NEW[:7]) == pytest.approx(100 * 490e-6 / 0.002)


def test_a_run_with_no_sub_window_reads_none(tmp_path, monkeypatch):
    monkeypatch.setattr(host_phases, "subwindow_holds_its_work", lambda run: True)
    assert {n: _reader(n)(_run(tmp_path, subwindow=False)) for n in NEW} == dict.fromkeys(NEW)
    # nor one whose program's spans carry no clock (a parent without them)
    bare = [{"event": "span", "span": "train", "ts": 1.0, "dur_s": 0.1}]
    assert {n: _reader(n)(_run(tmp_path, spans=bare)) for n in NEW} == dict.fromkeys(NEW)
    # nor one whose sub-window does not hold its work
    monkeypatch.setattr(host_phases, "subwindow_holds_its_work", lambda run: False)
    assert {n: _reader(n)(_run(tmp_path)) for n in NEW} == dict.fromkeys(NEW)

"""The tracer's spans on the device trace's clock (``obs/trace.py``):
a span's ``[t0_ns, t1_ns]`` encloses the CUDA runtime launch events of
the kernels launched inside it and, where it synchronises before it
closes, their device intervals, in ``torch.profiler``'s exported Chrome
trace (``baseTimeNanoseconds`` plus ``ts`` in microseconds); and the
runtime events of the span's thread name it by its ``os_tid`` or by its
``thread_ident``'s low 32 bits; and what a span costs the host that runs
it, untraced and traced, and what writing the held records costs.

Imports neither JAX nor the JAX package, so it runs on a CUDA machine
without them: ``python -m pytest tests/port/test_torch_trace_clock.py
-m cuda --noconftest -s`` (``-s`` prints the measured offset between
the two clocks and the costs). Skips where there is no card.
"""

import io
import json
import threading
import time

import pytest
import torch

from mpi_opt_tpu_torch.obs import trace
from mpi_opt_tpu_torch.utils.metrics import MetricsLogger

#: how far a trace event may lie outside its span, in nanoseconds
SLACK_NS = 50_000
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _profiled(device, body):
    """(span records, trace events in ns on the epoch clock) of
    ``body()`` run under a CUDA-only ``torch.profiler`` session, as the
    benchmark's sub-window records it."""
    from torch.profiler import ProfilerActivity, profile

    sink = MetricsLogger(stream=io.StringIO())
    prior = trace.configure(sink)
    try:
        torch.cuda.synchronize(device)
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        body()
        torch.cuda.synchronize(device)
        prof.stop()
    finally:
        trace.deconfigure(prior)
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        doc = json.load(open(f.name))
    base = int(doc.get("baseTimeNanoseconds", 0))
    events = []
    for e in doc["traceEvents"]:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        t0 = base + round(float(e["ts"]) * 1e3)
        events.append(dict(e, t0=t0, t1=t0 + round(float(e.get("dur", 0.0)) * 1e3)))
    recs = [json.loads(line) for line in sink._stream.getvalue().splitlines()]
    return [r for r in recs if r["event"] == "span"], events


def _thread(tid) -> str:
    """Whether a trace event's ``tid`` names the calling thread."""
    tid = int(tid)
    mine = tid == threading.get_native_id() or tid & 0xFFFFFFFF == threading.get_ident() & 0xFFFFFFFF
    return "this thread" if mine else "another thread"


def _launches(events, names=("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
                             "cudaMemsetAsync", "cudaLaunchKernelExC", "cuLaunchKernelEx")):
    return [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and any(e["name"].startswith(n) for n in names)]


@pytest.mark.cuda
def test_spans_enclose_their_launches_and_device_time(cuda_device):
    x = torch.randn(4096, 4096, device=cuda_device)
    for _ in range(3):  # cuBLAS's handle and workspace, outside the trace
        x @ x
    torch.cuda.synchronize(cuda_device)

    def body():
        for _ in range(50):  # one launch a span, gaps between spans
            with trace.span("forward"):
                torch.add(x, 1.0)
        with trace.span("update"):  # a few large kernels and a synchronise
            for _ in range(4):
                x @ x
            torch.cuda.synchronize(cuda_device)

    spans, events = _profiled(cuda_device, body)
    me = threading.get_native_id()
    assert {(s["os_tid"], s["thread_ident"]) for s in spans} == {(me, threading.get_ident())}
    assert all(s["t0_ns"] <= s["t1_ns"] for s in spans)
    launches = sorted(_launches(events), key=lambda e: e["t0"])
    assert launches and {_thread(e["tid"]) for e in launches} == {"this thread"}
    # the i-th launch is the i-th forward span's; each brackets the offset
    # d (trace clock - span clock): t0 <= start - d and end - d <= t1
    fwd = sorted((s for s in spans if s["span"] == "forward"), key=lambda s: s["t0_ns"])
    pairs = list(zip(fwd, launches))
    lo = max(e["t1"] - s["t1_ns"] for s, e in pairs)
    hi = min(e["t0"] - s["t0_ns"] for s, e in pairs)
    upd = next(s for s in spans if s["span"] == "update")
    for s, e in pairs + [(upd, e) for e in launches[len(fwd):]]:
        assert s["t0_ns"] - SLACK_NS <= e["t0"] and e["t1"] <= s["t1_ns"] + SLACK_NS, (
            f"launch {e['name']} at {e['t0']} ns lies outside its span [{s['t0_ns']}, {s['t1_ns']}]")
    device = [e for e in events if e.get("cat") in DEVICE_CATS and e["t0"] >= upd["t0_ns"] - SLACK_NS]
    assert len(device) >= 4
    assert all(upd["t0_ns"] - SLACK_NS <= e["t0"] and e["t1"] <= upd["t1_ns"] + SLACK_NS for e in device)
    print(f"trace clock - span clock: offset within [{lo / 1e3:.3f}, {hi / 1e3:.3f}] us over "
          f"{len(pairs)} one-launch spans (the least margins: launch start after span start "
          f"{min(e['t0'] - s['t0_ns'] for s, e in pairs) / 1e3:.3f} us, launch end before span end "
          f"{min(s['t1_ns'] - e['t1'] for s, e in pairs) / 1e3:.3f} us); {len(launches)} launches; "
          f"the synchronised span's {len(device)} device operations end "
          f"{(upd['t1_ns'] - max(e['t1'] for e in device)) / 1e3:.3f} us before it closes")
    assert len(pairs) == 50 and lo <= hi and -SLACK_NS <= hi and lo <= SLACK_NS


@pytest.mark.cuda
def test_the_backward_launches_from_a_thread_without_spans(cuda_device):
    """Autograd's device thread runs a CUDA backward: its launches carry
    another ``tid`` than the calling thread's, and lie inside the calling
    thread's ``backward`` span, which the benchmark's reader of the
    joined trace then takes."""
    w = torch.randn(2048, 2048, device=cuda_device, requires_grad=True)
    x = torch.randn(2048, 2048, device=cuda_device)
    torch.autograd.grad((x @ w).square().sum(), [w])
    torch.cuda.synchronize(cuda_device)

    def body():
        with trace.span("forward"):
            loss = (x @ w).square().sum()
        with trace.span("backward"):
            torch.autograd.grad(loss, [w])

    spans, events = _profiled(cuda_device, body)
    bwd = next(s for s in spans if s["span"] == "backward")
    me = threading.get_native_id()
    launches = [e for e in _launches(events) if e["t0"] >= bwd["t0_ns"] - SLACK_NS]
    print(f"backward launches: {len(launches)}, from threads {sorted({e['tid'] for e in launches})} "
          f"(the span's thread {me}, {threading.get_ident()})")
    assert launches and all(e["t1"] <= bwd["t1_ns"] + SLACK_NS for e in launches)
    # autograd's own thread, which holds no span, makes the backward's
    # launches (the calling thread makes the gradient's seed)
    assert "another thread" in {_thread(e["tid"]) for e in launches}


@pytest.mark.cuda
def test_what_a_span_costs_its_host(cuda_device, tmp_path):
    """A span's cost on the card's host, untraced (a frame pushed and
    popped) and traced (the clock read and the record held), and the
    write of the held records at a boundary, per record."""
    n = 20000

    def per_span_us():
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(n):
                with trace.span("update"):
                    pass
            best = min(best, (time.perf_counter() - t0) / n * 1e6)
            trace.flush()  # the held records written between rounds, untimed
        return best

    untraced = per_span_us()
    m = MetricsLogger(path=str(tmp_path / "spans.jsonl"))
    prior = trace.configure(m)
    try:
        traced = per_span_us()  # every record held until the boundary
        writes = {}
        for k in (700, 2500):
            m.flush()
            for _ in range(k):
                with trace.span("update"):
                    pass
            t0 = time.perf_counter()
            trace.flush()
            writes[k] = (time.perf_counter() - t0) * 1e3
    finally:
        trace.deconfigure(prior)
        m.close()
    print(f"span cost on this host: {untraced:.3f} us untraced, {traced:.3f} us traced; writing "
          + ", ".join(f"{k} held records {ms:.3f} ms ({ms / k * 1e3:.3f} us a record)"
                      for k, ms in writes.items()))
    assert untraced < traced < 100.0

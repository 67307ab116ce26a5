"""``trace --timeline`` of the port (``mpi_opt_tpu_torch/obs/timeline.py``)
against the JAX package's ``mpi_opt_tpu/obs/timeline.py``, on the CPU.

``build`` and ``validate_timeline`` give equal documents and problem
lists on the same streams (the port's own traced fashion_mlp sweeps,
resident and in waves, and hand-edited copies with a second rank and a
tenant): process rows, per-thread tracks (the staging worker's lane),
span args with the roofline verdict, instant events and the synthetic
device-idle track. The one difference is ``otherData.generator``, which
names the port's command. ``write_timeline`` and the ``trace
--timeline`` subcommand are held against the JAX package's too.
"""

import copy
import json
import os

import pytest

import mpi_opt_tpu.obs.report as jreport
import mpi_opt_tpu.obs.timeline as jtimeline
from mpi_opt_tpu_torch import cli
from mpi_opt_tpu_torch.obs import report, timeline


def _write(path, records):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return path


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """label -> {stream label: records}: a traced PBT run, a traced wave
    SHA run, the PBT run as two ranks, and as two tenants."""
    d = tmp_path_factory.mktemp("streams")
    paths = {}
    for name, argv in (("pbt", ["--algorithm", "pbt", "--fused", "--population", "4",
                                "--generations", "3", "--steps-per-generation", "2",
                                "--gen-chunk", "1"]),
                       ("waves", ["--algorithm", "asha", "--fused", "--trials", "8",
                                  "--min-budget", "2", "--max-budget", "8", "--eta", "2",
                                  "--wave-size", "3"])):
        paths[name] = str(d / f"{name}.jsonl")
        assert cli.main(["--workload", "fashion_mlp", *argv, "--device", "cpu", "--trace",
                         "--metrics-file", paths[name]]) == 0
    pbt = report.load_stream(paths["pbt"])
    out = {name: {os.path.basename(p): report.load_stream(p)} for name, p in paths.items()}
    out["ranks"] = {"rank0/metrics.jsonl": pbt,
                    "rank1/metrics.jsonl": [{**r, "rank": 1} for r in pbt]}
    out["tenants"] = {"a/metrics.jsonl": [{**r, "tenant": "a"} for r in pbt],
                      "b/metrics.jsonl": [{**r, "tenant": "b"} for r in pbt]}
    out["empty"] = {"m.jsonl": []}
    out["paths"] = paths
    return out


def _same(got, want):
    """Equal documents but for the generator, which names each command."""
    assert got["otherData"].pop("generator") == "mpi_opt_tpu_torch trace --timeline"
    assert want["otherData"].pop("generator") == "mpi_opt_tpu trace --timeline"
    assert got == want


CASES = ["pbt", "waves", "ranks", "tenants", "empty"]


@pytest.mark.parametrize("peak", [None, 100.0])
@pytest.mark.parametrize("name", CASES)
def test_build_equals_jax(streams, name, peak):
    s = streams[name]
    got = timeline.build(copy.deepcopy(s), peak_tflops=peak)
    want = jtimeline.build(copy.deepcopy(s), peak_tflops=peak)
    assert timeline.validate_timeline(got) == jtimeline.validate_timeline(want) == []
    _same(got, want)
    if name == "empty":
        return
    evs = got["traceEvents"]
    threads = {e["args"]["name"] for e in evs if e["name"] == "thread_name"}
    assert "device idle" in threads and any(e.get("cat") == "bubble" for e in evs)
    if name == "waves":  # the staging worker renders as a lane of its own
        assert any(t.startswith("staging (tid ") for t in threads)
    if name in ("ranks", "tenants"):
        assert len({e["pid"] for e in evs if e["name"] == "process_name"}) == 2
    if peak:
        assert any(e.get("args", {}).get("bound") for e in evs if e["name"] == "train")


def test_build_reuses_an_attribution(streams):
    s = streams["waves"]
    rep = report.attribute(s, peak_tflops=50.0)
    assert rep == jreport.attribute(s, peak_tflops=50.0)
    _same(timeline.build(s, attribution=rep), jtimeline.build(s, attribution=rep))


BAD_DOCS = [
    [],
    {"traceEvents": {}},
    {"traceEvents": [1, {"ph": "X"}]},
    {"traceEvents": [{"name": "a", "ph": "B", "pid": 1, "tid": 0, "ts": 0}]},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 0, "ts": -1, "dur": -2}]},
    {"traceEvents": [{"name": "a", "ph": "i", "s": "x", "pid": 1, "tid": 0, "ts": 0}]},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 7, "tid": 0, "ts": 0, "dur": 1}]},
]


@pytest.mark.parametrize("doc", BAD_DOCS, ids=range(len(BAD_DOCS)))
def test_validate_timeline_equals_jax(doc):
    got = timeline.validate_timeline(copy.deepcopy(doc))
    assert got == jtimeline.validate_timeline(copy.deepcopy(doc)) and got


def test_write_timeline_equals_jax(streams, tmp_path):
    s = streams["ranks"]
    n = timeline.write_timeline(s, str(tmp_path / "port.json"))
    assert n == jtimeline.write_timeline(s, str(tmp_path / "jax.json"))
    assert sorted(os.listdir(tmp_path)) == ["jax.json", "port.json"]  # no temporary left
    with open(tmp_path / "port.json") as f, open(tmp_path / "jax.json") as g:
        _same(json.load(f), json.load(g))
    with pytest.raises(OSError):
        timeline.write_timeline(s, str(tmp_path / "missing" / "t.json"))
    assert not os.path.exists(tmp_path / "missing")


def _trace_cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("json_out", [False, True], ids=["text", "json"])
def test_trace_timeline_cli_equals_jax(streams, tmp_path, capsys, json_out):
    path = streams["paths"]["waves"]
    flags = ["--json"] if json_out else []
    got = _trace_cli(report.trace_main, [path, "--timeline", str(tmp_path / "p.json"), *flags],
                     capsys)
    want = _trace_cli(jreport.trace_main, [path, "--timeline", str(tmp_path / "j.json"), *flags],
                      capsys)
    assert got[0] == want[0] == 0 and got[1] == want[1]
    assert got[2].replace("p.json", "j.json") == want[2]
    assert got[2].startswith("timeline: ")
    with open(tmp_path / "p.json") as f, open(tmp_path / "j.json") as g:
        doc = json.load(f)
        assert timeline.validate_timeline(doc) == []
        _same(doc, json.load(g))


def test_trace_timeline_cli_unwritable_exits_1(streams, tmp_path, capsys):
    path = streams["paths"]["pbt"]
    out = str(tmp_path / "missing" / "t.json")
    got = _trace_cli(report.trace_main, [path, "--timeline", out], capsys)
    want = _trace_cli(jreport.trace_main, [path, "--timeline", out], capsys)
    assert got == want and got[0] == 1 and f"--timeline {out}: " in got[2]

"""``trace --diff``/``--gate`` of the port (``mpi_opt_tpu_torch/obs/diff.py``)
against the JAX package's ``mpi_opt_tpu/obs/diff.py``, on the CPU.

The same streams, tolerance files and bench records go through both
packages' ``load_attribution``, ``diff_attributions``,
``validate_tolerances``, ``apply_gate``, ``render_text``,
``validate_bench_record`` and ``bench_gate``, and through both
``trace`` subcommands: the outputs, exit codes and usage errors must be
equal (``==``; both sides run the same pure-Python arithmetic). The
streams are the port's own: traced fashion_mlp sweeps on the CPU, and
hand-edited copies (a train phase 3x slower and 0.5 s longer, device-memory attrs, a
second rank). No XLA compile.
"""

import copy
import json
import os

import pytest

import mpi_opt_tpu.obs.diff as jdiff
import mpi_opt_tpu.obs.report as jreport
from mpi_opt_tpu_torch import cli
from mpi_opt_tpu_torch.obs import diff, report
from mpi_opt_tpu_torch.obs import trace as ttrace


def _run(argv, path):
    saved = ttrace.save()
    try:
        assert cli.main(["--workload", "fashion_mlp", *argv, "--device", "cpu", "--trace",
                         "--metrics-file", path]) == 0
    finally:
        ttrace.deconfigure(saved)


def _write(path, records):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return path


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """name -> path: two traced PBT runs (base, new), a wave SHA run (the
    staging sections), a 3x slower train phase, memory attrs, and a
    directory of two ranks."""
    d = tmp_path_factory.mktemp("streams")
    out = {}
    pbt = ["--algorithm", "pbt", "--fused", "--population", "4", "--generations", "3",
           "--steps-per-generation", "2", "--gen-chunk", "1"]
    for name in ("base", "new"):
        out[name] = str(d / f"{name}.jsonl")
        _run(pbt, out[name])
    out["waves"] = str(d / "waves.jsonl")
    _run(["--algorithm", "asha", "--fused", "--trials", "8", "--min-budget", "2",
          "--max-budget", "8", "--eta", "2", "--wave-size", "3"], out["waves"])
    recs = report.load_stream(out["new"])
    slow = copy.deepcopy(recs)
    for r in slow:
        if r.get("span") == "train":
            r["dur_s"], r["self_s"] = 3 * r["dur_s"] + 0.5, 3 * r["self_s"] + 0.5
    out["slow"] = _write(str(d / "slow.jsonl"), slow)
    mem = copy.deepcopy(recs)
    for i, r in enumerate(r for r in mem if r.get("span") == "train"):
        r.update(mem_bytes=1000 + i, mem_peak_bytes=5000 + 100 * i, mem_src="cuda_allocator")
    out["mem"] = _write(str(d / "mem.jsonl"), mem)
    ranks = d / "ranks"
    _write(str(ranks / "rank0" / "metrics.jsonl"), recs)
    _write(str(ranks / "rank1" / "metrics.jsonl"), [{**r, "rank": 1} for r in recs])
    out["ranks"] = str(ranks)
    return out


def _attr_file(tmp_path, streams, name, peak=100.0):
    """A ``trace --json`` attribution file of ``streams[name]``."""
    path = str(tmp_path / f"{name}.attr.json")
    with open(path, "w") as f:
        json.dump(jreport.attribute({name: jreport.load_stream(streams[name])}, peak_tflops=peak), f)
    return path


PAIRS = [("base", "new"), ("new", "slow"), ("base", "waves"), ("new", "mem"), ("mem", "mem"),
         ("base", "ranks"), ("ranks", "ranks")]


@pytest.mark.parametrize("peak", [None, 100.0])
@pytest.mark.parametrize("pair", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_load_diff_and_render_equal_jax(streams, pair, peak):
    b, n = (streams[k] for k in pair)
    base = diff.load_attribution(b, peak_tflops=peak)
    new = diff.load_attribution(n, peak_tflops=peak)
    assert base == jdiff.load_attribution(b, peak_tflops=peak)
    assert new == jdiff.load_attribution(n, peak_tflops=peak)
    rep = diff.diff_attributions(base, new, b, n)
    want = jdiff.diff_attributions(base, new, b, n)
    assert rep == want
    assert diff.render_text(rep) == jdiff.render_text(want)
    if pair == ("new", "slow"):
        assert rep["significant_regressions"] == ["train"]


TOLS = {
    "empty": {},
    "loose": {"default": 10.0, "wall_max_rel_increase": 10.0},
    "train-budget": {"phases": {"train": 0.1}, "require_significant": False},
    "ignore-train": {"phases": {"train": 0.1}, "ignore": ["train"]},
    "mxu-floor": {"min_mxu_frac": 0.99},
    "idle": {"idle_frac": 0.0},
    "overlap": {"min_overlap": 1.0},
    "everything": {"default": 0.0, "require_significant": False, "max_cold_compile_increase": 0,
                   "ttft_max_rel_increase": 0.0, "tflops_max_rel_decrease": 0.0,
                   "wall_max_rel_increase": 0.0, "memory_max_rel_increase": 0.0,
                   "idle_frac": 1.0, "min_overlap": 0.0, "min_mxu_frac": 0.0},
    "lost-phase": {"phases": {"stage_in": 0.5}},
}


@pytest.mark.parametrize("tol", list(TOLS))
@pytest.mark.parametrize("pair", [("base", "new"), ("new", "slow"), ("waves", "base"),
                                  ("new", "mem"), ("base", "waves")],
                         ids=["base-new", "new-slow", "waves-base", "new-mem", "base-waves"])
def test_apply_gate_equals_jax(streams, pair, tol):
    base, new = (diff.load_attribution(streams[k], peak_tflops=100.0) for k in pair)
    rep = diff.diff_attributions(base, new)
    want = jdiff.diff_attributions(base, new)
    gate = diff.apply_gate(rep, copy.deepcopy(TOLS[tol]))
    assert gate == jdiff.apply_gate(want, copy.deepcopy(TOLS[tol]))
    assert rep == want and diff.render_text(rep) == jdiff.render_text(want)
    if tol == "mxu-floor":
        assert any("below the 99% floor" in v for v in gate["violations"])
    if pair == ("new", "mem"):  # the same timings: only budgets on memory or the new side fail
        assert gate["ok"] == (tol not in ("mxu-floor", "idle"))


BAD_TOLS = [[], {"defualt": 0.1}, {"default": True}, {"default": None}, {"phases": []},
            {"phases": {"train": "x"}}, {"ignore": "train"}, {"ignore": [1]},
            {"require_significant": 1}, {"min_mxu_frac": [0.5]}]


@pytest.mark.parametrize("tol", BAD_TOLS, ids=[str(t) for t in BAD_TOLS])
def test_validate_tolerances_refuses_what_jax_refuses(tol):
    with pytest.raises(ValueError) as got:
        diff.validate_tolerances(tol)
    with pytest.raises(ValueError) as want:
        jdiff.validate_tolerances(tol)
    assert str(got.value) == str(want.value)


def _records(streams):
    """Bench records: legacy shapes, version 2, a wrapper, broken ones,
    with and without an embedded attribution."""
    attr = lambda name: jreport.attribute({name: jreport.load_stream(streams[name])},
                                         peak_tflops=100.0)
    rec = {"metric": "pbt_cifar10_cnn_member_generations_per_sec_per_chip", "value": 14.6,
           "unit": "trials/sec/chip"}
    return {
        "legacy": rec,
        "legacy-traced": {**rec, "trace": attr("base")},
        "v2": {**rec, "schema_version": 2, "trace": attr("new"),
               "device_memory": {"bytes_in_use": 1, "source": "x"}},
        "v2-null": {**rec, "schema_version": 2, "trace": None, "device_memory": None},
        "v2-missing": {**rec, "schema_version": 2},
        "v3": {**rec, "schema_version": 3, "trace": None, "device_memory": None},
        "v1": {**rec, "schema_version": 1},
        "bad-trace": {**rec, "schema_version": 2, "trace": {"phases": {"train": {}}},
                      "device_memory": None},
        "bad-memory": {**rec, "schema_version": 2, "trace": None, "device_memory": {"x": 1}},
        "bad-scores": {**rec, "schema_version": 2, "trace": None, "device_memory": None,
                       "scores": {"accuracy": True}},
        "scores": {**rec, "schema_version": 2, "trace": None, "device_memory": None,
                   "scores": {"accuracy": 0.9, "params": 2e4}},
        "no-metric": {"value": 1.0, "unit": "s"},
        "string-value": {**rec, "value": "fast"},
        "not-a-dict": [rec],
        "slow": {**rec, "value": 7.0, "trace": attr("slow")},
        "seconds": {"metric": "wall_to_target", "value": 70.0, "unit": "seconds"},
    }


def test_validate_bench_record_equals_jax(streams):
    recs = _records(streams)
    verdicts = {k: diff.validate_bench_record(r) for k, r in recs.items()}
    assert verdicts == {k: jdiff.validate_bench_record(r) for k, r in recs.items()}
    assert verdicts["legacy"] == verdicts["v2"] == verdicts["scores"] == []
    assert verdicts["bad-scores"] and verdicts["bad-trace"] and verdicts["v2-missing"]


@pytest.mark.parametrize("case", ["same", "slower", "wrapper", "configs", "empty", "disjoint",
                                  "value-lost", "seconds"])
def test_bench_gate_equals_jax(streams, case):
    r = _records(streams)
    base, new, tol = {
        "same": (r["legacy-traced"], r["legacy-traced"], None),
        "slower": ([r["legacy-traced"]], [r["slow"]], {"default": 0.5}),
        "wrapper": ({"parsed": r["legacy-traced"]}, [{"parsed": r["slow"]}], None),
        "configs": ([{**r["legacy"], "config": 2}, {**r["legacy-traced"], "config": 4}],
                    [{**r["legacy"], "config": 2, "value": 3.0}, {**r["slow"], "config": 4},
                     {**r["legacy"], "config": 8}], {"value_max_rel_regression": 0.1}),
        "empty": ([], [r["legacy"]], None),
        "disjoint": ([{**r["legacy"], "config": 1}], [{**r["legacy"], "config": 2}], None),
        "value-lost": ([r["legacy"]], [{**r["legacy"], "value": None, "error": "crashed"}], None),
        "seconds": ([r["seconds"]], [{**r["seconds"], "value": 100.0}], None),
    }[case]
    got = diff.bench_gate(base, new, copy.deepcopy(tol))
    assert got == jdiff.bench_gate(base, new, copy.deepcopy(tol))
    assert got["ok"] == (case == "same")


@pytest.mark.parametrize("kind", ["stream", "directory", "trace-json", "bench-record",
                                  "wrapper", "record-list", "bench-lines"])
def test_load_attribution_equals_jax_on_every_target(streams, tmp_path, kind):
    recs = _records(streams)
    target = {
        "stream": lambda: streams["waves"],
        "directory": lambda: streams["ranks"],
        "trace-json": lambda: _attr_file(tmp_path, streams, "new"),
        "bench-record": lambda: _write(str(tmp_path / "r.json"), [recs["v2"]]),
        "wrapper": lambda: _write(str(tmp_path / "w.json"), [{"parsed": recs["legacy-traced"]}]),
        "record-list": lambda: _write(str(tmp_path / "l.json"), [[recs["legacy"], recs["v2"]]]),
        "bench-lines": lambda: _write(str(tmp_path / "b.jsonl"), [recs["legacy"], recs["slow"]]),
    }[kind]()
    got = diff.load_attribution(target, peak_tflops=50.0)
    assert got == jdiff.load_attribution(target, peak_tflops=50.0) and "phases" in got


@pytest.mark.parametrize("kind", ["no-trace", "two-traces", "not-a-stream", "missing",
                                  "empty-dir"])
def test_load_attribution_refuses_what_jax_refuses(streams, tmp_path, kind):
    recs = _records(streams)
    target = {
        "no-trace": lambda: _write(str(tmp_path / "r.json"), [recs["legacy"]]),
        "two-traces": lambda: _write(str(tmp_path / "l.json"),
                                     [[recs["legacy-traced"], recs["slow"]]]),
        "not-a-stream": lambda: _write(str(tmp_path / "x.jsonl"), []),
        "missing": lambda: str(tmp_path / "nope.jsonl"),
        "empty-dir": lambda: str(tmp_path),
    }[kind]()
    errors = []
    for mod in (diff, jdiff):
        with pytest.raises((ValueError, OSError)) as e:
            mod.load_attribution(target)
        errors.append(type(e.value))
    assert errors[0] is errors[1]


# -- the trace subcommand: output, exit codes, usage errors ----------------


def _trace_cli(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    err = out.err.strip().splitlines()
    return rc, out.out, err[-1].split("error: ", 1)[-1] if err else ""


@pytest.mark.parametrize("case", ["text", "json", "gate-ok", "gate-fail", "gate-fail-json",
                                  "unreadable", "unreadable-json"])
def test_trace_diff_cli_equals_jax(streams, tmp_path, capsys, case):
    tol = lambda t: _write(str(tmp_path / "tol.json"), [TOLS[t]])
    b, n = streams["base"], streams["slow"]
    argv = {
        "text": [b, n],
        "json": [b, n, "--json"],
        "gate-ok": [streams["new"], streams["mem"], "--gate", tol("loose"), "--peak-tflops", "100"],
        "gate-fail": [b, n, "--gate", tol("mxu-floor"), "--peak-tflops", "100"],
        "gate-fail-json": [b, n, "--json", "--gate", tol("train-budget")],
        "unreadable": [b, str(tmp_path / "nope.jsonl")],
        "unreadable-json": [b, str(tmp_path / "nope.jsonl"), "--json"],
    }[case]
    got = _trace_cli(report.trace_main, ["--diff", *argv], capsys)
    assert got == _trace_cli(jreport.trace_main, ["--diff", *argv], capsys)
    assert got[0] == {"text": 0, "json": 0, "gate-ok": 0, "gate-fail": 1, "gate-fail-json": 1,
                      "unreadable": 1, "unreadable-json": 1}[case]


@pytest.mark.parametrize("argv", [
    ["m.jsonl", "--gate", "tol.json"],
    ["m.jsonl", "--diff"],
    ["a.jsonl", "b.jsonl", "c.jsonl", "--diff"],
    ["a.jsonl", "b.jsonl", "--diff", "--timeline", "t.json"],
    ["a.jsonl", "b.jsonl", "--diff", "--gate", "missing.json"],
    ["a.jsonl", "b.jsonl", "--diff", "--gate", "bad.json"],
    ["a.jsonl", "--peak-tflops", "0"],
], ids=["gate-without-diff", "one-target", "three-targets", "timeline-with-diff", "gate-missing",
        "gate-unknown-key", "peak-zero"])
def test_trace_usage_errors_equal_jax(argv, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    _write(str(tmp_path / "bad.json"), [{"defualt": 0.1}])
    got = _trace_cli(report.trace_main, argv, capsys)
    assert got == _trace_cli(jreport.trace_main, argv, capsys)
    assert got[0] == 2 and got[1] == ""

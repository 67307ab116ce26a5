"""The harness: cells found by name, no card no result, no JAX loaded.
Subprocesses run from the checkout's root or from a copy of it."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _python(code: str, cwd: str, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_a_planted_cell_is_found_by_name(tmp_path):
    """A new cell is an entry in BENCHMARK.json and a file under
    ``benchmark/cells``: a copy with one planted finds it, its
    configuration, path module and metrics, with no code edited."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    base = bench["workloads"][0]
    planted = dict(base, name="planted_cell", traffic="planted_cell")
    bench["workloads"].append(planted)
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in m and base["name"] in m["workloads"]:
            m["workloads"].append("planted_cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = json.loads(open(os.path.join(ROOT, "benchmark", "cells", base["traffic"] + ".json")).read())
    cell["member_chunk"] = 64
    (tmp_path / "benchmark" / "cells" / "planted_cell.json").write_text(json.dumps(cell))
    code = (
        "import json, os\n"
        "from benchmark import run\n"
        "b = json.load(open('BENCHMARK.json'))\n"
        "entry, cfg, cell = run.find_cell(b, 'planted_cell')\n"
        "path = run.load_module(os.path.join(run.HERE, 'paths', cell['path'] + '.py'))\n"
        "names = [m['name'] for m in run.metrics_for(b, 'per_layer', 'planted_cell')]\n"
        "readers = [run.load_module(os.path.join(run.HERE, 'metrics', n + '.py')).read for n in names]\n"
        "print(json.dumps([entry['name'], cfg['name'], cell['member_chunk'], hasattr(path, 'window'),"
        " len(readers), run.HERE]))\n"
    )
    out = _python(code, str(tmp_path))
    assert out.returncode == 0, out.stderr
    name, config, chunk, has_window, n_readers, here = json.loads(out.stdout.strip().splitlines()[-1])
    assert (name, config, chunk, has_window) == ("planted_cell", base["config"], 64, True)
    assert n_readers >= 1 and os.path.realpath(here) == os.path.realpath(tmp_path / "benchmark")


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cnn_pbt_resident",
                          "--seed", "3000000001", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_the_loaded_modules_hold_no_jax():
    """Everything a run imports, the program's modules included, and no
    module whose top-level name is jax, jaxlib, flax or mpi_opt_tpu."""
    code = (
        "import glob, os, sys\n"
        "from benchmark import run, judge, calibrate, data, subwindow, readers\n"
        "import mpi_opt_tpu_torch.train.fused_pbt, mpi_opt_tpu_torch.ledger\n"
        "import mpi_opt_tpu_torch.health.shutdown, mpi_opt_tpu_torch.utils.metrics\n"
        "for d in ('paths', 'metrics'):\n"
        "    for f in sorted(glob.glob(os.path.join(run.HERE, d, '*.py'))):\n"
        "        run.load_module(f)\n"
        "print(run.forbidden_modules())\n"
    )
    out = _python(code, ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_reader_that_loads_jax_leaves_no_result(tmp_path):
    """The look for JAX comes after every reader: a metric reader
    planted in a copy, which imports a stub top-level ``jax``, makes the
    run exit 1 with no result line. The card-bound part of the run is
    replaced by the end of a run: its result object is built by the
    harness's own ``finish``."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    (tmp_path / "stub").mkdir()
    (tmp_path / "stub" / "jax.py").write_text("STUB = True\n")
    (tmp_path / "benchmark" / "metrics" / "planted.py").write_text(
        "def read(run):\n    import jax\n    return 1.0 if jax.STUB else None\n")
    code = (
        "import json, sys\n"
        "from benchmark import run as h\n"
        "bench = {'end_to_end': [{'name': 'planted', 'unit': '%'}], 'per_layer': []}\n"
        "def measure(args):\n"
        "    r = h.Run('cell', 1, 1, False, {'population': 4}, {'check_steps': [1, 3],\n"
        "              'two_generation_steps': 3, 'check_members': 2}, None, '.')\n"
        "    r.window = {'attempted': 4, 'failed': 0}\n"
        "    return h.finish(bench, r, {'gap': {'value': 0.0, 'limit': 1.0}},\n"
        "                    {'platform': 'gpu', 'kind': 'stub', 'count': 1, 'memory_peak_bytes': 1})\n"
        "h.measure = measure\n"
        "rc = h.main(['--workload', 'cell', '--seed', '1', '--seconds', '1'])\n"
        "print('jax' in sys.modules, file=sys.stderr)\n"
        "sys.exit(rc)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(tmp_path / "stub"))
    out = _python(code, str(tmp_path), env=env)
    assert out.returncode == 1, out.stderr
    assert out.stdout.strip() == ""
    assert "modules of JAX or the JAX package are loaded: ['jax']" in out.stderr
    assert out.stderr.strip().splitlines()[-1] == "True"


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    """One short run of the first cell, on the card: a result line whose
    metrics are the cell's end-to-end ones, correct."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "resnet18_pbt_resident",
                          "--seed", "3000000099", "--seconds", "5", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and set(result["metrics"]) == {"member_steps_per_s", "setup_s"}


def test_a_sub_window_that_lost_launches_is_taken_anew(monkeypatch, tmp_path):
    """Sub-windows of two beats from beat 1: one whose kernel names lack
    a GroupNorm launch is taken anew over the next two beats, and the
    last one recorded is exported; one that holds its launches ends the
    profiling; after three short ones, the third is read."""
    import types

    import torch
    import torch.profiler

    from benchmark import subwindow

    launches = iter([3, 4, 4])  # the first session lost one launch

    class Prof:
        def __init__(self, activities):
            self.n = next(launches)
            events = [types.SimpleNamespace(name=lambda: "gn_fwd_kernel") for _ in range(self.n)]
            self.profiler = types.SimpleNamespace(kineto_results=types.SimpleNamespace(events=lambda: events))

        def start(self):
            pass

        def stop(self):
            pass

        def export_chrome_trace(self, path):
            events = [{"ph": "X", "cat": "kernel", "name": "gn_fwd_kernel", "ts": 10.0 * i, "dur": 5.0}
                      for i in range(self.n)]
            with open(path, "w") as f:
                json.dump({"traceEvents": events}, f)

    monkeypatch.setattr(torch.profiler, "profile", Prof)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)

    def record():
        sw = subwindow.SubWindow(1, 3, str(tmp_path), "cuda", holds_its_work=lambda names: len(names) == 4)
        sw.arm()
        for _ in range(9):
            sw.on_beat(None)
        assert sw.error is None
        return sw

    sw = record()
    assert [s["held"] for s in sw.sessions] == [False, True]
    chosen = sw.export()
    assert chosen["session"] == 1 and len(chosen["kernels"]) == 4
    launches = iter([3, 2, 1])
    sw = record()
    assert [s["held"] for s in sw.sessions] == [False] * 3
    last = sw.export()
    assert last["session"] == 2 and len(last["kernels"]) == 1

"""BENCHMARK.json against the rules its checker applies, and the files
the harness finds by name. Run on the CPU: ``python -m pytest
benchmark/tests -q``."""

from __future__ import annotations

import ast
import json
import os
import re

from benchmark.judge import NUMBERS

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
FORBIDDEN = {"jax", "jaxlib", "flax", "mpi_opt_tpu"}


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in b["paths"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for key in ("end_to_end", "per_layer"):
        for m in b[key]:
            allowed = {"name", "unit", "better", "source"} | (
                {"bound"} if key == "end_to_end" else {"layer", "moves"})
            assert set(m) - {"workloads"} == allowed, m["name"]
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m["name"]
            assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
            names.append(m["name"])
            if key == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert _line(m["layer"])
    assert len(names) == len(set(names))


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"] == cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in e2e[m["moves"]], (m["name"], cell)
    for cell in cells:
        assert any(cell in v for k, v in e2e.items() if k != "setup_s")
        assert any(cell in m.get("workloads", cells) for m in b["per_layer"])


def test_every_name_has_its_file_and_configs_are_used():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in b["workloads"]:
        with open(os.path.join(BENCH, "cells", w["traffic"] + ".json")) as f:
            cell = json.load(f)
        assert os.path.exists(os.path.join(BENCH, "paths", cell["path"] + ".py"))
        assert set(cell["limits"]) <= set(NUMBERS)
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py")), m["name"]


def test_a_full_check_fits_its_time():
    b = bench()
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module)
    return out


def test_no_source_imports_jax_and_the_reference_imports_no_program():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            if os.sep + "tests" + os.sep in path:
                continue
            assert not tops & FORBIDDEN, path
            if os.sep + "reference" + os.sep in path:
                assert "mpi_opt_tpu_torch" not in tops, path

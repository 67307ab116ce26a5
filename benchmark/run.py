"""The benchmark of ``mpi_opt_tpu_torch``: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json``: the cell's entry
names its configuration (``configs``' ``file``) and its traffic, whose
file ``benchmark/cells/<traffic>.json`` names the path module that
drives the program (``benchmark/paths/<path>.py``); every metric the
cell reports is read by ``benchmark/metrics/<metric>.py``. A new
configuration, cell or metric is new files and entries only.

A run makes the data from the seed on the card, lets the path's set-up
sweeps build every shape (and keeps what they produced), opens the
window, drives the program until the path closes it, then judges the
set-up sweeps' outputs against the plain reference (``judge.py``).
``--trace 1`` also records the program's spans and a profiled device
sub-window, and reports the per-layer metrics in place of the
end-to-end ones. The last line on standard output is one JSON object;
the numbers compared, each beside its limit, close standard error.
Without a card with as many devices as the cell asks for it exits 1
and prints no result; it never falls back to the CPU. Nor does it print
one when, after everything else, JAX, jaxlib, flax or the JAX package
is loaded in the process.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT  # run as a script: the checkout's root, not this folder
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# fixed cache directories inside the checkout, set before torch loads
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")

FORBIDDEN = ("jax", "jaxlib", "flax", "mpi_opt_tpu")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def process_age() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def load_module(path: str):
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + os.path.relpath(path, HERE).replace(os.sep, "_").replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def find_cell(bench: dict, name: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, cell file) of cell ``name``."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "cells", entry["traffic"] + ".json")) as f:
        cell = json.load(f)
    return entry, cfg, cell


def metrics_for(bench: dict, key: str, cell: str) -> list:
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]


class Run:
    """What a path module and the metric readers share in one run."""

    def __init__(self, name, seed, seconds, traced, cfg, cell, device, tmp):
        import numpy as np

        self.name, self.seed, self.seconds, self.traced = name, seed, float(seconds), bool(traced)
        self.cfg, self.cell, self.device, self.tmp = cfg, cell, device, tmp
        self.population = cell.get("population", cfg["population"])
        # set-up sweeps' steps: first gradient, first steps, and the eval
        self.check_steps = tuple(cell["check_steps"])
        # and the sweep of two generations: the second trains the rows the
        # first one's exploit chose
        self.two_generation_steps = int(cell["two_generation_steps"])
        k = min(cell["check_members"], self.population)
        rng = np.random.default_rng(seed)
        self.sample = sorted(int(i) for i in rng.choice(self.population, k, replace=False))
        self.data = None
        self.subwindow = None
        self.window = {}
        self.spans = []
        self.profile = None
        self.gn_launches = {}
        self.setup_s = None
        self.w0_epoch = None

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":  # the CPU tests run the path on the host
            torch.cuda.synchronize(self.device)

    def window_opens(self) -> None:
        """Called by the path right before the measured sweep starts."""
        import torch
        from mpi_opt_tpu_torch.ops import group_norm

        self.sync()
        torch.cuda.reset_peak_memory_stats(self.device)
        self.gn_launches = dict(group_norm.LAUNCHES)
        self.setup_s = process_age()
        self.w0_epoch = time.time()


def card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def measure(args) -> dict:
    """One run; returns the result object (the last line's content)."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry, cfg, cell = find_cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        raise SystemExit(f"{entry['name']} needs {entry['chips']} CUDA device(s); "
                         f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    device = torch.device("cuda", 0)
    log(f"card: {card_line()}")
    tmp = tempfile.mkdtemp(prefix="bench_")
    try:
        return _measure(bench, entry, cfg, cell, device, tmp, args)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _measure(bench, entry, cfg, cell, device, tmp, args) -> dict:
    import torch

    run = Run(entry["name"], args.seed, args.seconds, args.trace, cfg, cell, device, tmp)
    path = load_module(os.path.join(HERE, "paths", cell["path"] + ".py"))
    log(f"{run.name}: {cfg['model']} population {run.population}, batch {cfg['batch_size']}, "
        f"cell {json.dumps({k: v for k, v in cell.items() if k != 'limits'})}")

    sink = trace_prior = None
    from benchmark.data import make_images

    if run.traced:
        from mpi_opt_tpu_torch.health import heartbeat
        from mpi_opt_tpu_torch.obs import trace
        from mpi_opt_tpu_torch.utils.metrics import MetricsLogger

        from benchmark.subwindow import SubWindow

        sink = MetricsLogger(path=os.path.join(tmp, "spans.jsonl"))
        trace_prior = trace.configure(sink)
        heartbeat.configure(os.path.join(tmp, "beat.json"))
        prof = cell["profile"]
        from benchmark.readers import launches_hold

        run.subwindow = SubWindow(prof["start_beat"], prof["stop_beat"], tmp, device,
                                  holds_its_work=launches_hold(run))
    try:
        marks = [("start", process_age())]
        run.data = make_images(cfg, run.seed, device)
        marks.append(("data", process_age()))
        prepared = path.prepare(run)
        marks.append(("prepare", process_age()))
        observed = path.check(run, prepared)
        marks.append(("set-up sweeps", process_age()))
        log("set-up: " + ", ".join(f"{n} at {t:.2f} s" for n, t in marks))
        run.window = path.window(run, prepared)
    finally:
        if run.traced:
            from mpi_opt_tpu_torch.health import heartbeat
            from mpi_opt_tpu_torch.obs import trace

            trace.deconfigure(trace_prior)
            sink.close()
            heartbeat.deconfigure()
    w = run.window
    from mpi_opt_tpu_torch.ops import group_norm

    launches = sum(group_norm.LAUNCHES[k] - run.gn_launches.get(k, 0) for k in ("gn_fwd", "gn_bwd"))
    peak = torch.cuda.max_memory_allocated(device)
    b = w["boundaries"]
    log(f"window: {w['generations']} generations, {w['member_steps']} member-steps in "
        f"{w['t1'] - w['t0']} s (generations {[y - x for x, y in zip(b, b[1:])]} s); "
        f"set-up {run.setup_s} s")
    log(f"GroupNorm launches a step: {launches / max(1, w['steps'])} ({launches} over {w['steps']} steps)")
    log(f"peak device memory: {peak} bytes")
    del prepared
    import gc

    gc.collect()
    torch.cuda.empty_cache()

    if run.traced:
        with open(os.path.join(tmp, "spans.jsonl")) as f:
            run.spans = [r for r in map(json.loads, f) if r.get("event") == "span"]
        if run.subwindow.error:
            log(f"profiler sub-window: {run.subwindow.error}")
        from benchmark.readers import gn_expected, gn_times

        run.profile = run.subwindow.export()
        if run.profile is not None:
            log(f"profiled sub-window {run.profile['session'] + 1} (of at most {len(run.subwindow.bounds)}): "
                + ", ".join(f"{k} {len(gn_times(run.profile, b))} launches of {gn_expected(run, b)[0]}"
                            for k, b in (("gn_fwd", False), ("gn_bwd", True)))
                + f", {len(run.profile['kernels'])} device operations in {run.profile['window_s']} s")

    from benchmark.judge import judge

    t_ref = time.perf_counter()
    numbers = judge(run, observed)
    log(f"reference check: {time.perf_counter() - t_ref} s")
    limits = cell["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    device_line = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": entry["chips"], "memory_peak_bytes": peak}
    return finish(bench, run, checks, device_line)


def finish(bench, run, checks: dict, device_line: dict) -> dict:
    """The result object: the cell's metrics, each read by its reader,
    the device and the checks. Last of all, the look at what the process
    has loaded: a run with JAX, jaxlib, flax or the JAX package in
    ``sys.modules``, whoever loaded it (the program, the reference, a
    reader), gives no result."""
    metrics = {}
    for m in metrics_for(bench, "per_layer" if run.traced else "end_to_end", run.name):
        value = load_module(os.path.join(HERE, "metrics", m["name"] + ".py")).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    w = run.window
    result = {
        "correct": all(v["value"] <= v["limit"] for v in checks.values()),
        "attempted": w["attempted"],
        "failed": w["failed"],
        "metrics": metrics,
        "device": dict(device_line),
    }
    if run.traced and run.profile is not None:
        result["device"]["busy_s"] = run.profile["busy_s"]
        result["device"]["window_s"] = run.profile["window_s"]
        result["breakdown"] = {"device_ops": run.profile["device_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: {found}")
    return result


def parse(argv=None):
    p = argparse.ArgumentParser(description="Run one cell of the benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        result = measure(args)
    except SystemExit as e:
        log(f"no result: {e}")
        return 1
    except Exception:
        traceback.print_exc()
        log("no result: the run failed")
        return 1
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

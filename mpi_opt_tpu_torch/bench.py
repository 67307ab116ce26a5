"""The north-star benchmark of the port: fused PBT over a SmallCNN
population on synthetic CIFAR-10 (port of ``bench.py::bench_tpu`` and of
the record ``bench.py::main`` prints).

A trial is one PBT member-generation: ``steps`` training steps plus one
validation eval of one member. The sweep runs twice with the same
arguments: a warm-up (cuDNN picks its algorithms on first use), then
the measured run, closed by a device synchronise. Host data generation
happens before either. Both runs are traced (``obs/trace.py``) unless
``--no-trace`` is given, and the record's ``trace`` is the stream's
attribution (``obs/report.bench_attribution``); ``--trace-file`` keeps
the stream there and names it in ``trace_stream``. ``--profile-dir
DIR`` wraps the measured run in a ``torch.profiler`` window
(``utils/profiling.py``: one Chrome trace-event JSON in DIR; a profiled
run's rate is not comparable to an unprofiled one). Prints one JSON
line on stdout with the JAX bench's record keys; the measured matmul
cap is not measured yet (null), and the CPU baseline is skipped.

    python -m mpi_opt_tpu_torch.bench [--population 256] [--generations 4]
        [--steps 100] [--seed 0] [--member-chunk 32] [--gen-chunk 1]
        [--target-acc 0.70] [--trace-file PATH | --no-trace] [--profile-dir DIR]
        [--device cuda|cpu]

It runs on CUDA, and refuses to run without it unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from mpi_opt_tpu_torch.device import resolve_device
from mpi_opt_tpu_torch.obs import report, trace
from mpi_opt_tpu_torch.train.fused_pbt import fused_pbt
from mpi_opt_tpu_torch.utils.flops import mfu, population_sweep_flops
from mpi_opt_tpu_torch.utils.metrics import sweep_wall_to_target
from mpi_opt_tpu_torch.utils.profiling import profile_window
from mpi_opt_tpu_torch.workloads import get_workload

METRIC = "pbt_cifar10_cnn_member_generations_per_sec_per_chip"


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(population: int = 256, generations: int = 4, steps: int = 100, seed: int = 0,
        member_chunk: int = 32, gen_chunk: int = 1, target_acc: float = 0.70,
        device=None, traced: bool = True, trace_file: str | None = None,
        profile_dir: str | None = None) -> tuple[dict, dict]:
    """Warm-up sweep of ``cifar10_cnn``, then the measured one, both
    traced into ``trace_file`` (a temporary file when None) unless
    ``traced`` is False; the measured one profiled into ``profile_dir``
    when given. Returns (record, the measured sweep's ``fused_pbt``
    result)."""
    from mpi_opt_tpu_torch.utils.metrics import MetricsLogger

    dev = resolve_device(device)
    wl = get_workload("cifar10_cnn")
    wl.data()  # host data generation: set-up, outside the timed runs
    kw = dict(population=population, generations=generations, steps_per_gen=steps, seed=seed,
              member_chunk=member_chunk, gen_chunk=gen_chunk, device=dev)
    log(f"{wl.name} on {dev}: pop={population} gens={generations} steps={steps} "
        f"member_chunk={member_chunk} gen_chunk={gen_chunk}")
    trace_path = trace_prior = None
    if traced:
        trace_path = trace_file or os.path.join(tempfile.mkdtemp(prefix="bench_trace_"), "bench.jsonl")
        trace_metrics = MetricsLogger(path=trace_path)
        trace_prior = trace.configure(trace_metrics)
    try:
        t0 = time.perf_counter()
        fused_pbt(wl, **kw)
        _sync(dev)
        warmup = time.perf_counter() - t0
        log(f"warm-up {warmup:.3f} s")
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        with profile_window(profile_dir, device=dev):
            t0 = time.perf_counter()
            result = fused_pbt(wl, **kw)
            _sync(dev)
            wall = time.perf_counter() - t0
    finally:
        if traced:
            trace.deconfigure(trace_prior)
            trace_metrics.close()
    attribution = None
    if traced:
        attribution = report.bench_attribution(trace_path)
        log(f"trace {trace_path}: coverage {attribution['coverage']}")
    device_memory = None
    if dev.type == "cuda":
        device_memory = {
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "source": "torch.cuda.max_memory_allocated, reset before the measured run",
        }
    # counted after the timed window, on the meta device
    flops = population_sweep_flops(wl, population, generations, steps, n_evals=generations)
    util = mfu(flops, wall, dev)
    trials = population * generations
    best = None if result["diverged"] else result["best_score"]
    log(f"{trials} member-generations in {wall:.3f} s; best {best}, "
        f"curve {[float(v) for v in result['best_curve']]}")
    record = {
        "metric": METRIC,
        "value": trials / wall,
        "unit": "trials/sec/chip",
        "population": population,
        "generations": generations,
        "steps_per_gen": steps,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "best_val_acc": best,
        "target_acc": target_acc,
        "wall_to_target_s": sweep_wall_to_target(result, wall, target_acc),
        "flops_total": flops,
        "tflops_per_sec": flops / wall / 1e12,
        "mfu": util,
        # not measured yet: the matmul cap
        "platform_matmul_tflops": None,
        "mfu_vs_platform_cap": None,
        "trace": attribution,
        "trace_stream": trace_file if traced else None,
        "device_memory": device_memory,
        "vs_baseline": 1.0,
        "baseline": "skipped",
        # the port's own keys
        "member_steps_per_sec": trials * steps / wall,
        "wall_s": wall,
        "warmup_s": warmup,
        "launch_gens": result["launch_gens"],
        "launch_walls_s": result["launch_walls"],
        "best_curve": [float(v) for v in result["best_curve"]],
        "mean_curve": [float(v) for v in result["mean_curve"]],
        "member_failures": result["member_failures"],
        "member_chunk": member_chunk,
        "gen_chunk": gen_chunk,
        "seed": seed,
    }
    return record, result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--population", type=int, default=256)
    p.add_argument("--generations", type=int, default=4)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--member-chunk", type=int, default=32)
    p.add_argument("--gen-chunk", type=int, default=1, help="generations per launch")
    p.add_argument("--target-acc", type=float, default=0.70)
    p.add_argument("--trace-file", default=None,
                   help="keep the span stream of both runs here (default: a temporary file)")
    p.add_argument("--no-trace", action="store_true",
                   help="run untraced; the record's trace is null")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="profile the measured run into DIR (torch.profiler, one Chrome "
                   "trace-event JSON); its rate is then not comparable to an unprofiled run's")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.trace_file and args.no_trace:
        p.error("--trace-file and --no-trace exclude each other")
    record, _ = run(args.population, args.generations, args.steps, args.seed,
                    args.member_chunk, args.gen_chunk, args.target_acc, args.device,
                    traced=not args.no_trace, trace_file=args.trace_file,
                    profile_dir=args.profile_dir)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that the limits of ``correct`` are set from (not part of a run).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--control] [--faults a,b]

For each seed, in one process: the cell's set-up sweeps, judged against
the reference (the program's readings); with ``--control``, the readings
of the reference put in the program's place at float8; with ``--faults``,
the program's readings with each fault of ``FAULTS`` planted underneath.
One JSON line a seed on standard output, with each sampled member's
per-leaf gaps and every member's two accuracies.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@contextlib.contextmanager
def _patched(obj, name, value):
    prior = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, prior)


def fault(name: str):
    """A context that breaks the program underneath a sweep:

    - ``state_unchanged``: a training step leaves the state as it was;
    - ``half_batch``: the loss is the mean over the first half of each
      minibatch, the rest left out;
    - ``scores_misassigned``: each member gets another member's score;
    - ``exploit_misrouted``: the exploit copies each member from the
      next member's source;
    - ``gn_affine_grad_zeroed``: the GroupNorm backward kernel's gradients
      of the scales and shifts come back as zeros;
    - ``exploit_not_staged``: the next generation trains each member's own
      row, not the row the exploit chose (resident: the gather leaves
      the state as it was; waves: the stage-in ignores the exploit's
      permutation)."""
    import numpy as np
    import torch
    from mpi_opt_tpu_torch.ops import group_norm
    from mpi_opt_tpu_torch.train import fused_pbt, population

    trainer = population.PopulationTrainer
    if name == "state_unchanged":
        return _patched(trainer, "_pop_update",
                        lambda self, state, hp, aug, bx, by, active=None:
                        torch.zeros(state.step.shape[0], device=bx.device))
    if name == "half_batch":
        member_loss = population._member_loss

        def half(logits, by):
            h = by.shape[0] // 2
            return member_loss(logits[:, :h], by[:h])

        return _patched(population, "_member_loss", half)
    if name == "scores_misassigned":
        evaluate = trainer.eval_population
        return _patched(trainer, "eval_population",
                        lambda self, *a, **k: evaluate(self, *a, **k).flip(0))
    if name == "exploit_misrouted":
        decide = fused_pbt._wave_exploit

        def misrouted(*a, **k):
            new_unit, src_idx, *rest = decide(*a, **k)
            return (new_unit, src_idx.roll(1), *rest)

        return _patched(fused_pbt, "_wave_exploit", misrouted)
    if name == "gn_affine_grad_zeroed":
        backward = group_norm.gn_bwd

        def zeroed(*a, **k):
            dx, dgamma, dbeta = backward(*a, **k)
            return dx, torch.zeros_like(dgamma), torch.zeros_like(dbeta)

        return _patched(group_norm, "gn_bwd", zeroed)
    if name == "exploit_not_staged":
        run_wave = fused_pbt._run_wave

        def unpermuted(trainer_, pool, rows, offset, *a, **k):
            return run_wave(trainer_, pool, np.arange(offset, offset + len(rows)), offset, *a, **k)

        stack = contextlib.ExitStack()
        stack.enter_context(_patched(trainer, "gather_members", lambda self, state, src_idx: state))
        stack.enter_context(_patched(fused_pbt, "_run_wave", unpermuted))
        return stack
    raise ValueError(f"unknown fault {name!r}")


FAULTS = ("state_unchanged", "half_batch", "scores_misassigned", "exploit_misrouted",
          "gn_affine_grad_zeroed", "exploit_not_staged")


def readings(workload: str, seed: int, control: bool, faults) -> dict:
    import torch

    from benchmark import run as harness
    from benchmark.data import make_images
    from benchmark.judge import judge

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry, cfg, cell = harness.find_cell(bench, workload)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    device = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="calibrate_")
    r = harness.Run(entry["name"], seed, 0, False, cfg, cell, device, tmp)
    path = harness.load_module(os.path.join(HERE, "paths", cell["path"] + ".py"))
    r.data = make_images(cfg, seed, device)
    t0 = time.perf_counter()
    out = {"workload": workload, "seed": seed}
    observed = path.check(r, path.prepare(r))
    out["program"] = judge(r, observed, detail=True)
    if control:
        out["control"] = judge(r, observed, rounding="float8", detail=True)
    del observed
    for name in faults:
        with fault(name):
            out[name] = judge(r, path.check(r, path.prepare(r)), detail=True)
    out["seconds"] = time.perf_counter() - t0
    shutil.rmtree(tmp)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", default="", help=f"comma-separated, of {','.join(FAULTS)}")
    args = p.parse_args(argv)
    faults = [f for f in args.faults.split(",") if f]
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), args.control, faults)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

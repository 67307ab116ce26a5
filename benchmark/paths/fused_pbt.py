"""The fused PBT path: ``mpi_opt_tpu_torch.train.fused_pbt.fused_pbt``,
resident or in waves, with its journal.

Set-up makes a sweep of one generation through the same call at the
cell's population, member chunk, wave size and step chunk for each of
the cell's ``check_steps`` (1, 3 and, where the eval is judged, 20),
and one sweep of two generations of ``two_generation_steps`` steps, in
which the second generation trains the rows the first one's exploit
chose (in waves, staged in from the host through the exploit's
permutation). They build every shape the window runs (training steps,
the eval, the exploit, the journal and, in waves, the pools and
staging), and what they produce is what the reference judges: the
population's state after them (the sampled members' rows and a digest
of every row), the unit matrix after the last exploit, the scores the
journal holds for each generation, and after the eval sweep every
member's parameters. The window is one sweep from the
same seed, with more generations than fit, closed by a drain at the
first generation boundary at or after ``--seconds``: the port's own
drain through its per-boundary slice hook, the one the sweep service
uses to end a tenant's slice.
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import torch

GENERATIONS = 1000  # more than any window holds


def _workload(ctx):
    """The port's workload of the configuration, fed the benchmark's
    arrays at the configuration's batch size."""
    from mpi_opt_tpu_torch.workloads import get_workload

    base = type(get_workload(ctx.cfg["program_workload"]))
    arrays = {k: v.cpu().numpy() for k, v in ctx.data.items()}
    arrays["n_classes"] = ctx.cfg["n_classes"]
    cls = type(f"Bench{base.__name__}", (base,), {
        "batch_size": ctx.cfg["batch_size"],
        "data": lambda self: arrays,
    })
    wl = cls(n_train=ctx.cfg["n_train"], n_val=ctx.cfg["n_val"])
    trainer = wl.make_trainer(device="cpu")
    n = sum(p[0].numel() for p in trainer.template.parameters())
    if n != ctx.cfg["params_per_member"]:
        raise RuntimeError(f"the program's {ctx.cfg['program_workload']} has {n} parameters a "
                           f"member, the configuration {ctx.cfg['params_per_member']}")
    return wl


def _ledger(path: str, ctx, steps: int):
    from mpi_opt_tpu_torch.ledger import SweepLedger

    ledger = SweepLedger(path, read_only=False)
    ledger.ensure_header({"workload": ctx.cfg["program_workload"], "algorithm": "pbt",
                          "fused": True, "population": ctx.population, "seed": ctx.seed,
                          "steps_per_generation": steps})
    return ledger


def _records(path: str) -> list:
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [r for r in rows if "member" in r and "boundary" in r]


def row_digests(state, device) -> np.ndarray:
    """float64 [P]: a fixed random projection of the bits of every row
    of the population's parameters and momentum (equal rows, equal
    digests, non-finite values included)."""
    g = torch.Generator(device=device)
    g.manual_seed(20261018)
    out = None
    for tree in (state.params, state.momentum):
        for k in sorted(tree):
            leaf = tree[k]
            n = leaf.shape[0]
            w = torch.randn((leaf[0].numel(),), generator=g, device=device, dtype=torch.float64)
            part = torch.empty(n, dtype=torch.float64, device=device)
            for a in range(0, n, 16):
                rows = leaf[a:a + 16].to(device).reshape(min(16, n - a), -1)
                rows = rows.float().view(torch.int32).double()
                part[a:a + 16] = rows @ w
            out = part if out is None else out + part
    return out.cpu().numpy()


def _scores(records, n: int, boundary: int) -> np.ndarray:
    """float64 [n]: the journal's score of each member at ``boundary``."""
    scores = np.full(n, np.nan)
    for r in records:
        if int(r["boundary"]) == boundary:
            scores[int(r["member"])] = np.nan if r.get("score") is None else float(r["score"])
    return scores


def _observe(res, records, sample, device, every_row: bool) -> dict:
    state = res["state"]
    n = res["unit"].shape[0]
    last = max(int(r["boundary"]) for r in records)
    scores = _scores(records, n, last)
    rows = {}
    for i in sample:
        rows[int(i)] = ({k: v[i].detach().float().cpu() for k, v in state.params.items()},
                        {k: v[i].detach().float().cpu() for k, v in state.momentum.items()})
    out = {"unit": np.asarray(res["unit"]), "scores": scores, "rows": rows,
           "digest": row_digests(state, device),
           "scores_before": [_scores(records, n, b) for b in range(last)]}
    if every_row:
        out["params"] = {k: v.detach().float().cpu() for k, v in state.params.items()}
    return out


def prepare(ctx):
    """The workload and the keywords every sweep of the cell shares."""
    from mpi_opt_tpu_torch.ops.pbt import PBTConfig

    cell = ctx.cell
    return _workload(ctx), dict(
        population=ctx.population, seed=ctx.seed, cfg=PBTConfig(**ctx.cfg["pbt"]),
        member_chunk=cell["member_chunk"], step_chunk=cell.get("step_chunk", 0),
        wave_size=cell.get("wave_size", 0), device=ctx.device)


def check(ctx, prepared) -> dict:
    """Set-up's sweeps: one generation of k steps for each k in
    ``ctx.check_steps`` (keyed k), and two generations of
    ``ctx.two_generation_steps`` (keyed ``"gen2"``): what each produced,
    for the reference."""
    from mpi_opt_tpu_torch.train.fused_pbt import fused_pbt

    wl, kw = prepared
    eval_k = ctx.check_steps[2] if len(ctx.check_steps) > 2 else None
    sweeps = [(k, 1, k) for k in ctx.check_steps] + [("gen2", 2, ctx.two_generation_steps)]
    observed = {}
    for key, gens, k in sweeps:
        path = os.path.join(ctx.tmp, f"check_{key}.jsonl")
        if os.path.exists(path):  # a sweep before, in the same run's folder
            os.remove(path)
        ledger = _ledger(path, ctx, k)
        try:
            res = fused_pbt(wl, generations=gens, steps_per_gen=k, ledger=ledger, **kw)
        finally:
            ledger.close()
        observed[key] = _observe(res, _records(path), ctx.sample, ctx.device,
                                 every_row=key == eval_k)
        del res
    ctx.sync()
    return observed


def window(ctx, prepared) -> dict:
    """The measured sweep, from the window's opening to the drain at the
    first generation boundary at or after ``ctx.seconds``."""
    from mpi_opt_tpu_torch.health import heartbeat, shutdown
    from mpi_opt_tpu_torch.train.fused_pbt import fused_pbt

    wl, kw = prepared
    cell = ctx.cell
    steps = cell["steps_per_gen"]
    per_gen = 1
    if 0 < cell.get("wave_size", 0) < ctx.population:
        wave = cell["wave_size"] - cell["wave_size"] % cell["member_chunk"]
        per_gen = math.ceil(ctx.population / wave)
    path = os.path.join(ctx.tmp, "window.jsonl")
    ledger = _ledger(path, ctx, steps)
    calls, gen_ends, end = [0], [], {}
    t0 = None

    def slice_hook(stage: str) -> None:
        calls[0] += 1
        if calls[0] % per_gen:
            return
        gen_ends.append(time.perf_counter())
        if gen_ends[-1] - t0 >= ctx.seconds:
            ctx.sync()
            end["t"], end["epoch"] = time.perf_counter(), time.time()
            shutdown.request()

    if ctx.subwindow is not None:
        heartbeat.set_beat_listener(ctx.subwindow.on_beat)
    try:
        with shutdown.ShutdownGuard():
            shutdown.set_slice_hook(slice_hook)
            ctx.window_opens()
            t0 = time.perf_counter()
            if ctx.subwindow is not None:
                ctx.subwindow.arm()
            try:
                fused_pbt(wl, generations=GENERATIONS, steps_per_gen=steps, gen_chunk=1,
                          ledger=ledger, **kw)
                raise RuntimeError(f"the sweep's {GENERATIONS} generations ended inside the window")
            # sweeplint: disable=drain-swallow -- the drain is the window's close, requested by this harness's slice hook; nothing above waits for it
            except shutdown.SweepInterrupted:
                pass
    finally:
        shutdown.clear_slice_hook()
        heartbeat.clear_beat_listener()
        ledger.close()
    records = _records(path)
    gens = len(gen_ends)
    if len(records) != gens * ctx.population:
        raise RuntimeError(f"the journal holds {len(records)} records for {gens} generations "
                           f"of {ctx.population}")
    return {
        "t0": t0, "t1": end["t"], "t1_epoch": end["epoch"],
        "boundaries": [t0] + gen_ends,
        "generations": gens,
        "steps": gens * steps,
        "member_steps": gens * steps * ctx.population,
        "member_evals": gens * ctx.population,
        "attempted": len(records),
        "failed": sum(1 for r in records if r.get("status") != "ok"),
    }

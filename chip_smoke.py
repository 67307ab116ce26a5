#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mpi_opt_tpu_torch) on one NVIDIA GPU.

Phases, in order; any failure exits non-zero and prints no result:

1. device: require CUDA, print the card's name and power limit;
2. build: compile the CUDA kernels from csrc/ (timed; with
   ``--baseline-cu``, the baseline source alongside, in parallel);
3. kernels: at the four ResNet-18 GroupNorm shapes of the main path
   (16 members folded into channels, batch 128), print each kernel's
   launch plan, hold the forward and backward kernels against their
   plain PyTorch versions in bf16 and f32, ReLU on and off, and time
   kernel, plain version and library call against the bytes bound;
   with ``--baseline-cu``, time the baseline kernels beside them in
   turns (baseline, kernel, kernel, baseline). Then a full-width
   two-member ResNet-18 on the card (kernels) against the same model on
   the CPU (plain);
4. slice: fused PBT over cifar100_resnet18 at full width, population 16,
   2 generations x 25 steps, with the launch counts zeroed just before
   and read just after: both kernels must have run, the plain versions
   never;
5. profile: ``torch.profiler`` over 3 steady population steps of the
   slice's population: top device kernels, GroupNorm's share, copy
   kernels, device idle share (measurement only);
6. the ``kernels`` line (JSON), then the device line (JSON, last).

Run from the repo root: ``python3 chip_smoke.py``. Details also go to
chiprun_out/chip_smoke.json.

``--baseline-cu PATH`` names the two-pass GroupNorm source of commit
788c451, written out with ``git show 788c451:mpi_opt_tpu_torch/csrc/
group_norm.cu``; it is built and timed, never used by the port. Any
other file is refused: ctypes cannot check a C interface.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
P, BATCH = 16, 128
# ResNet-18 GN sites per member: (spatial S, channels C); 32 groups each.
# Sites a population step runs at each shape: (with ReLU, without):
# stage 0 = stem + gn1 x2 with ReLU, gn2 x2 without; later stages =
# gn1 x2 with ReLU, gn2 x2 + gn_proj without
SHAPES = [(1024, 64, 3, 2), (256, 128, 2, 3), (64, 256, 2, 3), (16, 512, 2, 3)]
GROUPS = 32
# data-sheet memory bandwidth by card name, bytes/s
BANDWIDTH = [("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H100", 3.35e12), ("H200", 4.8e12)]
TOL = {  # (atol, rtol) per output, kernel against plain on the same inputs
    # bf16 outputs: the two sides round f32 values that differ in the
    # last f32 bits to bf16, whose steps are at most 2^-7 of the value;
    # two steps allowed
    ("bf16", "y"): (1e-5, 2**-6), ("bf16", "dx"): (1e-4, 2**-6),
    ("f32", "y"): (1e-4, 0.0), ("f32", "dx"): (1e-3, 0.0),
    # f32 statistics and partial sums: summation order differs
    "mean": (1e-5, 1e-4), "rstd": (1e-5, 1e-4), "dgamma": (1e-3, 1e-4), "dbeta": (1e-3, 1e-4),
}


# per-kernel numbers of the ``kernels`` line
LINE_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms", "bound_share")


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def time_ms(fn, flush, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` with L2 flushed before each launch. A
    spin kernel (~100 us) ahead of the start event keeps the device busy
    while the host enqueues ``fn``, so the host's launch overhead does not
    show as device time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(200_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in times) / iters


def check(name, got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements out of tolerance (atol {atol}, rtol {rtol}), "
            f"max abs err {float(err.max())}"
        )
    return float(err.max())


def in_turns(new, old, flush):
    """(kernel ms, baseline ms or None): timed baseline, kernel, kernel,
    baseline on the same card, each a mean over its launches."""
    if old is None:
        return (time_ms(new, flush) + time_ms(new, flush)) / 2, None
    o1, n1, n2, o2 = (time_ms(f, flush) for f in (old, new, new, old))
    return (n1 + n2) / 2, (o1 + o2) / 2


class Baseline:
    """Launchers for the two-pass GroupNorm of commit 788c451:
    ``gn_fwd``/``gn_bwd`` taking (channels a block, row lanes), 64
    channels and 4 lanes at every main-path shape."""

    # sha256 of that commit's csrc/group_norm.cu, the one source whose C
    # interface SIGNATURES describes
    SHA256 = "573330548c481fac915710b09060eb7a29751eb3c20964f46aee5a93d7f99c67"

    SIGNATURES = {
        "gn_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        "gn_bwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    }

    def __init__(self, lib):
        self.lib = lib

    def _call(self, fn, *args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline kernel launch failed with CUDA error {err}")

    def fwd(self, x, gamma, beta, g, eps, relu):
        n, s, c = x.shape
        y = torch.empty_like(x)
        mean = torch.empty((n, g), dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
        self._call(self.lib.gn_fwd, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
                   mean.data_ptr(), rstd.data_ptr(), n, s, c, g, 64, 4, eps, int(relu),
                   int(x.dtype == torch.bfloat16))
        return y, mean, rstd

    def bwd(self, x, dy, gamma, beta, mean, rstd, g, relu):
        n, s, c = x.shape
        dx = torch.empty_like(x)
        dgamma = torch.empty((n, c), dtype=torch.float32, device=x.device)
        dbeta = torch.empty_like(dgamma)
        self._call(self.lib.gn_bwd, x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                   mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
                   dbeta.data_ptr(), n, s, c, g, 64, 4, int(relu), int(x.dtype == torch.bfloat16))
        return dx, dgamma, dbeta


def kernel_phase(gn, bandwidth, base):
    """Kernel vs plain at the main path's shapes; returns per-kernel totals."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")
    keys += ("baseline_ms",) if base else ()
    tot = {k: dict.fromkeys(keys, 0.0) for k in ("gn_fwd", "gn_bwd")}
    rows = []
    for s, c_member, n_relu, n_plain in SHAPES:
        c, g = P * c_member, P * GROUPS
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            plans = {k: gn.gn_plan(BATCH, s, c, g, dtype, k == "bwd") for k in ("fwd", "bwd")}
            print(f"plan S={s} C={c} G={g} {tag}: " + "; ".join(
                f"{k} {p.cb} channels x {p.rb} rows a block, cluster {p.cluster}, "
                f"{p.threads} threads, {p.smem} B shared" for k, p in plans.items()))
            x = torch.randn((BATCH, s, c), generator=gen, device="cuda").to(dtype)
            dy = torch.randn((BATCH, s, c), generator=gen, device="cuda").to(dtype)
            gamma = 1.0 + 0.5 * torch.randn(c, generator=gen, device="cuda")
            beta = 0.1 * torch.randn(c, generator=gen, device="cuda")
            elt = x.element_size()
            for relu in (True, False):
                y, mean, rstd = gn.gn_fwd(x, gamma, beta, g, 1e-6, relu)
                yp, meanp, rstdp = gn.group_norm_relu_plain(x, gamma, beta, g, 1e-6, relu)
                # backward: both sides from the kernel's statistics, so the
                # ReLU masks are decided on bit-identical z
                dx, dgm, dbt = gn.gn_bwd(x, dy, gamma, beta, mean, rstd, g, relu)
                dxp, dgmp, dbtp = gn.group_norm_relu_bwd_plain(x, dy, gamma, beta, mean, rstd, g, relu)
                torch.cuda.synchronize()
                errs_f = [
                    check(f"y {tag} S={s} C={c} relu={relu}", y, yp, *TOL[(tag, "y")]),
                    check("mean", mean, meanp, *TOL["mean"]),
                    check("rstd", rstd, rstdp, *TOL["rstd"]),
                ]
                errs_b = [
                    check(f"dx {tag} S={s} C={c} relu={relu}", dx, dxp, *TOL[(tag, "dx")]),
                    check("dgamma", dgm, dgmp, *TOL["dgamma"]),
                    check("dbeta", dbt, dbtp, *TOL["dbeta"]),
                ]
                tot["gn_fwd"]["max_abs_err"] = max(tot["gn_fwd"]["max_abs_err"], *errs_f)
                tot["gn_bwd"]["max_abs_err"] = max(tot["gn_bwd"]["max_abs_err"], *errs_b)
                if tag != "bf16":
                    continue  # the main path runs bf16: time that
                if base:  # the baseline computes the same function
                    check(f"baseline y S={s} C={c} relu={relu}",
                          base.fwd(x, gamma, beta, g, 1e-6, relu)[0], yp, *TOL[(tag, "y")])
                    check(f"baseline dx S={s} C={c} relu={relu}",
                          base.bwd(x, dy, gamma, beta, mean, rstd, g, relu)[0], dxp, *TOL[(tag, "dx")])
                # library yardstick: PyTorch's own GroupNorm on an NCHW copy
                hw = int(math.isqrt(s))
                xn = x.view(BATCH, hw, hw, c).permute(0, 3, 1, 2).contiguous()
                dyn = dy.view(BATCH, hw, hw, c).permute(0, 3, 1, 2).contiguous()
                gb, bb = gamma.to(dtype), beta.to(dtype)
                _, lmean, lrstd = torch.ops.aten.native_group_norm(xn, gb, bb, BATCH, c, s, g, 1e-6)

                def lib_fwd():
                    out = F.group_norm(xn, g, gb, bb, 1e-6)
                    return F.relu(out) if relu else out

                times = {}
                times["fwd"], times["fwd_baseline"] = in_turns(
                    lambda: gn.gn_fwd(x, gamma, beta, g, 1e-6, relu),
                    base and (lambda: base.fwd(x, gamma, beta, g, 1e-6, relu)), flush)
                times["fwd_plain"] = time_ms(lambda: gn.group_norm_relu_plain(x, gamma, beta, g, 1e-6, relu), flush)
                times["fwd_lib"] = time_ms(lib_fwd, flush)
                times["bwd"], times["bwd_baseline"] = in_turns(
                    lambda: gn.gn_bwd(x, dy, gamma, beta, mean, rstd, g, relu),
                    base and (lambda: base.bwd(x, dy, gamma, beta, mean, rstd, g, relu)), flush)
                times["bwd_plain"] = time_ms(lambda: gn.group_norm_relu_bwd_plain(x, dy, gamma, beta, mean, rstd, g, relu), flush)
                times["bwd_lib"] = time_ms(lambda: torch.ops.aten.native_group_norm_backward(
                    dyn, xn, lmean, lrstd, gb, BATCH, c, s, g, [True, True, True]), flush)
                act = BATCH * s * c * elt
                small = 2 * c * 4 + 2 * BATCH * g * 4
                bound = {
                    "fwd": (2 * act + small) / bandwidth * 1e3,
                    "bwd": (3 * act + small + 2 * BATCH * c * 4) / bandwidth * 1e3,
                }
                sites = n_relu if relu else n_plain
                for k, kk in (("gn_fwd", "fwd"), ("gn_bwd", "bwd")):
                    tot[k]["ms"] += sites * times[kk]
                    tot[k]["plain_ms"] += sites * times[kk + "_plain"]
                    tot[k]["library_ms"] += sites * times[kk + "_lib"]
                    tot[k]["bound_ms"] += sites * bound[kk]
                    if base:
                        tot[k]["baseline_ms"] += sites * times[kk + "_baseline"]
                row = {"S": s, "C": c, "groups": g, "relu": relu, "sites_per_step": sites,
                       **{k + "_ms": v for k, v in times.items() if v is not None},
                       "fwd_bound_ms": bound["fwd"], "bwd_bound_ms": bound["bwd"],
                       "fwd_bound_share": bound["fwd"] / times["fwd"],
                       "bwd_bound_share": bound["bwd"] / times["bwd"],
                       "fwd_plan": dataclasses.asdict(plans["fwd"]),
                       "bwd_plan": dataclasses.asdict(plans["bwd"])}
                rows.append(row)
                print("kernel-shape " + json.dumps(row))
            del x, dy
    for k in tot:
        tot[k]["bound_share"] = tot[k]["bound_ms"] / tot[k]["ms"]
    return tot, rows


def model_check(ResNet18):
    """Full-width two-member ResNet-18: logits and gradients on the card
    (kernels, cuDNN in f32 without TF32) against the CPU (plain)."""
    gen = torch.Generator()
    gen.manual_seed(1)
    model = ResNet18(n_classes=100, dtype=torch.float32, population=2)
    model.init_params(gen)
    x = torch.randn((4, 32, 32, 6), generator=gen).permute(0, 3, 1, 2)  # channels_last
    y = torch.randint(0, 100, (4,), generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        m = model.to(dev)
        m.zero_grad()
        logits = m(x.to(dev))
        loss = torch.nn.functional.cross_entropy(logits.reshape(8, 100), y.to(dev).repeat(2))
        loss.backward()
        out[dev] = (logits.detach().cpu(), {k: p.grad.detach().cpu() for k, p in m.named_parameters()})
    err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    scale = float(out["cpu"][0].abs().max())
    if not err <= 1e-3 * max(1.0, scale):
        raise AssertionError(f"model logits: max abs err {err} over scale {scale}")
    # gradients as one vector, relative L2: a ReLU mask decided on a z
    # within rounding of 0 flips between any two f32 computations, and at
    # batch 4 one flip moves a single tensor's gradient by percents; the
    # norm over all 11M entries per member stays near f32 precision
    sq = lambda d: sum(float((t.double() ** 2).sum()) for t in d.values())
    diff = {k: out["cuda"][1][k] - g for k, g in out["cpu"][1].items()}
    grad_err = (sq(diff) / sq(out["cpu"][1])) ** 0.5
    if not grad_err <= 1e-2:
        raise AssertionError(f"model gradients: relative L2 err {grad_err}")
    return {"logits_max_abs_err": err, "logits_scale": scale, "grad_rel_l2_err": grad_err}


def profile_phase(wl, res, steps: int = 3):
    """``torch.profiler`` over ``steps`` steady population steps of the
    slice's own population and hyperparameters (one warm-up step first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mpi_opt_tpu_torch.train.common import hparams_fn

    d = wl.data()
    train_x = torch.from_numpy(d["train_x"]).cuda()
    train_y = torch.from_numpy(d["train_y"]).cuda().long()
    trainer = wl.make_trainer(device="cuda")
    hp = hparams_fn(wl.default_space(), wl)(torch.from_numpy(res["unit"]).cuda())
    state = res["state"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    trainer.train_segment(state, hp, train_x, train_y, gen, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_segment(state, hp, train_x, train_y, gen, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {"steps": steps, "wall_ms": wall * 1e3, "step_ms": wall * 1e3 / steps}
    if not dev:
        # no device activity traced: time the same steps with CUDA events
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.train_segment(state, hp, train_x, train_y, gen, steps)
        end.record()
        torch.cuda.synchronize()
        print("profile: the profiler showed no device time; timed with CUDA events instead")
        out.update(profiler_device_time=False, event_step_ms=start.elapsed_time(end) / steps)
        return out
    dur = lambda e: e.time_range.end - e.time_range.start  # us
    by_name, by_stream = {}, {}
    for e in dev:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + dur(e), n + 1)
        by_stream[e.device_resource_id] = by_stream.get(e.device_resource_id, 0.0) + dur(e)
    total_us = sum(t for t, _ in by_name.values())
    # busy = union of the device intervals (streams overlap), over the host's window
    busy, hi = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if b > hi:
            busy += b - max(a, hi)
            hi = b
    per_step = lambda us: us / 1e3 / steps
    rows = [{"name": n[:160], "ms_per_step": per_step(t), "calls_per_step": c / steps}
            for n, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])]
    gn_us = sum(t for n, (t, _) in by_name.items() if "gn_fwd_kernel" in n or "gn_bwd_kernel" in n)
    out.update(
        profiler_device_time=True,
        device_ms_per_step=per_step(total_us),
        device_busy_ms_per_step=per_step(busy),
        idle_share=1.0 - busy / 1e6 / wall,
        streams=len(by_stream),
        ms_per_step_by_stream={str(k): per_step(v) for k, v in sorted(by_stream.items())},
        gn_ms_per_step=per_step(gn_us),
        gn_share_of_device_time=gn_us / total_us,
        gn_share_of_busy_time=gn_us / busy,
        top=rows[:15],
        copies=[r for r in rows if "copy" in r["name"].lower()],
    )
    for k in ("step_ms", "device_ms_per_step", "device_busy_ms_per_step", "idle_share", "streams",
              "ms_per_step_by_stream", "gn_ms_per_step", "gn_share_of_device_time",
              "gn_share_of_busy_time"):
        print(f"profile {k}: {out[k]}")
    for kind in ("top", "copies"):
        for r in out[kind]:
            print(f"profile {kind}: {r['ms_per_step']:.4f} ms/step, "
                  f"{r['calls_per_step']:.1f} calls/step, {r['name']}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline-cu", default=None,
                    help="the two-pass GroupNorm source of commit 788c451, "
                    "timed beside the kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        return fail("CUDA is not available")
    sys.path.insert(0, ROOT)
    from mpi_opt_tpu_torch import fused_pbt, get_workload
    from mpi_opt_tpu_torch.models import ResNet18
    from mpi_opt_tpu_torch.ops import _build
    from mpi_opt_tpu_torch.ops import group_norm as gn

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    bandwidth = next((bw for key, bw in BANDWIDTH if key in name), None)
    if bandwidth is None:
        return fail(f"no data-sheet bandwidth for {name!r}")
    print(f"device: {name}, {torch.cuda.device_count()} visible, bound at {bandwidth / 1e12} TB/s")

    # 2. build: one nvcc a source, all started together
    t0 = time.perf_counter()
    sources = {"group_norm": None}
    if args.baseline_cu:
        sources["group_norm_baseline"] = os.path.abspath(args.baseline_cu)
        with open(sources["group_norm_baseline"], "rb") as f:
            if hashlib.sha256(f.read()).hexdigest() != Baseline.SHA256:
                return fail(f"{args.baseline_cu} is not the GroupNorm source of commit 788c451")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        for f in [pool.submit(_build.build, k, v) for k, v in sources.items()]:
            f.result()
    _build.load("group_norm", gn._SIGNATURES)
    base = None
    if args.baseline_cu:
        lib = _build.load("group_norm_baseline", Baseline.SIGNATURES, sources["group_norm_baseline"])
        base = Baseline(lib)
    print(f"build: {time.perf_counter() - t0:.2f} s")
    print(_build.BUILD_INFO["group_norm"][1].strip())

    # 3. kernels against their plain versions, then the model on card vs
    # CPU; f32 comparisons without TF32, restored for the slice after
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    tot, rows = kernel_phase(gn, bandwidth, base)
    model = model_check(ResNet18)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    print("model-check " + json.dumps(model))
    print("kernel-totals " + json.dumps(tot))

    # 4. the slice, through the entry points a user calls
    wl = get_workload("cifar100_resnet18")
    wl.data()  # host data generation is set-up, outside the timed sweep
    gens, steps = 2, 25
    torch.cuda.reset_peak_memory_stats()
    gn.reset_launches()
    t0 = time.perf_counter()
    res = fused_pbt(wl, population=P, generations=gens, steps_per_gen=steps, seed=0, gen_chunk=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gn.LAUNCHES)
    if not (launches["gn_fwd"] > 0 and launches["gn_bwd"] > 0):
        return fail(f"the slice did not launch both kernels: {launches}")
    if launches["plain"] != 0:
        return fail(f"the slice called the plain GroupNorm: {launches}")
    curves = (res["best_curve"], res["mean_curve"])
    if not (math.isfinite(res["best_score"]) and all(c.shape == (gens,) for c in curves)):
        return fail(f"bad sweep result: best {res['best_score']}, curves {curves}")
    if not all(bool((c >= 0).all() and (c <= 1).all()) for c in curves):
        return fail(f"accuracies outside [0, 1]: {curves}")
    slice_out = {
        "population": P, "generations": gens, "steps_per_gen": steps,
        "wall_s": wall, "launch_walls_s": res["launch_walls"],
        "member_steps_per_s": P * gens * steps / wall,
        "member_steps_per_s_last_launch": P * steps / res["launch_walls"][-1],
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "best_score": res["best_score"], "best_curve": res["best_curve"].tolist(),
        "mean_curve": res["mean_curve"].tolist(), "launches": launches,
    }
    print("slice " + json.dumps(slice_out))

    # 5. where a steady step's device time goes (measurement only)
    prof = profile_phase(wl, res)

    # 6. the kernels line, then the device line
    src = "mpi_opt_tpu_torch/csrc/group_norm.cu"
    kernels = [
        {"name": "gn_fwd", "route": "cuda", "source": src,
         "replaces": "mpi_opt_tpu/ops/pallas_gn.py:167", "launches": launches["gn_fwd"],
         **{key: tot["gn_fwd"][key] for key in LINE_KEYS}, "bound_by": "bytes"},
        {"name": "gn_bwd", "route": "cuda", "source": src,
         "replaces": "mpi_opt_tpu/ops/pallas_gn.py:207", "launches": launches["gn_bwd"],
         **{key: tot["gn_bwd"][key] for key in LINE_KEYS}, "bound_by": "bytes"},
    ]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    out = os.path.join(ROOT, "chiprun_out", "chip_smoke.json")
    with open(out + ".tmp", "w") as f:
        json.dump({"card": smi, "kernels": kernels, "totals": tot, "shapes": rows,
                   "model_check": model, "slice": slice_out, "profile": prof}, f, indent=1)
    os.replace(out + ".tmp", out)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mpi_opt_tpu_torch) on one NVIDIA GPU.

Phases, in order; any failure exits non-zero and prints no result:

1. device: require CUDA, print the card's name and power limit;
2. build: compile the CUDA kernels from csrc/ (timed; with
   ``--baseline-cu``, the baseline source alongside, in parallel);
3. kernels: at every GroupNorm shape of the paths below (``SPECS``:
   ResNet-18's four, 16 members folded into channels, batch 128, bf16
   and f32, ReLU on and off; the SmallCNN's two at a member chunk of 32,
   batch 256, bf16 and f32, and at an eval chunk of 1024 images, bf16),
   print each kernel's launch plan, hold the forward and backward
   kernels against their plain PyTorch versions, and time kernel, plain
   version and library call against the bytes bound; with
   ``--baseline-cu``, time the baseline kernels beside them at the
   ResNet shapes in turns (baseline, kernel, kernel, baseline). Then the
   variance clamp on near-constant groups at a large mean; a full-width
   two-member ResNet-18 and SmallCNN on the card (kernels) against the
   same models on the CPU (plain), with the SmallCNN's max-pool ties
   routed to the same element on both;
4. slice: fused PBT over cifar100_resnet18 at full width, population 16,
   2 generations x 25 steps;
5. profile: ``torch.profiler`` over 3 steady population steps of the
   slice's population: top device kernels, GroupNorm's share, copy
   kernels, device idle share (measurement only);
6. north star: ``mpi_opt_tpu_torch.bench`` (fused PBT over 256
   full-width SmallCNN members on CIFAR-10, member chunk 32, one
   generation a launch) at 2 generations x 20 steps, traced (the bench's
   default); its record. Then the same run with
   ``torch.backends.cudnn.deterministic`` on, for the
   member-generations/s with and without it (measurement only: phase 9
   checks determinism with the defaults);
7. profile of 3 steady north-star steps, as phase 5;
8. a fashion_mlp sweep, population 16, 2 generations x 5 steps;
9. durability: full-width cifar10_cnn at population 32, 4 generations x
   20 steps, one generation a launch, with snapshots and a ledger. Two
   unkilled runs in this process must end in the same state digest and
   journal the same records; then the CLI (``python -m
   mpi_opt_tpu_torch``) in subprocesses: SIGTERM once generation 1 is
   journaled must exit 75 with the preempted line, SIGKILL in launch 3,
   and a ``--step-chunk 7`` run (snapshots every 2 launches) SIGKILLed
   once generation 2 is journaled (the three drills at once); each
   ``--resume`` must exit 0 with the unkilled run's ledger records,
   best score and curve. A resume against a tampered ledger must exit
   65, and a population whose
   parameters do not fit the card (65536 members) 74. Last, two
   256-member runs (1 x 5 steps) must agree, and one snapshot of their
   state is timed: save, restore and verify, bytes on disk;
10. the wave engine:
   (a) the north star (256 full-width SmallCNN members, member chunk
   32) at 2 x 20 through ``fused_pbt``: traced resident (a fresh
   workload), resident, traced resident, waves of 64, waves of 64,
   traced resident, resident, waves of 48, traced waves of 64, each with
   its member-generations/s, staging counters and peak memory. Every run
   must end in the first run's state digest and best curve (waves of 48
   run whole chunks: every launch has one member chunk's shape); the
   traced runs' span coverage must be >= 0.9, and tracing may cost at
   most 5% (resident, traced, traced, resident in turns); where the
   wave-64 run's extra wall goes, by span; the time to allocate two
   pinned pools;
   (b) a real OOM without a member chunk: the CLI on cifar100_cnn at 64
   members in waves of 32 with ``--oom-backoff 2`` (every launch 32 >> 2
   = 8 members) and of 16 with ``--oom-backoff 1`` (launches of 8 too),
   each in a subprocess whose launcher reports the allocator's peaks, and
   waves of 32 with ``--oom-backoff 0`` (launches of 32, whole waves:
   what the narrower launches cost); then, capped by
   ``torch.cuda.set_per_process_memory_fraction`` three quarters of the
   way from the half-cap run's allocated peak to the cap-32 run's (only
   the launcher knows the cap), ``--wave-size 32 --oom-backoff 2`` must
   exit 0 with one backoff, no launch-shape change and the UNFAULTED
   waves-of-32 run's ledger records, and ``--oom-backoff 0`` exit 74;
   (b2) the same inside one launch width: cifar100_resnet18 at 64
   members in chunks of 16, waves of 32 and of 16, capped between their
   allocated peaks: ``--wave-size 32`` must back off once to 16 with no
   launch-shape change and end with the UNFAULTED waves-of-32 run's
   records. (b) and (b2) run at once, so their clean runs' rates are
   read with five CLI processes on the card;
   (c) a drain between waves: phase 9's durability config through the
   CLI in waves of 8 (member chunk 8): resident and wave runs must
   journal the same records; SIGTERM once wave 2 of generation 1 is
   dispatched must exit 75, and ``--resume`` exit 0, train only the
   waves not yet completed (``waves_run``) and end with those records;
   (d) fused SHA on fashion_mlp, 64 trials, budgets 10 -> 270, eta 3
   (BENCH_ALL.json config 2), resident and in waves of 16 (config 9,
   launches of 16 >> 2 = 4 members), and in waves of 16 with
   ``oom_backoff=0`` (launches of 16): rung sizes [64, 22, 8, 3] and
   budgets [10, 30, 90, 270], trials/s and staging counters; whether
   survivors and best agree is reported;
   (e) config 5's wave cap (cifar100_resnet18, 1024 members): per-member
   bytes, the measured budget, ``estimate_wave_size``, no training;
11. fused Hyperband: (a) fashion_mlp through the CLI at its defaults
   (R=270, eta 3: six brackets, 415 trials) with a ledger: a finite best,
   one ledger whose boundaries run contiguously across the brackets and
   validate, trials/s; (b) full-width cifar10_cnn at R=27 in member
   chunks of 8, resident and then in waves of 8: the same records and
   best, both GN kernels in every bracket and the plain versions never;
12. fused TPE: (a) BASELINE.json config 4 at full size, nothing cut:
   ``fused_tpe`` over ``tabular_mlp`` on breast_cancer, 256 trials in
   batches of 64, 30 steps each, a call on a fresh workload (set-up
   included) then a timed call; trials/s both ways, the best score, the
   ``suggest`` spans of a traced call, and the acquisition's own time
   at C=1024, M=256, d=3 by CUDA events; (b) full-width cifar10_cnn, 64
   trials in batches of 32, 20 steps, member chunk 8, resident and then
   in waves of 16: the same records and best, both GN kernels in every
   generation and the plain versions never; (c) the CLI on tabular_mlp
   at config 4's shape with a ledger and snapshots, SIGKILLed once batch
   2 is journaled: ``--resume`` exits 0 with the unkilled run's records
   and best;
13. fused BOHB: (a) fashion_mlp through the CLI at its defaults (R=270,
   eta 3) with a ledger: a finite best, boundaries that run contiguously
   across the brackets and validate, the model drawing in a later
   bracket, trials/s; (b) full-width cifar10_cnn at R=27, member chunk
   8, resident and then in waves of 8: the same records and best, both
   GN kernels in every bracket and the plain versions never;
14. multi-objective sweeps (``--phases mo``, the 15th of ``PHASES``):
   (a) BENCH_ALL.json config 8 at full size, nothing cut: ``fused_pbt``
   over ``digits_mlp``, 8 members x 3 x 40, ``accuracy:max,params:min``,
   a call on a fresh workload then a timed call (member-generations/s,
   the front, its hypervolume, the winner's vector), then three
   journaled calls, one at ``gen_chunk=3``: one state digest, the same
   records; (b) the CLI on digits_mlp with ``--objectives``, a ledger and
   snapshots, SIGKILLed once generation 1 is journaled: ``--resume``
   exits 0 with the unkilled run's records (vectors included) and front;
   a resume under other objectives exits 2; ``params:min<=1`` ends in
   ``least_violation`` with an ``objective_degraded`` event;
   ``--wave-size``/``--step-chunk`` with ``--objectives`` exit 2; (c)
   the north star's width and population (cifar10_cnn, 256 members,
   chunk 32, 2 x 5) scalar and multi-objective in turns: both GN
   kernels in every generation at the scalar run's counts and the plain
   versions never, the rates side by side, then ``pareto_score`` (m=2,
   3), ``member_effective_params``, the MO exploit and the MO eval at
   n=256 by CUDA events; (d) fused SHA on fashion_mlp at config 2's
   shape under ``accuracy:max,latency:min`` against the scalar sweep in
   turns: rungs [64, 22, 8, 3], every ok record a 2-vector, trials/s;
15. the driver path (``--phases driver``, the 16th of ``PHASES``):
   ``run_search`` over the ``gpu`` slot-pool backend at full width. (a)
   config 2's driver half, ASHA on fashion_mlp (64 trials, 10 -> 270,
   eta 3, a pool of 64): a warm-up search, ``reset``, the timed search,
   both with the same records bit for bit; (b) config 3's driver half, PBT on cifar10_cnn, 32 members x 8
   generations x 100 steps; (c) config 4's driver half, TPE on
   tabular_mlp (256 trials, budget 30, a pool of 64) after a warm-up of
   192 trials at seed 1; (d) PBT on cifar100_resnet18, 16 members x 2 x
   10: both GN kernels launched, the plain versions never, and both held
   against their plain versions at every shape the run launched them at
   (recorded while it ran); (e) the CLI without ``--fused`` (ASHA on
   fashion_mlp at config 2's budgets, a pool of 16) with a ledger and
   snapshots, SIGTERMed once its first batch is journaled: exit 75, then
   ``--resume`` exit 0 with the unkilled run's ledger records. Trials/s
   (or member-generations/s) and the best of each;
16. a sweep's ledger read back (``--phases warm``, the 17th of
   ``PHASES``), through the CLI in this process: (a) fused TPE at config
   4's shape, cold with a ledger, then warm-started from it: n_warm,
   trials/s both ways, the warm ledger and history exactly its own 256
   trials; (b) the driver path's TPE warm-started from (a)'s fused
   ledger (its ``warm_start`` event counts that ledger's ok records),
   then resumed from its snapshot: ``warm_start_skipped``; (c) fused PBT
   over full-width cifar10_cnn, 32 members in one chunk, 3 x 20,
   warm-started from a 2-generation cold run: member 0 starts at the
   prior best, both GN kernels at every shape they ran at held against
   their plain versions; (d) phase 9's durability config SIGKILLed (a
   subprocess) once snapshot 2 is committed: ``fsck`` exits 0 with the
   ledger cross-checked, a flipped byte in the newest step's
   ``sweep.pt`` exits 1 naming it, ``--repair`` quarantines it and
   ``--resume`` ends in the unkilled run's records; ``fsck --deep``
   passes a clean directory; ``report --json`` and ``--validate`` pass
   every ledger of the phase;
17. the CPU path (``--phases cpu``, the 18th of ``PHASES``): (a)
   BASELINE.json config 1 at full size (random search over ``digits``,
   16 trials at budget 100, one worker, a warm trial first): trials/s
   and the best; (b) the CLI's chaos drill (``--backend cpu --workload
   digits``, 32 trials, 4 workers, ``--trial-timeout 2``, exc/nan/hang/
   crash): each trial's status what ``fault_for`` predicts, the counts,
   the clean sweep's best over the unfaulted trials; (c) the preempt
   drill on ``quadratic`` in-parent: exit 75, ``--resume`` until exit 0,
   the chaos-free run's records; a hang reaped on the isolated stateful
   path and counted as a stall; (d) ``PopulationWorkload.evaluate`` of
   one full-width cifar10_cnn and cifar100_resnet18 member on the card
   (both GN kernels at population 1) against the same call on the CPU
   given the card's draws (the update, trained minus initial weights,
   within PT_UPDATE_RTOL by relative norm; the card's run with its
   learning rate halved must fall outside), then ``--backend cpu
   --workload fashion_mlp`` through a pool of 2. Every pool worker
   reports at its start that it sees no CUDA device;
18. the measuring tools (``--phases windows``, the 19th of ``PHASES``),
   through the CLI in this process: (a) the full-width ResNet-18 slice
   (population 16, 3 x 5, one generation a launch) with ``--trace
   --profile-dir --profile-launches 2:2``: exactly one trace lands, with
   one ``train`` range, device kernels, and as many ``gn_fwd_kernel``
   and ``gn_bwd_kernel`` events as the GN wrappers counted over launch 2
   (read at the launch ticks), the plain versions never; (b) configs 2
   and 4's driver halves (ASHA on fashion_mlp, TPE on tabular_mlp, phase
   15's shapes) with ``--profile-launches 2:4``: a train range a batch of
   the window, and the device's busy share (the union of the kernel
   intervals over the window's wall); (c) ``trace --timeline`` of (a)'s
   stream passes ``validate_timeline``; (d) a second, unprofiled traced
   run of (a): ``trace --diff`` of the two exits 0 under a loose gate
   (the set-up not gated) and 1 under ``min_mxu_frac: 0.99``, a planted regression whose
   violation must be the utilization floor. The profiled launch's wall
   beside the unprofiled ones;
19. multi-process (``--phases mesh``, the 20th of ``PHASES``): the
   ResNet-18 slice (cifar100_resnet18 at full width, population 16, 3 x
   5, one generation a launch) through ``python -m
   mpi_opt_tpu_torch.launch --n-proc 2``, both ranks on the card over
   gloo, each counting its GN launches and shapes (a wrapper around the
   rank's CLI writes them to the log dir): (a) ``--n-pop 2`` with a
   ledger and a final snapshot: both GN kernels on each rank, the plain
   versions never, and the ledger and the snapshot's state digest
   bit-equal to a one-process run at ``--member-chunk 8``; (b) ``--n-pop
   1 --n-data 2``, 2 generations: each one's best and mean score within
   0.02 of that run's; (c) (a) with snapshots every 2 launches and
   ``--rank-kill rank=1,at=2 --retries 1``: the supervisor relaunches
   after the SIGKILL, exits 0, and the ledger and digest equal (a)'s.
   The three supervisors run at once (with room for their six ranks on
   the card; else (b) after the others), the one-process run after them.
   Every GN shape a rank launched is held against the plain versions,
   and a rank's GN time a population step is timed at its shard shape;
20. the sweep service (``--phases service``, the 21st of ``PHASES``):
   (a) three tenants in one ``SweepService(...).serve()`` in this
   process, one boundary a slice, drained on empty: T1 is BASELINE.json
   config 3 (fused PBT, full-width cifar10_cnn, 32 members x 4 x 20, one
   generation a launch), T2 the same at seed 1 (one program key), T3 the
   full-width ResNet-18 at 16 members in chunks of 8, 2 x 10. All end
   done in >= 9 slices with their solo CLI runs' ledger records and
   final state digests, and ``report --validate`` passes; T2 is a
   program-cache hit from its first slice, T1 a miss; both GN kernels
   launch in the server and the plain versions never, and both are held
   against their plain versions at every shape the tenants launched. Each
   tenant's wall and slices, the set-up from its first slice's start to
   its first GN launch (and from its admission), the server's peak
   memory over what the script held before it, what the card holds at
   every slice's end (the program cache's data and the cuBLAS
   workspace, within 1 MiB) and, once the server is dropped, nothing. (b) T1 through
   ``submit`` to a resident server subprocess: ``status`` shows its live
   phase; SIGTERM once its heartbeat shows generation 1: the server exits
   0 with T1 parked; a queued job ``cancel``led ends cancelled; ``drain
   --wait`` of a restarted server mid-slice exits 0 and loses no job; a
   third server finishes T1 to the solo run's records and digest. (c)
   Two servers on one spool (ids a and b) with two fused SHA tenants at
   config 2's shape on fashion_mlp: a SIGKILLs itself at its first
   boundary once b is registered; b takes over a's lease and finishes
   both to their solo runs' records. (d) ``corpus index`` over a
   directory holding config 4's cold fused TPE ledger (phase 16 (a)'s
   run), then the same sweep with ``--warm-start auto:DIR``: the corpus
   merges the prior's records by (params, budget), so its observations
   and records equal a ``--warm-start PATH`` run's on the merged copy of
   the ledger (and on the ledger itself when no point repeats), and
   ``corpus resolve --json`` names the ledger. (a)'s server runs alone
   on the card; (b) and (c) then run while (a)'s solo references and (d)
   run in this process;
21. the suggestion service (``--phases suggest``, the 22nd of
   ``PHASES``): (a) BENCH_ALL.json config 6 at full size: a
   ``--suggest-serve`` server subprocess on tabular_mlp (the card, a
   ledger, ``--suggest-idle-timeout 120``) driven over its filesystem
   spool by ``corpus/client.py::bench``, 8 rounds of a 32-point
   suggestion with its 32 reports: suggestions/s, round-trip p50 and
   p95, and the ledger's 256 reports, each journaled once; (b) config 7
   at full size: the same server behind ``--http-port 0 --http-queue
   64`` driven by ``bench_http``, 4 concurrent clients x 12 rounds x 32:
   suggestions/s, round-trip and queue-wait p50/p95, the server's
   shed/replayed/expired counters, every acked report journaled once
   ((a) and (b) each run alone; their servers start together); (c) the
   exactly-once drill: a front door on the card, the client under seeded
   ``inject_net`` faults (refused, torn, delayed), the server SIGKILLed
   after journaling a report batch and before its reply, restarted with
   ``--resume``, the client retrying the same envelope into the
   restart: every acked (idem_key, idem_op) journaled exactly once, the
   retried batch answered ``journal_replayed``; (d) one
   ``SuggestServer.suggest(32)`` over a full ring (512 rows of
   tabular_mlp's space) in this process, timed by CUDA events, against
   the same draws on the CPU: equal picks (or, where the greedy picks
   part, a near-tie in both devices' acquisition), units within
   ``SUG_UNIT_TOL``, the ring's acquisition tensors on cuda, and the CPU
   call's time beside the card's; (e) a suggestion tenant under
   ``serve`` on the card: submitted, fed 24 requests, ``drain``ed after
   14 (parked, the server exits 0), resumed by a restarted server,
   completed by ``suggest-client stop`` (done): its records equal those
   of one unparked server fed the same requests. (c) and (e) run
   together;
22. the static-analysis suite (``--phases lint``, the 23rd of
   ``PHASES``; host only, no GroupNorm): (a) ``python -m
   mpi_opt_tpu_torch lint --json`` over the port's tree in a subprocess
   that reports whether it imported torch or jax: exit 0, ok, no
   errors, the 19 checks in the JAX package's order
   (``LINT_CHECKS``) and ``project-table``, neither torch nor jax
   imported; files scanned, the wall, each check's ``wall_s`` and the
   project pass's counts; (b) a copy of the tree with one planted fault
   for each per-file check (``LINT_PLANTS``, torch's host syncs, draws,
   seeds and CUDA OOM catch among them): exactly the planted (check,
   file, line) set, exit 1; ``--write-baseline`` exit 0, then
   ``--baseline`` exit 0 with every planted finding baselined; (c)
   ``digits_image`` and ``diabetes`` at seed 0 on the card's host, which
   has no scikit-learn: shapes, dtypes, and each array's sha256 equal to
   ``DATASET_SHA256`` (the JAX package's arrays);
23. processes: none of the phases' may be left running (the script is
   its descendants' subreaper, so an orphan counts too); the fork
   server the CPU backend's pools share is stopped and waited for, and
   the port stops multiprocessing's resource tracker at exit. Whatever
   was left is killed, and the run fails;
24. the script's wall, the ``kernels`` line (JSON), then the device line
   (JSON, last).

Each path (4, 6, 8, 9, 10a, 10d, 11b, 12b, 13b, 14c, 15b, 15d, 16c, 17d, 18a, 18d, 19, 20a,
21) runs through the entry points a user calls, with the launch counts
zeroed just before and read just after (in phase 9, its runs in this
process; in 10a, each run; in 11b, 12b, 13b and 14c, read at each
bracket or generation boundary too):
where the model has GroupNorm both kernels must have run, the plain
versions never; the best score must be finite and the curves in [0, 1].
Phase 21 runs no GroupNorm: its counts are recorded as read.

Run from the repo root: ``python3 chip_smoke.py``. Details also go to
chiprun_out/chip_smoke.json, written after each phase, with the seconds
each record took (``record_s``, from the one before it). ``--phases
tpe,bohb`` runs only the named phases after the build (a partial run
prints no result line).

``--baseline-cu PATH`` names the two-pass GroupNorm source of commit
788c451, written out with ``git show 788c451:mpi_opt_tpu_torch/csrc/
group_norm.cu``; it is built and timed, never used by the port. Any
other file is refused: ctypes cannot check a C interface.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import hashlib
import json
import math
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
# The ResNet-18 slice: 16 members folded into channels, batch 128. GN
# sites per member: (spatial S, channels C, sites a population step with
# ReLU, without); 32 groups each. Stage 0 = stem + gn1 x2 with ReLU, gn2
# x2 without; later stages = gn1 x2 with ReLU, gn2 x2 + gn_proj without
P, BATCH = 16, 128
SHAPES = [(1024, 64, 3, 2), (256, 128, 2, 3), (64, 256, 2, 3), (16, 512, 2, 3)]
GROUPS = 32
# The north star: SmallCNN, 256 members run in chunks of 32, batch 256,
# eval chunks of 1024 images. GN(8)+ReLU sites per member: (S, C), two
# at each a member chunk
CNN_P, CNN_CHUNK, CNN_BATCH, CNN_EVAL = 256, 32, 256, 1024
CNN_SHAPES = [(1024, 32), (256, 64)]
CNN_GROUPS = 8
NS_GENS, NS_STEPS = 2, 20  # the north star's depth here (the bench's: 4 x 100)
# the durability path: full-width SmallCNN, BASELINE.json config 3's population
DUR_P, DUR_GENS, DUR_STEPS = 32, 4, 20
_BF16, _F32 = torch.bfloat16, torch.float32
# every GN shape the paths run: (path, N, S, C, groups, {relu: sites a
# population step, or an eval chunk}, dtypes checked); bf16 is timed
SPECS = [
    *[("resnet18_p16", BATCH, s, P * c, P * GROUPS, {True: n_relu, False: n_plain}, (_BF16, _F32))
      for s, c, n_relu, n_plain in SHAPES],
    *[("smallcnn_p256", CNN_BATCH, s, CNN_CHUNK * c, CNN_CHUNK * CNN_GROUPS,
       {True: 2 * CNN_P // CNN_CHUNK}, (_BF16, _F32)) for s, c in CNN_SHAPES],
    *[("smallcnn_p256_eval", CNN_EVAL, s, CNN_CHUNK * c, CNN_CHUNK * CNN_GROUPS,
       {True: 2 * CNN_P // CNN_CHUNK}, (_BF16,)) for s, c in CNN_SHAPES],
]
# the paths whose population step the kernels line sums
STEP_PATHS = ("resnet18_p16", "smallcnn_p256")
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


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def _become_subreaper() -> None:
    """Have orphaned descendants (a worker whose fork server died)
    reparented to this process, where ``stop_processes`` finds them."""
    ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)  # PR_SET_CHILD_SUBREAPER


def _descendants() -> dict[int, str]:
    """This process's live descendants, pid -> command line, from /proc."""
    children, cmds = {}, {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmds[int(d)] = f.read().replace(b"\0", b" ").decode(errors="replace")[:160]
        except OSError:
            continue
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        if state != "Z":
            children.setdefault(int(ppid), []).append(int(d))
    out, todo = {}, [os.getpid()]
    while todo:
        for pid in children.get(todo.pop(), ()):
            out[pid] = cmds[pid]
            todo.append(pid)
    return out


def _kill(pids) -> None:
    """SIGTERM, then SIGKILL, each of ``pids`` that lives on, and reap
    those that are this process's children."""
    for sig in (signal.SIGTERM, signal.SIGKILL):
        live = set(pids) & set(_descendants())
        for pid in live:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        deadline = time.monotonic() + 3.0
        while live and time.monotonic() < deadline:
            time.sleep(0.05)
            live &= set(_descendants())
    for pid in pids:
        with contextlib.suppress(ChildProcessError):
            os.waitpid(pid, os.WNOHANG)


def stop_processes() -> dict[int, str]:
    """Stop every process the phases left running and return them: any
    but the fork server and resource tracker that multiprocessing keeps
    for the CPU backend's workers. The fork server is stopped here and
    waited for (``stop_fork_server``) once every backend is closed; the
    port stops the resource tracker when this process exits. A pool left
    open is terminated first, since it would respawn a killed worker and
    a live worker keeps the fork server up."""
    import gc
    import warnings
    from multiprocessing import forkserver, pool, resource_tracker

    server, tracker = forkserver._forkserver._forkserver_pid, resource_tracker._resource_tracker._pid
    left = {pid: cmd for pid, cmd in _descendants().items() if pid not in (server, tracker)}
    if left:
        with warnings.catch_warnings():  # isinstance wakes deprecated torch attributes
            warnings.simplefilter("ignore")
            pools = [obj for obj in gc.get_objects() if isinstance(obj, pool.Pool)]
        for p in pools:
            p.terminate()
        _kill(left)
    cpu = sys.modules.get("mpi_opt_tpu_torch.backends.cpu")
    if cpu is not None:
        cpu.stop_fork_server()
    rest = {pid: cmd for pid, cmd in _descendants().items() if pid != tracker}
    _kill(rest)
    return {**left, **rest}


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
    """Kernel vs plain at every GN shape of the paths (``SPECS``); returns
    (totals per path and kernel, one row per timed shape). A path's
    totals are the sums over one population step's sites (for the eval
    path, over one 1024-image eval chunk of the population)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")
    keys += ("baseline_ms",) if base else ()
    tot = {path: {k: dict.fromkeys(keys, 0.0) for k in ("gn_fwd", "gn_bwd")}
           for path in dict.fromkeys(spec[0] for spec in SPECS)}
    rows = []
    for path, n, s, c, g, sites, dtypes in SPECS:
        pbase = base if path == "resnet18_p16" else None
        for dtype in dtypes:
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            plans = {k: gn.gn_plan(n, s, c, g, dtype, k == "bwd") for k in ("fwd", "bwd")}
            print(f"plan {path} N={n} S={s} C={c} G={g} {tag}: " + "; ".join(
                f"{k} {p.cb} channels x {p.rb} rows a block, cluster {p.cluster}, "
                f"{p.threads} threads, {p.smem} B shared" for k, p in plans.items()))
            x = torch.randn((n, s, c), generator=gen, device="cuda").to(dtype)
            dy = torch.randn((n, s, c), generator=gen, device="cuda").to(dtype)
            gamma = 1.0 + 0.5 * torch.randn(c, generator=gen, device="cuda")
            beta = 0.1 * torch.randn(c, generator=gen, device="cuda")
            for relu, n_sites in sites.items():
                errs = check_shape(gn, x, dy, gamma, beta, g, relu, tag, pbase)
                for k in ("gn_fwd", "gn_bwd"):
                    tot[path][k]["max_abs_err"] = max(tot[path][k]["max_abs_err"], errs[k])
                if tag != "bf16":
                    continue  # the paths run bf16: time that
                row = time_shape(gn, x, dy, gamma, beta, g, relu, pbase, flush, bandwidth)
                for k, kk in (("gn_fwd", "fwd"), ("gn_bwd", "bwd")):
                    tot[path][k]["ms"] += n_sites * row[kk + "_ms"]
                    tot[path][k]["plain_ms"] += n_sites * row[kk + "_plain_ms"]
                    tot[path][k]["library_ms"] += n_sites * row[kk + "_lib_ms"]
                    tot[path][k]["bound_ms"] += n_sites * row[kk + "_bound_ms"]
                    if pbase:
                        tot[path][k]["baseline_ms"] += n_sites * row[kk + "_baseline_ms"]
                row = {"path": path, "N": n, "S": s, "C": c, "groups": g, "relu": relu,
                       "sites": n_sites, **row, "fwd_plan": dataclasses.asdict(plans["fwd"]),
                       "bwd_plan": dataclasses.asdict(plans["bwd"])}
                rows.append(row)
                print("kernel-shape " + json.dumps(row))
            del x, dy
            torch.cuda.empty_cache()
    for path in tot:
        for k in tot[path]:
            tot[path][k]["bound_share"] = tot[path][k]["bound_ms"] / tot[path][k]["ms"]
    return tot, rows


def check_shape(gn, x, dy, gamma, beta, g, relu, tag, base):
    """Both kernels against their plain versions on one input; returns
    the largest error of each kernel's outputs."""
    n, s, c = x.shape
    y, mean, rstd = gn.gn_fwd(x, gamma, beta, g, 1e-6, relu)
    yp, meanp, rstdp = gn.group_norm_relu_plain(x, gamma, beta, g, 1e-6, relu)
    at = f"{tag} N={n} S={s} C={c} relu={relu}"
    errs_f = [check(f"y {at}", y, yp, *TOL[(tag, "y")]),
              check(f"mean {at}", mean, meanp, *TOL["mean"]),
              check(f"rstd {at}", rstd, rstdp, *TOL["rstd"])]
    # backward: both sides from the kernel's statistics, so the ReLU
    # masks are decided on bit-identical z
    dx, dgm, dbt = gn.gn_bwd(x, dy, gamma, beta, mean, rstd, g, relu)
    dxp, dgmp, dbtp = gn.group_norm_relu_bwd_plain(x, dy, gamma, beta, mean, rstd, g, relu)
    torch.cuda.synchronize()
    errs_b = [check(f"dx {at}", dx, dxp, *TOL[(tag, "dx")]),
              check(f"dgamma {at}", dgm, dgmp, *TOL["dgamma"]),
              check(f"dbeta {at}", dbt, dbtp, *TOL["dbeta"])]
    if base:  # the baseline computes the same function
        check(f"baseline y {at}", base.fwd(x, gamma, beta, g, 1e-6, relu)[0], yp, *TOL[(tag, "y")])
        check(f"baseline dx {at}", base.bwd(x, dy, gamma, beta, mean, rstd, g, relu)[0], dxp,
              *TOL[(tag, "dx")])
    return {"gn_fwd": max(errs_f), "gn_bwd": max(errs_b)}


def check_shapes(gn, shapes, errs: dict, seed: int = 7, empty_cache: bool = False) -> None:
    """``check_shape`` at every (input shape, groups, relu, dtype) a path
    launched the kernels at (a ``_ShapeRecorder``'s), on random inputs
    from ``seed``; raises ``errs`` to each kernel's largest error
    (``empty_cache``: return each shape's memory to the card)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    for shape, g, relu, dtype in sorted(shapes, key=str):
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        gamma = 1.0 + 0.5 * torch.randn(shape[-1], generator=gen, device="cuda")
        beta = 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")
        e = check_shape(gn, x, dy, gamma, beta, g, relu,
                        "bf16" if dtype == torch.bfloat16 else "f32", None)
        for k in errs:
            errs[k] = max(errs[k], e[k])
        del x, dy
        if empty_cache:
            torch.cuda.empty_cache()


def time_shape(gn, x, dy, gamma, beta, g, relu, base, flush, bandwidth):
    """ms of kernel, plain version and library call (and baseline), each
    forward and backward, with the bytes bound and the share of it."""
    n, s, c = x.shape
    y, mean, rstd = gn.gn_fwd(x, gamma, beta, g, 1e-6, relu)
    del y
    # library yardstick: PyTorch's own GroupNorm on an NCHW copy
    hw = int(math.isqrt(s))
    xn = x.view(n, hw, hw, c).permute(0, 3, 1, 2).contiguous()
    dyn = dy.view(n, hw, hw, c).permute(0, 3, 1, 2).contiguous()
    gb, bb = gamma.to(x.dtype), beta.to(x.dtype)
    _, lmean, lrstd = torch.ops.aten.native_group_norm(xn, gb, bb, n, c, s, g, 1e-6)

    def lib_fwd():
        out = F.group_norm(xn, g, gb, bb, 1e-6)
        return F.relu(out) if relu else out

    t = {}
    t["fwd_ms"], t["fwd_baseline_ms"] = in_turns(
        lambda: gn.gn_fwd(x, gamma, beta, g, 1e-6, relu),
        base and (lambda: base.fwd(x, gamma, beta, g, 1e-6, relu)), flush)
    t["fwd_plain_ms"] = time_ms(lambda: gn.group_norm_relu_plain(x, gamma, beta, g, 1e-6, relu), flush)
    t["fwd_lib_ms"] = time_ms(lib_fwd, flush)
    t["bwd_ms"], t["bwd_baseline_ms"] = in_turns(
        lambda: gn.gn_bwd(x, dy, gamma, beta, mean, rstd, g, relu),
        base and (lambda: base.bwd(x, dy, gamma, beta, mean, rstd, g, relu)), flush)
    t["bwd_plain_ms"] = time_ms(
        lambda: gn.group_norm_relu_bwd_plain(x, dy, gamma, beta, mean, rstd, g, relu), flush)
    t["bwd_lib_ms"] = time_ms(lambda: torch.ops.aten.native_group_norm_backward(
        dyn, xn, lmean, lrstd, gb, n, c, s, g, [True, True, True]), flush)
    act = n * s * c * x.element_size()
    small = 2 * c * 4 + 2 * n * g * 4
    t["fwd_bound_ms"] = (2 * act + small) / bandwidth * 1e3
    t["bwd_bound_ms"] = (3 * act + small + 2 * n * c * 4) / bandwidth * 1e3
    t["fwd_bound_share"] = t["fwd_bound_ms"] / t["fwd_ms"]
    t["bwd_bound_share"] = t["bwd_bound_ms"] / t["bwd_ms"]
    return {k: v for k, v in t.items() if v is not None}


def clamp_check(gn):
    """Near-constant groups at a large mean (x = base + N(0, 1e-3), base
    in [50, 3000], f32) at the north star's 32x32 GN shape: there
    E[x^2] - mean^2 is rounding noise and often below -eps, so unclamped
    the kernel would give NaN. The kernel's and the plain version's sums
    round differently, so their rstd differ; what must hold is finite
    outputs, rstd <= 1/sqrt(eps), the means, and with gamma = 0 the
    output relu(beta) itself."""
    n, s, c, g = 4, 1024, CNN_CHUNK * 32, CNN_CHUNK * CNN_GROUPS
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    base = 50 + 2950 * torch.rand((n, 1, g, 1), generator=gen, device="cuda", dtype=torch.float64)
    noise = 1e-3 * torch.randn((n, s, g, c // g), generator=gen, device="cuda", dtype=torch.float64)
    x = (base + noise).reshape(n, s, c).float()
    xg = x.reshape(n, s, g, c // g)
    var = (xg * xg).mean(dim=(1, 3)) - xg.mean(dim=(1, 3)) ** 2
    negative = int((var < -1e-6).sum())
    if negative == 0:
        raise AssertionError("clamp case: no group's unclamped variance is below -eps")
    ones, zeros = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
    y, mean, rstd = gn.gn_fwd(x, ones, zeros, g, 1e-6, True)
    dx, _, _ = gn.gn_bwd(x, torch.ones_like(x), ones, zeros, mean, rstd, g, True)
    _, meanp, _ = gn.group_norm_relu_plain(x, ones, zeros, g, 1e-6, True)
    if not (bool(torch.isfinite(y).all()) and bool(torch.isfinite(dx).all())):
        raise AssertionError("clamp case: non-finite y or dx")
    if not bool((rstd <= 1e3 * (1 + 1e-6)).all()):
        raise AssertionError(f"clamp case: rstd up to {float(rstd.max())}, over 1/sqrt(eps)")
    check("clamp mean", mean, meanp, 0.0, 4e-6)
    beta = torch.randn(c, generator=gen, device="cuda")
    y0, _, _ = gn.gn_fwd(x, zeros, beta, g, 1e-6, True)
    err = check("clamp y at gamma 0", y0, torch.relu(beta).expand_as(x), 1e-6, 0.0)
    return {"shape": [n, s, c], "groups": g, "groups_with_negative_var_unclamped": negative,
            "rstd_max": float(rstd.max()), "y_gamma0_max_abs_err": err}


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


def smallcnn_check(SmallCNN):
    """Full-width two-member SmallCNN: logits and gradients on the card
    (kernels, cuDNN in f32 without TF32) against the CPU (plain), on
    images with constant patches, whose conv outputs are equal inside
    them, so the pools' windows there hold ties. Then the max-pool's
    gradient on the card's own pre-pool activations, f32 and bf16,
    against the CPU's on the same values: one element a window, the same
    one (the first maximum in row-major order, as XLA's select-and-scatter)."""
    gen = torch.Generator()
    gen.manual_seed(2)
    model = SmallCNN(n_classes=10, dtype=torch.float32, population=2)
    model.init_params(gen)
    x = torch.randn((4, 32, 32, 6), generator=gen)
    x[:, 4:12, 4:12, :] = 0.5
    x[:, 16:24, 0:8, :] = -1.0
    x = x.permute(0, 3, 1, 2)  # channels_last
    y = torch.randint(0, 10, (4,), generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        m = model.to(dev)
        m.zero_grad()
        logits = m(x.to(dev))
        F.cross_entropy(logits.reshape(8, 10), y.to(dev).repeat(2)).backward()
        out[dev] = (logits.detach().cpu(), {k: p.grad.detach().cpu() for k, p in m.named_parameters()})
    err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    scale = float(out["cpu"][0].abs().max())
    if not err <= 1e-3 * max(1.0, scale):
        raise AssertionError(f"SmallCNN logits: max abs err {err} over scale {scale}")
    sq = lambda d: sum(float((t.double() ** 2).sum()) for t in d.values())
    diff = {k: out["cuda"][1][k] - g for k, g in out["cpu"][1].items()}
    grad_err = (sq(diff) / sq(out["cpu"][1])) ** 0.5
    if not grad_err <= 1e-2:  # as model_check: rare ReLU-mask flips at z ~ 0
        raise AssertionError(f"SmallCNN gradients: relative L2 err {grad_err}")
    res = {"logits_max_abs_err": err, "logits_scale": scale, "grad_rel_l2_err": grad_err}
    with torch.no_grad():
        m = model.to("cuda")
        pre = m.gn1(m.conv1(m.gn0(m.conv0(x.cuda()))))  # the first pool's input, [4, 64, 32, 32]
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        grads = {}
        for dev in ("cuda", "cpu"):
            a = pre.to(dev, dtype).detach().requires_grad_()
            cot = torch.randn((4, 64, 16, 16), generator=torch.Generator().manual_seed(4)).to(dev, dtype)
            (F.max_pool2d(a, 2, 2) * cot).sum().backward()
            grads[dev] = a.grad.float().cpu()
        win = lambda t: t.reshape(4, 64, 16, 2, 16, 2).permute(0, 1, 2, 4, 3, 5).reshape(4, 64, 16, 16, 4)
        vals = win(pre.to(dtype).float().cpu())
        top = vals.max(dim=-1, keepdim=True).values
        ties = int((((vals == top).sum(-1) > 1) & (top[..., 0] > 0)).sum())
        if ties == 0:
            raise AssertionError(f"pool check {tag}: no window holds tied positive maxima")
        if not torch.equal(grads["cuda"], grads["cpu"]):
            raise AssertionError(f"pool check {tag}: the card routes the gradient elsewhere than the CPU")
        if int(((win(grads["cuda"]) != 0).sum(-1) > 1).sum()):
            raise AssertionError(f"pool check {tag}: a window's gradient is split")
        res[f"pool_tied_windows_{tag}"] = ties
    return res


def profile_phase(wl, res, member_chunk: int = 0, steps: int = 3, label: str = "profile"):
    """``torch.profiler`` over ``steps`` steady population steps of the
    path's own population and hyperparameters (one warm-up step first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mpi_opt_tpu_torch.train.common import hparams_fn

    d = wl.data()
    train_x = torch.from_numpy(d["train_x"]).cuda()
    train_y = torch.from_numpy(d["train_y"]).cuda().long()
    trainer = wl.make_trainer(member_chunk=member_chunk, device="cuda")
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
        print(f"{label}: the profiler showed no device time; timed with CUDA events instead")
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
        print(f"{label} {k}: {out[k]}")
    for kind in ("top", "copies"):
        for r in out[kind]:
            print(f"{label} {kind}: {r['ms_per_step']:.4f} ms/step, "
                  f"{r['calls_per_step']:.1f} calls/step, {r['name']}")
    return out


def sweep_fault(res, gens: int, launches: dict, what: str, kernels: bool = True) -> str | None:
    """What is wrong with a sweep's result and launch counts, or None:
    both kernels launched (where the model has GroupNorm), the plain
    version never, a finite best score, curves of ``gens`` values in [0, 1]."""
    if kernels and not (launches["gn_fwd"] > 0 and launches["gn_bwd"] > 0):
        return f"{what} did not launch both kernels: {launches}"
    if launches["plain"] != 0:
        return f"{what} called the plain GroupNorm: {launches}"
    curves = (res["best_curve"], res["mean_curve"])
    if not (math.isfinite(res["best_score"]) and all(c.shape == (gens,) for c in curves)):
        return f"{what}: bad sweep result: best {res['best_score']}, curves {curves}"
    if not all(bool((c >= 0).all() and (c <= 1).all()) for c in curves):
        return f"{what}: accuracies outside [0, 1]: {curves}"
    return None


def _records(path):
    """A ledger's member records without their wall-clock and per-ledger
    random fields (ts, sweep_id)."""
    with open(path) as f:
        recs = [json.loads(x) for x in f.read().splitlines()[1:]]
    return [{k: v for k, v in r.items() if k not in ("ts", "sweep_id")} for r in recs]


def _cli(tmp, name, *extra):
    """argv of the port's CLI on the durability path, in ``tmp/name``."""
    return [sys.executable, "-m", "mpi_opt_tpu_torch", "--workload", "cifar10_cnn",
            "--algorithm", "pbt", "--fused", "--population", str(DUR_P), "--generations",
            str(DUR_GENS), "--steps-per-generation", str(DUR_STEPS), "--gen-chunk", "1",
            "--seed", "0", "--device", "cuda", "--checkpoint-dir", os.path.join(tmp, name, "ck"),
            "--ledger", os.path.join(tmp, name, "ledger.jsonl"), *extra]


def _interrupt(argv, ready, sig, label: str):
    """Start the CLI, wait until ``ready()`` holds, send ``sig``; returns
    (exit code, stdout). The process is killed if it outlives its
    deadline."""
    proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 300
        while not ready():
            if proc.poll() is not None or time.monotonic() > deadline:
                out, err = proc.communicate(timeout=60)
                raise AssertionError(f"{label}: the run ended (rc {proc.returncode}) before the "
                                     f"signal point:\n{out[-2000:]}\n{err[-4000:]}")
            time.sleep(0.02)
        proc.send_signal(sig)
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, out, err


def _resume(argv, label: str):
    """Run the CLI with --resume to its end; returns its summary line."""
    proc = subprocess.run([*argv, "--resume"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"{label}: --resume exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _run_to_end(argv):
    """(exit code, last stdout line as JSON) of a CLI run."""
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    return proc.returncode, json.loads(lines[-1]) if lines else {}


def _journaled(path, boundaries: int):
    """Does the ledger at ``path`` hold every record of ``boundaries``
    generations?"""
    def ready():
        try:
            with open(path) as f:
                return sum(1 for x in f if '"boundary"' in x) >= boundaries * DUR_P
        except OSError:
            return False
    return ready


def _committed(ckpt, step: int, after_s: float = 0.0):
    """Is snapshot ``step`` committed (and ``after_s`` past)?"""
    seen = {}

    def ready():
        if not os.path.exists(os.path.join(ckpt, str(step), "COMMIT")):
            return False
        seen.setdefault("t", time.monotonic())
        return time.monotonic() - seen["t"] >= after_s
    return ready


def durability_phase(gn, fused_pbt, get_workload, smi):
    """The durability path: full-width cifar10_cnn at population 32,
    DUR_GENS generations x DUR_STEPS steps, one generation a launch,
    with snapshots and a ledger. Returns (result dict, GN launches of its
    in-process runs, problem or None)."""
    import shutil

    from mpi_opt_tpu_torch.ledger import SweepLedger, validate_ledger
    from mpi_opt_tpu_torch.utils import integrity
    from mpi_opt_tpu_torch.utils.checkpoint import SweepCheckpointer
    from mpi_opt_tpu_torch.utils.exitcodes import EX_DATAERR, EX_IOERR, EX_TEMPFAIL

    tmp = os.path.join(ROOT, "build", "chip_smoke_durability")
    shutil.rmtree(tmp, ignore_errors=True)
    out = {"population": DUR_P, "generations": DUR_GENS, "steps_per_gen": DUR_STEPS}
    try:
        wl = get_workload("cifar10_cnn")
        wl.data()
        space = wl.default_space()
        # 1. two unkilled runs in this process: the determinism precondition
        gn.reset_launches()
        runs = []
        for name in ("unkilled_a", "unkilled_b"):
            led = SweepLedger(os.path.join(tmp, name, "ledger.jsonl"), read_only=False)
            led.ensure_header({"mode": "fused", "granularity": "generation", "algorithm": "pbt",
                               "seed": 0, "space_hash": space.space_hash()}, space_spec=space.spec())
            t0 = time.perf_counter()
            res = fused_pbt(wl, population=DUR_P, generations=DUR_GENS, steps_per_gen=DUR_STEPS,
                            seed=0, gen_chunk=1, checkpoint_dir=os.path.join(tmp, name, "ck"), ledger=led)
            torch.cuda.synchronize()
            led.close()
            st = res["state"]
            runs.append((res, integrity.tree_digest(
                {"params": st.params, "momentum": st.momentum, "step": st.step}),
                time.perf_counter() - t0))
        launches = dict(gn.LAUNCHES)
        (ref, dig_a, wall_a), (other, dig_b, wall_b) = runs
        out.update(state_digest_a=dig_a, state_digest_b=dig_b, wall_s=[wall_a, wall_b],
                   launch_walls_s=ref["launch_walls"], best_score=ref["best_score"],
                   best_curve=ref["best_curve"].tolist(), launches=launches)
        print(f"durability unkilled: digests {dig_a} {dig_b}, best {ref['best_score']}, "
              f"curve {ref['best_curve'].tolist()}, walls {wall_a:.3f} {wall_b:.3f} s")
        bad = sweep_fault(ref, DUR_GENS, launches, "the durability path")
        if bad:
            return out, launches, bad
        if dig_a != dig_b:
            return out, launches, f"two unkilled runs differ: state digests {dig_a} vs {dig_b}"
        want = _records(os.path.join(tmp, "unkilled_a", "ledger.jsonl"))
        if _records(os.path.join(tmp, "unkilled_b", "ledger.jsonl")) != want:
            return out, launches, "two unkilled runs journaled different records"
        want_best = (round(ref["best_score"], 6), [round(float(v), 4) for v in ref["best_curve"]])

        def same_as_unkilled(name, summary):
            recs = _records(os.path.join(tmp, name, "ledger.jsonl"))
            if recs != want:
                n = sum(a != b for a, b in zip(recs, want)) + abs(len(recs) - len(want))
                return f"{name}: ledger differs from the unkilled run's in {n} records"
            if (summary["best_score"], summary["best_curve"]) != want_best:
                return f"{name}: best {summary['best_score']} {summary['best_curve']} vs {want_best}"
            return None

        # 2. the CLI: three drills at once (their runs are independent; the
        # device-OOM run after them, since it fills the card)
        def sigterm_drill():
            # SIGTERM once generation 1 is journaled -> 75, resume -> 0
            argv = _cli(tmp, "sigterm")
            t0 = time.perf_counter()
            rc, stdout, err = _interrupt(argv, _journaled(os.path.join(tmp, "sigterm", "ledger.jsonl"), 1),
                                         signal.SIGTERM, "SIGTERM run")
            last = json.loads(stdout.strip().splitlines()[-1]) if stdout.strip() else {}
            if rc != EX_TEMPFAIL or not last.get("preempted"):
                return {}, f"SIGTERM run: exit {rc}, last line {last}:\n{err[-3000:]}"
            summary = _resume(argv, "SIGTERM run")
            print(f"durability SIGTERM: exit {rc} at {last['at']}, resume journal {summary.get('journal')}")
            return ({"sigterm": {"exit": rc, "preempted_line": last, "resumed": summary,
                                 "wall_s": time.perf_counter() - t0}}, same_as_unkilled("sigterm", summary))

        def sigkill_drill():
            # SIGKILL in the middle of launch 3 -> resume -> 0
            argv = _cli(tmp, "sigkill")
            rc, _, _ = _interrupt(argv, _committed(os.path.join(tmp, "sigkill", "ck"), 2, 0.15),
                                  signal.SIGKILL, "SIGKILL run")
            steps = integrity._committed_steps(os.path.join(tmp, "sigkill", "ck"))
            summary = _resume(argv, "SIGKILL run")
            rec = {"sigkill": {"exit": rc, "committed_at_kill": steps, "resumed": summary}}
            print(f"durability SIGKILL: exit {rc}, snapshots {steps}, resume journal {summary.get('journal')}")
            if rc != -signal.SIGKILL:
                return rec, f"SIGKILL run exited {rc}, not by the signal"
            bad = same_as_unkilled("sigkill", summary)
            if bad:
                return rec, bad
            # a tampered ledger -> 65: the newest two snapshots removed, one
            # journaled score of generation 2 edited; the resume re-computes
            # generation 2 and refuses the journal
            for step in (3, 4):
                shutil.rmtree(os.path.join(tmp, "sigkill", "ck", str(step)))
            path = os.path.join(tmp, "sigkill", "ledger.jsonl")
            with open(path) as f:
                lines = f.read().splitlines()
            i = next(i for i, x in enumerate(lines) if '"boundary": 2' in x)
            r = json.loads(lines[i])
            r["score"] += 0.25
            lines[i] = json.dumps(r)
            with open(path, "w") as f:
                f.write("\n".join(lines) + "\n")
            rc, last = _run_to_end([*argv, "--resume"])
            rec["tampered_ledger"] = {"exit": rc, "last_line": last}
            print(f"durability tampered ledger: exit {rc}")
            if rc != EX_DATAERR or "data_error" not in last:
                return rec, f"tampered ledger: exit {rc}, last line {last}"
            return rec, None

        def step_chunk_drill():
            # step_chunk 7, snapshots every 2 launches, SIGKILL once generation
            # 2 is journaled: the resume re-computes generation 2 and verifies it
            argv = _cli(tmp, "step_chunk", "--step-chunk", "7", "--checkpoint-every", "2")
            rc, _, _ = _interrupt(argv, _journaled(os.path.join(tmp, "step_chunk", "ledger.jsonl"), 3),
                                  signal.SIGKILL, "step_chunk run")
            summary = _resume(argv, "step_chunk run")
            problems = validate_ledger(os.path.join(tmp, "step_chunk", "ledger.jsonl"))
            rec = {"step_chunk": {"exit": rc, "resumed": summary, "ledger_problems": problems}}
            print(f"durability step_chunk 7: exit {rc}, resume journal {summary.get('journal')}")
            if problems or summary["journal"]["verified"] < DUR_P:
                return rec, f"step_chunk run: journal {summary['journal']}, problems {problems}"
            return rec, same_as_unkilled("step_chunk", summary)  # the port's step_chunk is bit-identical

        for rec, bad in _together(sigterm_drill, sigkill_drill, step_chunk_drill):
            out.update(rec)
            if bad:
                return out, launches, bad
        # 3. a real device OOM -> 74: 65536 members' parameters do not fit
        argv = _cli(tmp, "oom")
        argv[argv.index("--population") + 1] = "65536"
        rc, last = _run_to_end(argv)
        out["device_oom"] = {"exit": rc, "last_line": last}
        print(f"durability device OOM: exit {rc}, {str(last)[:300]}")
        if rc != EX_IOERR or last.get("kind") != "device_oom":
            return out, launches, f"device OOM: exit {rc}, last line {last}"

        # 4. a snapshot at the north star's population: 256 members, 1 x 5
        # steps, twice (the same digest), saved once and restored
        gn.reset_launches()
        ns = []
        for _ in range(2):
            res = fused_pbt(wl, population=CNN_P, generations=1, steps_per_gen=5, seed=0,
                            member_chunk=CNN_CHUNK)
            st = res["state"]
            ns.append((res, integrity.tree_digest(
                {"params": st.params, "momentum": st.momentum, "step": st.step})))
        for k, v in gn.LAUNCHES.items():
            launches[k] += v
        if ns[0][1] != ns[1][1]:
            return out, launches, f"two population-256 runs differ: {ns[0][1]} vs {ns[1][1]}"
        res = ns[0][0]
        ck = SweepCheckpointer(os.path.join(tmp, "snapshot_p256"), {"population": CNN_P})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the payload fused_pbt saves; the scores' values do not matter here
        ck.save_population_sweep(1, res["state"], torch.from_numpy(res["unit"]).cuda(),
                                 torch.Generator(device="cuda"), torch.zeros(CNN_P),
                                 {"launches_done": 1})
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(r, f))
                     for r, _, fs in os.walk(os.path.join(tmp, "snapshot_p256")) for f in fs)
        t0 = time.perf_counter()
        state, *_ = ck.restore_population_sweep()
        restore_s = time.perf_counter() - t0
        back = integrity.tree_digest({"params": state.params, "momentum": state.momentum,
                                      "step": state.step})
        # where the save's time goes: the same three steps one at a time
        st = res["state"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = {"params": {k: v.to("cpu") for k, v in st.params.items()},
                "momentum": {k: v.to("cpu") for k, v in st.momentum.items()}, "step": st.step.cpu()}
        copy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        integrity.tree_digest(host)
        digest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        integrity.write_step(os.path.join(tmp, "snapshot_p256"), 2, host, {}, {})
        write_s = time.perf_counter() - t0
        out["snapshot_p256"] = {"card": smi, "save_s": save_s, "restore_verify_s": restore_s,
                                "bytes": nbytes, "state_digest": ns[0][1], "host_copy_s": copy_s,
                                "digest_s": digest_s, "write_fsync_s": write_s}
        print(f"snapshot p256 ({smi}): save {save_s} s (host copy {copy_s} s, digest {digest_s} s, "
              f"write+fsync {write_s} s), restore+verify {restore_s} s, {nbytes} bytes on disk")
        if back != ns[0][1]:
            return out, launches, "the population-256 snapshot restored other bytes"
        out["launches"] = launches
        return out, launches, None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# The wave engine's phases: the north star in waves (a), a real OOM
# absorbed by the CLI (b), a drain between waves and its resume (c), SHA
# resident and in waves (d), and config 5's wave cap (e)
WAVE, WAVE_ODD = 64, 48  # the north star's wave sizes: a multiple of CNN_CHUNK, and not
TRACE_COVERAGE, TRACE_COST = 0.9, 0.05  # the traced runs' gates: coverage, and cost over untraced
# the OOM drill without a member chunk: W fails, W/2 fits. Every launch
# runs W >> 2 members either way, so the two caps differ only by the
# waves' state: cifar100_cnn's 19 MB a member puts 0.3-0.6 GB between them
OOM_WL, OOM_P, OOM_GENS, OOM_STEPS, OOM_W = "cifar100_cnn", 64, 2, 5, 32
# the OOM drill inside one launch width: ResNet-18 (a member's state ~90
# MB, so waves of B2_W and B2_CHUNK differ by GBs) in chunks of B2_CHUNK
B2_P, B2_GENS, B2_STEPS, B2_W, B2_CHUNK = 64, 2, 3, 32, 16
DRAIN_W, DRAIN_CHUNK = 8, 8  # the drain drill: DUR_P members in waves of 8
SHA_TRIALS, SHA_MIN, SHA_MAX, SHA_ETA, SHA_W = 64, 10, 270, 3, 16  # BENCH_ALL.json configs 2 and 9
C5_P = 1024  # BASELINE.json config 5: PBT over 1024 ResNet-18 members
# the phases after the build, in order (``--phases`` picks some)
PHASES = ("kernels", "slice", "north_star", "mlp", "durability", "waves", "oom", "oom_chunk", "drain",
          "sha", "config5", "hyperband", "tpe", "bohb", "mo", "driver", "warm", "cpu", "windows", "mesh",
          "service", "suggest", "lint")

# a launcher for the port's CLI: caps this process's CUDA allocator at a
# fraction of the card (0: no cap), runs the CLI, and writes the
# allocator's peaks to a file at exit. Only this launcher knows the cap.
_LAUNCHER = """
import atexit, json, runpy, sys
import torch
frac, out = float(sys.argv[1]), sys.argv[2]
if frac > 0:
    torch.cuda.set_per_process_memory_fraction(frac)
def dump():
    with open(out, "w") as f:
        json.dump({"max_reserved": torch.cuda.max_memory_reserved(),
                   "max_allocated": torch.cuda.max_memory_allocated()}, f)
atexit.register(dump)
sys.argv = ["mpi_opt_tpu_torch", *sys.argv[3:]]
runpy.run_module("mpi_opt_tpu_torch", run_name="__main__", alter_sys=True)
"""


def _state_digest(res) -> str:
    from mpi_opt_tpu_torch.utils import integrity

    st = res["state"]
    return integrity.tree_digest({"params": st.params, "momentum": st.momentum, "step": st.step})


def _wave_fields(res) -> dict:
    keys = ("wave_size", "wave_lens", "n_waves", "waves_run", "oom_backoffs", "staged_bytes",
            "stage_transfer_s", "stage_wait_s", "stage_overlap_s")
    return {k: res[k] for k in keys if k in res}


def _span_table(path):
    """(attribution, self seconds by span[:op]) of one traced run's stream."""
    from mpi_opt_tpu_torch.obs import report

    recs = report.load_stream(path)
    by = {}
    for r in recs:
        if r.get("event") == "span":
            k = r["span"] + (f":{r['op']}" if "op" in r else "")
            by[k] = by.get(k, 0.0) + float(r["self_s"])
    return report.attribute({os.path.basename(path): recs}), by


def north_star_waves_phase(gn, fused_pbt, get_workload, smi):
    """(a) The north star (cifar10_cnn at full width, 256 members, member
    chunk 32) at NS_GENS x NS_STEPS through ``fused_pbt``, in this order:
    traced resident (a fresh workload: its set-up is in the trace),
    resident, traced resident, waves of 64, waves of 64, traced resident,
    resident, waves of 48, traced waves of 64. Every run must end in the
    first run's state digest and best curve (waves of 48 hold whole
    chunks of 32 since every launch runs one member chunk; tracing adds
    no synchronisation). The traced runs' coverage must be >= TRACE_COVERAGE
    and the traced resident runs may cost at most TRACE_COST over the
    untraced ones in turns (resident, traced, traced, resident). Returns
    (record, GN launches of the wave runs, problem)."""
    from mpi_opt_tpu_torch.obs import trace
    from mpi_opt_tpu_torch.train import staging
    from mpi_opt_tpu_torch.utils.metrics import MetricsLogger

    wl = get_workload("cifar10_cnn")
    wl.data()
    out = {"card": smi, "population": CNN_P, "member_chunk": CNN_CHUNK, "generations": NS_GENS,
           "steps_per_gen": NS_STEPS, "runs": []}
    launches = {"gn_fwd": 0, "gn_bwd": 0, "plain": 0}
    # what two full pools cost to allocate, pinned, at this population
    trainer = wl.make_trainer(member_chunk=CNN_CHUNK, device="cuda")
    t0 = time.perf_counter()
    pools = [staging.population_pool(trainer, CNN_P) for _ in range(2)]
    out["pool_alloc_s"] = time.perf_counter() - t0
    out["pool_bytes"] = staging.tree_bytes(pools[0])
    del pools
    print(f"north-star waves ({smi}): two pinned pools of {out['pool_bytes']} bytes allocated in "
          f"{out['pool_alloc_s']} s")
    tmp = os.path.join(ROOT, "build", "chip_smoke_traces")
    os.makedirs(tmp, exist_ok=True)
    plan = (("traced_resident", 0, True), ("resident", 0, False), ("traced_resident", 0, True),
            ("wave64", WAVE, False), ("wave64", WAVE, False), ("traced_resident", 0, True),
            ("resident", 0, False), ("wave48", WAVE_ODD, False), ("traced_wave64", WAVE, True))
    traces = {}
    for i, (tag, ws, traced) in enumerate(plan):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        gn.reset_launches()
        path = os.path.join(tmp, f"run{i}.jsonl")
        if traced:
            metrics = MetricsLogger(path=path)
            prior = trace.configure(metrics)
        t0 = time.perf_counter()
        try:
            res = fused_pbt(wl, population=CNN_P, generations=NS_GENS, steps_per_gen=NS_STEPS, seed=0,
                            member_chunk=CNN_CHUNK, wave_size=ws)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            if traced:
                trace.deconfigure(prior)
                metrics.close()
        run_launches = dict(gn.LAUNCHES)
        bad = sweep_fault(res, NS_GENS, run_launches, f"the north star ({tag})")
        if bad:
            return out, launches, bad
        if ws:
            for k in launches:
                launches[k] += run_launches[k]
        rec = {"tag": tag, "wave_size": ws, "traced": traced, "wall_s": wall,
               "member_generations_per_s": CNN_P * NS_GENS / wall,
               "launch_walls_s": res["launch_walls"],
               # what was allocated before the call (earlier phases' live
               # tensors), and the call's peak above it
               "baseline_allocated_bytes": base,
               "peak_over_baseline_bytes": torch.cuda.max_memory_allocated() - base,
               "max_memory_reserved_bytes": torch.cuda.max_memory_reserved(),
               "state_digest": _state_digest(res), "best_curve": res["best_curve"].tolist(),
               "launches": run_launches, **_wave_fields(res)}
        if traced:
            rep, by_span = _span_table(path)
            traces[i] = (rep, by_span, wall)
            rec["trace"] = {"coverage": rep["coverage"], "wall_s": rep["wall_s"],
                            "attributed_s": rep["attributed_s"], "self_s_by_span": by_span,
                            "phases": rep["phases"], "bubbles": rep["bubbles"],
                            "staging": rep["staging"], "roofline": rep["roofline"]}
            print(f"north-star trace {tag} (run {i}): coverage {rep['coverage']} of {rep['wall_s']} s "
                  f"(call wall {wall} s); self s by span {json.dumps(by_span)}")
        out["runs"].append(rec)
        print(f"north-star waves {tag}: {json.dumps({k: v for k, v in rec.items() if k != 'trace'})}")
        del res
    ref = out["runs"][0]
    for rec in out["runs"]:
        if (rec["state_digest"], rec["best_curve"]) != (ref["state_digest"], ref["best_curve"]):
            return out, launches, (f"north star {rec['tag']}: state digest {rec['state_digest']} / "
                                   f"curve {rec['best_curve']} vs resident {ref['state_digest']} / "
                                   f"{ref['best_curve']}")
    runs = out["runs"]
    rate = lambda idx: [runs[j]["member_generations_per_s"] for j in idx]
    untraced, traced_ = rate((1, 6)), rate((2, 5))
    out["trace_cost"] = {"untraced": untraced, "traced": traced_,
                         "cost": sum(untraced) / sum(traced_) - 1.0}
    out["waves_vs_resident"] = {"resident": untraced, "wave64": rate((3, 4)), "wave48": rate((7,))}
    # where the wave gap goes: the traced wave-64 run's self seconds by
    # span against the traced resident run's in the middle of the turns
    (_, res_spans, res_wall), (_, wav_spans, wav_wall) = traces[5], traces[8]
    out["wave_gap"] = {"resident_wall_s": res_wall, "wave64_wall_s": wav_wall,
                       "gap_s": wav_wall - res_wall,
                       "self_s_delta_by_span": {k: wav_spans.get(k, 0.0) - res_spans.get(k, 0.0)
                                                for k in sorted(set(res_spans) | set(wav_spans))}}
    print(f"north-star trace cost: {json.dumps(out['trace_cost'])}")
    print(f"north-star waves vs resident: {json.dumps(out['waves_vs_resident'])}")
    print(f"north-star wave gap: {json.dumps(out['wave_gap'])}")
    for i, (rep, _, _) in traces.items():
        if rep["coverage"] is None or rep["coverage"] < TRACE_COVERAGE:
            return out, launches, f"north star run {i}: trace coverage {rep['coverage']} < {TRACE_COVERAGE}"
    if out["trace_cost"]["cost"] > TRACE_COST:
        return out, launches, f"tracing cost {out['trace_cost']['cost']:.4f} > {TRACE_COST}"
    out["launches"] = launches
    return out, launches, None


def _together(*fns):
    """Call independent functions (each starting and waiting on its own
    subprocesses) at once, on threads; their results in order. Drills
    whose runs do not depend on each other overlap their processes'
    start-up (the script's wall is mostly start-up)."""
    with concurrent.futures.ThreadPoolExecutor(len(fns)) as pool:
        return [f.result() for f in [pool.submit(fn) for fn in fns]]


def _launch_cli(argv, frac: float, peaks: str):
    """Run the CLI through the capping launcher; (exit code, stdout lines
    parsed as JSON, stderr, allocator peaks)."""
    proc = subprocess.run([sys.executable, "-c", _LAUNCHER, str(frac), peaks, *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    try:
        with open(peaks) as f:
            mem = json.load(f)
    except OSError:
        mem = None
    return proc.returncode, lines, proc.stderr, mem


def oom_drill_phase(smi):
    """(b) A real device OOM absorbed by the CLI without a member chunk.
    Clean runs: waves of OOM_W with --oom-backoff 2 (launches of OOM_W >> 2
    members), waves of OOM_W/2 with --oom-backoff 1 (launches of the same
    width) and waves of OOM_W with --oom-backoff 0 (launches of OOM_W,
    whole waves), at once: their allocator peaks and rates (the three
    share the card, and (b2)'s runs too). Then, at once, a run capped three quarters of the way from the
    half-cap run's allocated peak to the cap-OOM_W run's (its allocated
    bytes must pass the cap; the backed-off waves keep a quarter of the gap
    for the allocator's fragmentation), at --wave-size OOM_W --oom-backoff
    2: exit 0 with one backoff, no launch-shape change and the records of
    the UNFAULTED cap-OOM_W run, and the same cap with --oom-backoff 0,
    which must exit 74."""
    import shutil

    from mpi_opt_tpu_torch.utils.exitcodes import EX_IOERR

    tmp = os.path.join(ROOT, "build", "chip_smoke_oom")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.cuda.empty_cache()  # this process's cached blocks are the card's too
    out = {"card": smi, "workload": OOM_WL, "population": OOM_P, "generations": OOM_GENS,
           "steps_per_gen": OOM_STEPS, "wave_size": OOM_W}
    try:
        def argv(name, ws, backoff):
            return ["--workload", OOM_WL, "--algorithm", "pbt", "--fused", "--population",
                    str(OOM_P), "--generations", str(OOM_GENS), "--steps-per-generation",
                    str(OOM_STEPS), "--seed", "0", "--device", "cuda", "--wave-size", str(ws),
                    "--oom-backoff", str(backoff), "--ledger", os.path.join(tmp, f"{name}.jsonl")]

        clean = {}
        specs = (("w32", OOM_W, 2), ("w16", OOM_W // 2, 1), ("w32_wide", OOM_W, 0))

        def clean_run(name, ws, backoff):
            t0 = time.perf_counter()
            got = _launch_cli(argv(name, ws, backoff), 0.0, os.path.join(tmp, f"{name}.json"))
            return (*got, time.perf_counter() - t0)

        # the three clean runs at once (each process's peaks are its own)
        results = _together(*[lambda s=s: clean_run(*s) for s in specs])
        for (name, _, _), (rc, lines, err, mem, wall) in zip(specs, results):
            if rc != 0 or mem is None:
                return out, f"OOM drill: the clean run {name} exited {rc}:\n{err[-3000:]}"
            summary = lines[-1]
            clean[name] = {"summary": summary, "peaks": mem, "process_wall_s": wall,
                           "launch_width": summary.get("launch_width"),
                           "member_generations_per_s": summary.get("trials_per_sec_per_chip")}
        out["clean"] = clean
        print(f"oom drill ({smi}): clean runs, launch width and member-generations/s (CLI summary): "
              + json.dumps({k: [v["launch_width"], v["member_generations_per_s"]] for k, v in clean.items()}))
        if (clean["w32"]["launch_width"], clean["w16"]["launch_width"]) != (OOM_W >> 2, OOM_W >> 2):
            return out, f"OOM drill: launch widths {clean['w32']['launch_width']}, {clean['w16']['launch_width']}"
        total = torch.cuda.get_device_properties(0).total_memory
        lo = clean["w16"]["peaks"]["max_allocated"]
        hi = clean["w32"]["peaks"]["max_allocated"]
        if not hi > lo:
            return out, f"OOM drill: waves of {OOM_W} allocated {hi} bytes, not more than {lo}"
        cap = lo + 3 * (hi - lo) // 4
        frac = cap / total
        out.update(cap_bytes=cap, cap_fraction=frac, card_bytes=total)
        # both capped runs at once (each process has its own cap)
        (rc, lines, err, mem), nobackoff = _together(
            lambda: _launch_cli(argv("oom", OOM_W, 2), frac, os.path.join(tmp, "oom.json")),
            lambda: _launch_cli(argv("nobackoff", OOM_W, 0), frac, os.path.join(tmp, "nobackoff.json")))
        summary = lines[-1] if lines else {}
        events = [x for x in lines if x.get("event") == "oom_backoff"]
        out["backoff"] = {"exit": rc, "summary": summary, "oom_backoff_events": events, "peaks": mem}
        print(f"oom drill ({smi}): cap {cap} bytes ({frac:.4f} of the card) between allocated peaks "
              f"{lo} (waves of {OOM_W // 2}) and {hi} (waves of {OOM_W}); "
              f"--oom-backoff 2: exit {rc}, oom_backoffs {summary.get('oom_backoffs')}, settled wave "
              f"{summary.get('wave_size')}, launch width {summary.get('launch_width')}, events {events}")
        if rc != 0 or summary.get("oom_backoffs") != 1 or summary.get("wave_size") != OOM_W // 2:
            return out, f"OOM drill: exit {rc}, summary {summary}:\n{err[-3000:]}"
        if summary.get("launch_shape_changed") or any(e.get("launch_shape_changed") for e in events):
            return out, f"OOM drill: the launch shape changed: {events}"
        got, want = (_records(os.path.join(tmp, f"{n}.jsonl")) for n in ("oom", "w32"))
        if got != want:
            n = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
            return out, f"OOM drill: {n} records differ from the unfaulted cap-{OOM_W} run's"
        rc, lines, err, _ = nobackoff
        out["no_backoff"] = {"exit": rc, "last_line": lines[-1] if lines else None}
        print(f"oom drill --oom-backoff 0: exit {rc}")
        if rc != EX_IOERR or not lines or lines[-1].get("kind") != "device_oom":
            return out, f"OOM drill: --oom-backoff 0 exited {rc}:\n{err[-3000:]}"
        return out, None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def oom_chunk_drill_phase(smi):
    """(b2) An OOM backed off inside one launch width: cifar100_resnet18
    at B2_P members in chunks of B2_CHUNK, through the CLI. Clean runs at
    waves of B2_W and B2_CHUNK, at once, measure their allocated peaks; a run capped
    between them at --wave-size B2_W --oom-backoff 2 must exit 0 with one
    backoff to B2_CHUNK, no launch-shape change, and the records of the
    UNFAULTED run at B2_W."""
    import shutil

    tmp = os.path.join(ROOT, "build", "chip_smoke_oom_chunk")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.cuda.empty_cache()
    out = {"card": smi, "workload": "cifar100_resnet18", "population": B2_P,
           "generations": B2_GENS, "steps_per_gen": B2_STEPS, "member_chunk": B2_CHUNK,
           "wave_size": B2_W}
    try:
        def argv(name, ws):
            return ["--workload", "cifar100_resnet18", "--algorithm", "pbt", "--fused",
                    "--population", str(B2_P), "--generations", str(B2_GENS),
                    "--steps-per-generation", str(B2_STEPS), "--seed", "0", "--device", "cuda",
                    "--member-chunk", str(B2_CHUNK), "--wave-size", str(ws), "--oom-backoff", "2",
                    "--ledger", os.path.join(tmp, f"{name}.jsonl")]

        clean = {}

        def clean_run(ws):
            t0 = time.perf_counter()
            got = _launch_cli(argv(f"clean{ws}", ws), 0.0, os.path.join(tmp, f"clean{ws}.json"))
            return (*got, time.perf_counter() - t0)

        # both clean runs at once (each process's peaks are its own)
        for ws, (rc, lines, err, mem, wall) in zip((B2_W, B2_CHUNK), _together(
                lambda: clean_run(B2_W), lambda: clean_run(B2_CHUNK))):
            if rc != 0 or mem is None:
                return out, f"OOM chunk drill: the clean run at waves of {ws} exited {rc}:\n{err[-3000:]}"
            clean[ws] = {"summary": lines[-1], "peaks": mem, "wall_s": wall}
        out["clean"] = clean
        total = torch.cuda.get_device_properties(0).total_memory
        lo, hi = clean[B2_CHUNK]["peaks"]["max_allocated"], clean[B2_W]["peaks"]["max_allocated"]
        if not hi > lo:
            return out, f"OOM chunk drill: waves of {B2_W} allocated {hi} bytes, not more than {lo}"
        cap = (lo + hi) // 2
        frac = cap / total
        out.update(cap_bytes=cap, cap_fraction=frac, card_bytes=total)
        rc, lines, err, mem = _launch_cli(argv("oom", B2_W), frac, os.path.join(tmp, "oom.json"))
        summary = lines[-1] if lines else {}
        events = [x for x in lines if x.get("event") == "oom_backoff"]
        out["backoff"] = {"exit": rc, "summary": summary, "oom_backoff_events": events, "peaks": mem}
        print(f"oom chunk drill ({smi}): cap {cap} bytes ({frac:.4f} of the card) between allocated "
              f"peaks {lo} (waves of {B2_CHUNK}) and {hi} (waves of {B2_W}); exit {rc}, oom_backoffs "
              f"{summary.get('oom_backoffs')}, settled wave {summary.get('wave_size')}, events {events}")
        if rc != 0 or summary.get("oom_backoffs") != 1 or summary.get("wave_size") != B2_CHUNK:
            return out, f"OOM chunk drill: exit {rc}, summary {summary}:\n{err[-3000:]}"
        if summary.get("launch_shape_changed") or any(e.get("launch_shape_changed") for e in events):
            return out, f"OOM chunk drill: the launch shape changed: {events}"
        got, want = (_records(os.path.join(tmp, f"{n}.jsonl")) for n in ("oom", f"clean{B2_W}"))
        if got != want:
            n = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
            return out, f"OOM chunk drill: {n} records differ from the unfaulted cap-{B2_W} run's"
        return out, None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def drain_waves_phase(smi):
    """(c) The durability config (DUR_P members, DUR_GENS x DUR_STEPS,
    snapshots and ledger) in waves of DRAIN_W, member chunk DRAIN_CHUNK:
    SIGTERM once wave 2 of generation 1 (0-based) is dispatched must exit
    75; --resume must exit 0, train only the waves not completed
    (``waves_run``), and end with the unkilled wave run's records, which
    must equal the resident run's. The two unkilled runs and the one
    SIGTERMed run at once."""
    import shutil

    from mpi_opt_tpu_torch.health import heartbeat
    from mpi_opt_tpu_torch.utils import integrity
    from mpi_opt_tpu_torch.utils.exitcodes import EX_TEMPFAIL

    tmp = os.path.join(ROOT, "build", "chip_smoke_drain")
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    n_waves = DUR_P // DRAIN_W
    out = {"card": smi, "population": DUR_P, "wave_size": DRAIN_W, "member_chunk": DRAIN_CHUNK}
    try:
        def argv(name, ws):
            return [*_cli(tmp, name), "--member-chunk", str(DRAIN_CHUNK), "--gen-chunk", "0",
                    "--wave-size", str(ws), "--heartbeat-file", os.path.join(tmp, name, "beat.json")]

        beat = os.path.join(tmp, "sigterm", "beat.json")
        launch = 1 * n_waves + 2  # generation 1, wave 2: its between-waves boundary

        def ready():
            rec = heartbeat.read_beat(beat)
            p = (rec or {}).get("progress", {})
            return p.get("launch", 0) >= launch or p.get("transfers", 0) >= launch

        def unkilled(name, ws):
            t0 = time.perf_counter()
            rc, last = _run_to_end(argv(name, ws))
            return {"exit": rc, "summary": last, "wall_s": time.perf_counter() - t0}

        # the two unkilled runs and the one to be drained, at once
        resident, waves, (rc, stdout, err) = _together(
            lambda: unkilled("resident", 0), lambda: unkilled("waves", DRAIN_W),
            lambda: _interrupt(argv("sigterm", DRAIN_W), ready, signal.SIGTERM, "drain drill"))
        ends = {"resident": resident, "waves": waves}
        out["unkilled"] = ends
        for name, end in ends.items():
            if end["exit"] != 0:
                return out, f"drain drill: the unkilled {name} run exited {end['exit']}: {end['summary']}"
        want = _records(os.path.join(tmp, "waves", "ledger.jsonl"))
        if _records(os.path.join(tmp, "resident", "ledger.jsonl")) != want:
            return out, "drain drill: the wave run's records differ from the resident run's"
        last = json.loads(stdout.strip().splitlines()[-1]) if stdout.strip() else {}
        steps = integrity._committed_steps(os.path.join(tmp, "sigterm", "ck"))
        print(f"drain drill: exit {rc} at {last.get('at')}, snapshots {steps}")
        if rc != EX_TEMPFAIL or not last.get("preempted"):
            return out, f"drain drill: exit {rc}, last line {last}:\n{err[-3000:]}"
        g, w = (int(x.split("/")[0]) for x in last["at"].split(" ")[2::2])  # "pbt gen G/N wave W/M"
        done = (g - 1) * n_waves + w
        summary = _resume(argv("sigterm", DRAIN_W), "drain drill")
        out["sigterm"] = {"exit": rc, "preempted_line": last, "snapshots": steps,
                          "waves_completed": done, "resumed": summary}
        print(f"drain drill resume: waves_run {summary.get('waves_run')} "
              f"(expected {DUR_GENS * n_waves - done}), journal {summary.get('journal')}")
        if summary.get("waves_run") != DUR_GENS * n_waves - done:
            return out, f"drain drill: the resume trained {summary.get('waves_run')} waves, " \
                        f"not the {DUR_GENS * n_waves - done} left"
        if _records(os.path.join(tmp, "sigterm", "ledger.jsonl")) != want:
            return out, "drain drill: the resumed run's records differ from the unkilled run's"
        return out, None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def sha_phase(gn, get_workload, smi):
    """(d) Fused SHA on fashion_mlp, SHA_TRIALS trials, budgets SHA_MIN ->
    SHA_MAX, eta SHA_ETA (BENCH_ALL.json config 2), resident, then in
    waves of SHA_W (config 9; launches of SHA_W >> 2 members), then in
    waves of SHA_W launching whole waves (``oom_backoff=0``). Returns
    (record, GN launches, problem)."""
    from mpi_opt_tpu_torch.train.fused_asha import fused_sha

    wl = get_workload("fashion_mlp")
    wl.data()
    out = {"card": smi, "n_trials": SHA_TRIALS, "budgets": [SHA_MIN, SHA_MAX], "eta": SHA_ETA}
    gn.reset_launches()
    runs = {}
    # waves of SHA_W launch SHA_W >> 2 members (the OOM budget's smallest
    # cap); with oom_backoff=0 a launch is the whole wave
    for tag, ws, backoff in (("resident", 0, 2), ("waves", SHA_W, 2), ("waves_wide", SHA_W, 0)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fused_sha(wl, n_trials=SHA_TRIALS, min_budget=SHA_MIN, max_budget=SHA_MAX, eta=SHA_ETA,
                        seed=0, wave_size=ws, oom_backoff=backoff)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[tag] = res
        out[tag] = {"wall_s": wall, "trials_per_s": SHA_TRIALS / wall, "best_score": res["best_score"],
                    "best_trial": res["best_trial"], "rung_sizes": res["rung_sizes"],
                    "rung_budgets": res["rung_budgets"], "launch_width": res.get("launch_width"),
                    **_wave_fields(res)}
        print(f"sha {tag} ({smi}): {json.dumps(out[tag])}")
        if res["rung_sizes"] != [64, 22, 8, 3] or res["rung_budgets"] != [10, 30, 90, 270]:
            return out, dict(gn.LAUNCHES), f"sha {tag}: rungs {res['rung_sizes']} {res['rung_budgets']}"
        if not math.isfinite(res["best_score"]) or not 0 <= res["best_score"] <= 1:
            return out, dict(gn.LAUNCHES), f"sha {tag}: best score {res['best_score']}"
    launches = dict(gn.LAUNCHES)
    if launches["plain"]:
        return out, launches, f"sha called the plain GroupNorm: {launches}"
    a, b = runs["resident"], runs["waves"]
    out["waves_vs_resident"] = {
        "same_survivors": [h["trials"] for h in a["rung_history"]] == [h["trials"] for h in b["rung_history"]],
        "same_best": (a["best_score"], a["best_trial"]) == (b["best_score"], b["best_trial"]),
        "max_abs_last_score_diff": float(np.nanmax(np.abs(a["last_score"] - b["last_score"]))),
    }
    print(f"sha waves vs resident: {json.dumps(out['waves_vs_resident'])}")
    return out, launches, None


def config5_phase(get_workload, smi):
    """(e) BASELINE.json config 5's wave cap on this card, without
    training: per-member bytes of cifar100_resnet18, the measured budget,
    and ``estimate_wave_size`` at C5_P members."""
    from mpi_opt_tpu_torch.obs import memory
    from mpi_opt_tpu_torch.train.engine import wave_layout
    from mpi_opt_tpu_torch.train.staging import estimate_wave_size

    trainer = get_workload("cifar100_resnet18").make_trainer(device="cuda")
    w = estimate_wave_size(trainer, C5_P)
    out = {"card": smi, "population": C5_P, "per_member_bytes": trainer.member_bytes(),
           "measured_budget_bytes": memory.measured_budget(), "auto_wave_size": w,
           "wave_lens": wave_layout(C5_P, w)[0]}
    print(f"config 5 ({smi}): {json.dumps(out)}")
    return out


def _per_boundary(gn, prefix: str):
    """(counts, injector): the GN launch counts at each launch boundary
    whose stage starts with ``prefix`` (between-wave boundaries are
    skipped), for ``resources.set_boundary_fault_injector``."""
    counts = []

    def at_boundary(stage):
        if stage.startswith(prefix) and " wave " not in stage:
            counts.append(dict(gn.LAUNCHES))

    return counts, at_boundary


# Fused Hyperband: fashion_mlp through the CLI at its defaults (R=270,
# eta 3), and full-width cifar10_cnn at R=27 in chunks of 8, resident
# and in waves of 8
HB_MLP_PLAN = [(243, 1), (98, 3), (41, 10), (18, 30), (9, 90), (6, 270)]
HB_CNN_R, HB_CNN_CHUNK, HB_CNN_W = 27, 8, 8
HB_CNN_PLAN = [(27, 1), (12, 3), (6, 9), (4, 27)]


def hyperband_mlp_phase(smi, algorithm: str = "hyperband"):
    """(a) ``--algorithm hyperband|bohb --fused`` on fashion_mlp at the
    CLI defaults, with a ledger: HB_MLP_PLAN's brackets, 415 trials, a
    finite best, and one ledger whose boundaries run contiguously across
    the brackets and that the port's reader validates; BOHB's model must
    draw in a later bracket."""
    import shutil

    from mpi_opt_tpu_torch.ledger import validate_ledger

    tmp = os.path.join(ROOT, "build", f"chip_smoke_{algorithm}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    ledger = os.path.join(tmp, "ledger.jsonl")
    try:
        t0 = time.perf_counter()
        rc, summary = _run_to_end([sys.executable, "-m", "mpi_opt_tpu_torch", "--workload",
                                   "fashion_mlp", "--algorithm", algorithm, "--fused", "--seed", "0",
                                   "--device", "cuda", "--ledger", ledger])
        wall = time.perf_counter() - t0
        recs = _records(ledger) if os.path.exists(ledger) else []
        problems = validate_ledger(ledger) if os.path.exists(ledger) else ["no ledger"]
        plan = [(b["n_trials"], b["start_budget"]) for b in summary.get("brackets", [])]
        n_rungs = sum(len(b["rung_budgets"]) for b in summary.get("brackets", []))
        out = {"card": smi, "exit": rc, "process_wall_s": wall, "summary": summary,
               "records": len(recs), "ledger_problems": problems, "plan": plan,
               "trials_per_s": summary.get("trials_per_sec_per_chip")}
        n_model = [b.get("n_model_sampled") for b in summary.get("brackets", [])]
        out["n_model_sampled"] = n_model
        print(f"{algorithm} fashion_mlp ({smi}): exit {rc}, {summary.get('n_trials')} trials, "
              f"best {summary.get('best_score')}, {summary.get('trials_per_sec_per_chip')} trials/s "
              f"(sweep wall {summary.get('wall_s')} s, process {wall:.3f} s), {len(recs)} records, "
              f"model-drawn by bracket {n_model}")
        if rc != 0 or plan != HB_MLP_PLAN or summary.get("n_trials") != 415:
            return out, f"{algorithm} fashion_mlp: exit {rc}, plan {plan}, summary {str(summary)[:2000]}"
        if summary.get("best_score") is None or not math.isfinite(summary["best_score"]):
            return out, f"{algorithm} fashion_mlp: best score {summary.get('best_score')}"
        if problems or sorted({r["boundary"] for r in recs}) != list(range(n_rungs)):
            return out, f"{algorithm} fashion_mlp: ledger problems {problems}, boundaries not 0..{n_rungs - 1}"
        if len(recs) != sum(sum(b["rung_sizes"]) for b in summary["brackets"]):
            return out, f"{algorithm} fashion_mlp: {len(recs)} records for rung sizes {summary['brackets']}"
        if algorithm == "bohb" and not any(n_model[1:]):
            return out, f"bohb fashion_mlp: the model drew in no later bracket: {n_model}"
        return out, None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def hyperband_cnn_phase(gn, get_workload, smi, algorithm: str = "hyperband"):
    """(b) ``fused_hyperband`` (or ``fused_bohb``) over full-width
    cifar10_cnn (SmallCNN 32-32-64-64, GN(8)) at R=HB_CNN_R, eta 3, member
    chunk HB_CNN_CHUNK, resident and then in waves of HB_CNN_W, each
    journaled: the rung cohorts 27, 9, 3, ... are not multiples of the
    chunk, so the padded launches run. Both runs must end with the same
    records and best; both GN kernels must launch in every bracket, the
    plain versions never. Returns (record, GN launches of both runs,
    problem)."""
    import shutil

    from mpi_opt_tpu_torch.ledger import SweepLedger, validate_ledger
    from mpi_opt_tpu_torch.train.fused_asha import fused_hyperband
    from mpi_opt_tpu_torch.train.fused_bohb import fused_bohb
    from mpi_opt_tpu_torch.utils import resources

    sweep = fused_hyperband if algorithm == "hyperband" else fused_bohb
    tmp = os.path.join(ROOT, "build", f"chip_smoke_{algorithm}_cnn")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    wl = get_workload("cifar10_cnn")
    wl.data()
    space = wl.default_space()
    out = {"card": smi, "max_budget": HB_CNN_R, "eta": 3, "member_chunk": HB_CNN_CHUNK}
    launches = {"gn_fwd": 0, "gn_bwd": 0, "plain": 0}
    try:
        for tag, ws in (("resident", 0), ("waves", HB_CNN_W)):
            led = SweepLedger(os.path.join(tmp, f"{tag}.jsonl"), read_only=False)
            led.ensure_header({"mode": "fused", "granularity": "rung", "algorithm": algorithm,
                               "seed": 0, "space_hash": space.space_hash()}, space_spec=space.spec())
            per_bracket, at_boundary = _per_boundary(gn, "hyperband bracket")
            gn.reset_launches()
            resources.set_boundary_fault_injector(at_boundary)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                res = sweep(wl, max_budget=HB_CNN_R, eta=3, seed=0, member_chunk=HB_CNN_CHUNK,
                            ledger=led, wave_size=ws)
                torch.cuda.synchronize()
            finally:
                resources.set_boundary_fault_injector(None)
                led.close()
            wall = time.perf_counter() - t0
            run_launches = dict(gn.LAUNCHES)
            for k in launches:
                launches[k] += run_launches[k]
            deltas = [{k: b[k] - (per_bracket[i - 1][k] if i else 0) for k in b}
                      for i, b in enumerate(per_bracket)]
            out[tag] = {"wall_s": wall, "trials_per_s": res["n_trials"] / wall,
                        "best_score": res["best_score"], "brackets": res["brackets"],
                        "launches": run_launches, "launches_by_bracket": deltas,
                        "ledger_problems": validate_ledger(led.path),
                        **{k: res[k] for k in ("wave_size", "waves_run", "staged_bytes") if k in res}}
            print(f"{algorithm} cifar10_cnn {tag} ({smi}): {json.dumps(out[tag])}")
            plan = [(b["n_trials"], b["start_budget"]) for b in res["brackets"]]
            if plan != HB_CNN_PLAN or not math.isfinite(res["best_score"]):
                return out, launches, f"{algorithm} cifar10_cnn {tag}: plan {plan}, best {res['best_score']}"
            if out[tag]["ledger_problems"]:
                return out, launches, f"{algorithm} cifar10_cnn {tag}: ledger {out[tag]['ledger_problems']}"
            if len(deltas) != len(HB_CNN_PLAN) or any(
                    d["gn_fwd"] <= 0 or d["gn_bwd"] <= 0 or d["plain"] for d in deltas):
                return out, launches, f"{algorithm} cifar10_cnn {tag}: launches by bracket {deltas}"
        a, b = out["resident"], out["waves"]
        same_records = _records(os.path.join(tmp, "resident.jsonl")) == _records(
            os.path.join(tmp, "waves.jsonl"))
        out["waves_vs_resident"] = {"same_records": same_records,
                                    "same_best": a["best_score"] == b["best_score"]}
        print(f"{algorithm} cifar10_cnn waves vs resident: {json.dumps(out['waves_vs_resident'])}")
        if not (same_records and a["best_score"] == b["best_score"]):
            return out, launches, f"{algorithm} cifar10_cnn: the wave run's records or best differ from resident"
        out["launches"] = launches
        return out, launches, None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Fused TPE: BASELINE.json config 4 (bench_all.py's fused_tpe(tabular_mlp,
# n_trials=256, batch=64, budget=30)), nothing cut; the SmallCNN at full
# width cut to 64 trials in batches of 32, 20 steps, chunk 8, resident and
# in waves of 16; the acquisition timed at config 4's shapes
C4_TRIALS, C4_BATCH, C4_BUDGET = 256, 64, 30
TPE_CNN_TRIALS, TPE_CNN_BATCH, TPE_CNN_BUDGET, TPE_CNN_CHUNK, TPE_CNN_W = 64, 32, 20, 8, 16
ACQ_C, ACQ_M, ACQ_D = 1024, 256, 3


def _event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` between two CUDA events, host dispatch
    included where the host is the slower side (a call of many small
    kernels: the acquisition's greedy picks)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tpe_config4_phase(smi):
    """(a) Config 4 at full size through ``fused_tpe``: a call on a fresh
    workload (set-up included), a timed call, a traced call (its
    ``suggest`` spans), each with its trials/s and best; then the
    acquisition alone at C=ACQ_C candidates over M=ACQ_M observations in
    d=ACQ_D, by CUDA events: the whole suggestion of a batch (the
    diversified greedy picks) and of one point (a plain top-k)."""
    from mpi_opt_tpu_torch import get_workload
    from mpi_opt_tpu_torch.obs import report, trace
    from mpi_opt_tpu_torch.ops import tpe
    from mpi_opt_tpu_torch.train.fused_tpe import fused_tpe
    from mpi_opt_tpu_torch.utils.metrics import MetricsLogger

    out = {"card": smi, "workload": "tabular_mlp", "dataset": "breast_cancer", "n_trials": C4_TRIALS,
           "batch": C4_BATCH, "budget": C4_BUDGET, "runs": {}}
    path = os.path.join(ROOT, "build", "chip_smoke_traces", "tpe_config4.jsonl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    wl = get_workload("tabular_mlp")  # fresh: its data loads inside the first call
    for tag, traced in (("setup_included", False), ("warm", False), ("traced", True)):
        if traced:
            metrics = MetricsLogger(path=path)
            prior = trace.configure(metrics)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            res = fused_tpe(wl, n_trials=C4_TRIALS, batch=C4_BATCH, budget=C4_BUDGET, seed=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            if traced:
                trace.deconfigure(prior)
                metrics.close()
        curve = res["best_curve"].tolist()
        out["runs"][tag] = {"wall_s": wall, "trials_per_s": C4_TRIALS / wall, "best_score": res["best_score"],
                            "best_params": res["best_params"], "best_curve": curve,
                            "member_failures": res["member_failures"]}
        print(f"tpe config 4 {tag} ({smi}): {json.dumps(out['runs'][tag])}")
        if not (math.isfinite(res["best_score"]) and 0 <= res["best_score"] <= 1) or len(curve) != 4 \
                or curve != sorted(curve):
            return out, f"tpe config 4 {tag}: best {res['best_score']}, curve {curve}"
    spans = [r for r in report.load_stream(path) if r.get("event") == "span"]
    out["suggest_spans_s"] = [r["dur_s"] for r in spans if r["span"] == "boundary" and r.get("op") == "suggest"]
    out["train_spans_s"] = [r["dur_s"] for r in spans if r["span"] == "train"]
    print(f"tpe config 4 traced: suggest spans {out['suggest_spans_s']} s, train spans {out['train_spans_s']} s")
    if len(out["suggest_spans_s"]) != C4_TRIALS // C4_BATCH:
        return out, f"tpe config 4: {len(out['suggest_spans_s'])} suggest spans"
    # the acquisition alone, at config 4's ring once full
    gen = torch.Generator(device="cuda").manual_seed(0)
    unit = torch.rand((ACQ_M, ACQ_D), generator=gen, device="cuda")
    scores = -((unit - 0.7) ** 2).sum(1)
    valid = torch.ones(ACQ_M, dtype=torch.bool, device="cuda")
    cfg = tpe.TPEConfig(n_candidates=ACQ_C)
    acq = {}
    for label, n in (("batch_of_64", C4_BATCH), ("one_point", 1)):
        acq[label] = _event_ms(lambda n=n: tpe.tpe_suggest(gen, unit, scores, valid, n, cfg))
    model = tpe.tpe_fit(unit, scores, valid, cfg)
    draws = tpe.draw_tpe(gen, ACQ_M, ACQ_D, cfg)
    comp = tpe.pick_components(draws.u_pick, model.probs)
    acq["mixture_of_candidates"] = _event_ms(lambda: tpe._log_mixture(draws.uni, unit, model.good_w, model.bw_g, 1.0))
    acq["apply_one_point"] = _event_ms(lambda: tpe.tpe_apply(unit, model, comp, draws.jitter, draws.uni, 1, cfg))
    out["acquisition_ms"] = acq
    print(f"tpe acquisition ({smi}), C={ACQ_C} M={ACQ_M} d={ACQ_D}, ms a call: {json.dumps(acq)}")
    return out, None


def tpe_cnn_phase(gn, get_workload, smi):
    """(b) ``fused_tpe`` over full-width cifar10_cnn, TPE_CNN_TRIALS trials
    in batches of TPE_CNN_BATCH, TPE_CNN_BUDGET steps, member chunk
    TPE_CNN_CHUNK, journaled, resident and then in waves of TPE_CNN_W: the
    same records and best; both GN kernels launch in every generation,
    the plain versions never. Returns (record, GN launches, problem)."""
    import shutil

    from mpi_opt_tpu_torch.ledger import SweepLedger, validate_ledger
    from mpi_opt_tpu_torch.train.fused_tpe import fused_tpe
    from mpi_opt_tpu_torch.utils import resources

    tmp = os.path.join(ROOT, "build", "chip_smoke_tpe_cnn")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    wl = get_workload("cifar10_cnn")
    wl.data()
    space = wl.default_space()
    n_gens = TPE_CNN_TRIALS // TPE_CNN_BATCH
    out = {"card": smi, "n_trials": TPE_CNN_TRIALS, "batch": TPE_CNN_BATCH, "budget": TPE_CNN_BUDGET,
           "member_chunk": TPE_CNN_CHUNK}
    launches = {"gn_fwd": 0, "gn_bwd": 0, "plain": 0}
    try:
        for tag, ws in (("resident", 0), ("waves", TPE_CNN_W)):
            led = SweepLedger(os.path.join(tmp, f"{tag}.jsonl"), read_only=False)
            led.ensure_header({"mode": "fused", "granularity": "batch", "algorithm": "tpe", "seed": 0,
                               "space_hash": space.space_hash()}, space_spec=space.spec())
            per_gen, at_boundary = _per_boundary(gn, "tpe generation")
            gn.reset_launches()
            resources.set_boundary_fault_injector(at_boundary)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                res = fused_tpe(wl, n_trials=TPE_CNN_TRIALS, batch=TPE_CNN_BATCH, budget=TPE_CNN_BUDGET,
                                seed=0, member_chunk=TPE_CNN_CHUNK, ledger=led, wave_size=ws)
                torch.cuda.synchronize()
            finally:
                resources.set_boundary_fault_injector(None)
                led.close()
            wall = time.perf_counter() - t0
            run_launches = dict(gn.LAUNCHES)
            for k in launches:
                launches[k] += run_launches[k]
            deltas = [{k: c[k] - (per_gen[i - 1][k] if i else 0) for k in c} for i, c in enumerate(per_gen)]
            out[tag] = {"wall_s": wall, "trials_per_s": TPE_CNN_TRIALS / wall, "best_score": res["best_score"],
                        "best_curve": res["best_curve"].tolist(), "launches": run_launches,
                        "launches_by_generation": deltas, "ledger_problems": validate_ledger(led.path),
                        **{k: res[k] for k in ("wave_size", "wave_lens", "waves_run", "launch_width",
                                               "staged_bytes") if k in res}}
            print(f"tpe cifar10_cnn {tag} ({smi}): {json.dumps(out[tag])}")
            if not (math.isfinite(res["best_score"]) and 0 <= res["best_score"] <= 1):
                return out, launches, f"tpe cifar10_cnn {tag}: best {res['best_score']}"
            if out[tag]["ledger_problems"]:
                return out, launches, f"tpe cifar10_cnn {tag}: ledger {out[tag]['ledger_problems']}"
            if len(deltas) != n_gens or any(d["gn_fwd"] <= 0 or d["gn_bwd"] <= 0 or d["plain"] for d in deltas):
                return out, launches, f"tpe cifar10_cnn {tag}: launches by generation {deltas}"
        same_records = _records(os.path.join(tmp, "resident.jsonl")) == _records(
            os.path.join(tmp, "waves.jsonl"))
        same_best = out["resident"]["best_score"] == out["waves"]["best_score"]
        out["waves_vs_resident"] = {"same_records": same_records, "same_best": same_best}
        print(f"tpe cifar10_cnn waves vs resident: {json.dumps(out['waves_vs_resident'])}")
        if not (same_records and same_best):
            return out, launches, "tpe cifar10_cnn: the wave run's records or best differ from resident"
        out["launches"] = launches
        return out, launches, None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def tpe_cli_phase(smi):
    """(c) The CLI at config 4's shape on tabular_mlp with a ledger and
    snapshots, at once: an unkilled run, and a run SIGKILLed once batch 2
    is journaled (exit -9), then ``--resume`` (exit 0) must end with the
    unkilled run's records, best and curve."""
    import shutil

    tmp = os.path.join(ROOT, "build", "chip_smoke_tpe_cli")
    shutil.rmtree(tmp, ignore_errors=True)

    def argv(name):
        os.makedirs(os.path.join(tmp, name), exist_ok=True)
        return [sys.executable, "-m", "mpi_opt_tpu_torch", "--workload", "tabular_mlp", "--algorithm", "tpe",
                "--fused", "--trials", str(C4_TRIALS), "--population", str(C4_BATCH), "--budget",
                str(C4_BUDGET), "--seed", "0", "--device", "cuda", "--checkpoint-dir",
                os.path.join(tmp, name, "ck"), "--ledger", os.path.join(tmp, name, "ledger.jsonl")]

    def batches_journaled(path, n):
        def ready():
            try:
                with open(path) as f:
                    return sum(1 for x in f if '"boundary"' in x) >= n * C4_BATCH
            except OSError:
                return False
        return ready

    out = {"card": smi}
    try:
        # the unkilled and the killed run are independent: at once
        cut = argv("cut")
        (rc, whole), (rc_k, _, err) = _together(
            lambda: _run_to_end(argv("whole")),
            lambda: _interrupt(cut, batches_journaled(os.path.join(tmp, "cut", "ledger.jsonl"), 2),
                               signal.SIGKILL, "tpe CLI SIGKILL"))
        out["unkilled"] = {"exit": rc, "summary": whole}
        if rc != 0:
            return out, f"tpe CLI: the unkilled run exited {rc}"
        out["killed"] = {"exit": rc_k}
        if rc_k != -signal.SIGKILL:
            return out, f"tpe CLI: the killed run exited {rc_k}:\n{err[-3000:]}"
        resumed = _resume(cut, "tpe CLI")
        out["resumed"] = resumed
        same = _records(os.path.join(tmp, "cut", "ledger.jsonl")) == _records(
            os.path.join(tmp, "whole", "ledger.jsonl"))
        out["same_records"] = same
        print(f"tpe CLI ({smi}): unkilled {whole.get('trials_per_sec_per_chip')} trials/s (beside the killed "
              f"run, not a metric), best "
              f"{whole.get('best_score')}; SIGKILL exit {rc_k}; resumed best {resumed.get('best_score')}, "
              f"journal {resumed.get('journal')}, same records {same}")
        if not same or (resumed.get("best_score"), resumed.get("best_curve")) != (
                whole.get("best_score"), whole.get("best_curve")):
            return out, "tpe CLI: the resumed run's records, best or curve differ from the unkilled run's"
        return out, None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Multi-objective: BENCH_ALL.json config 8 (bench_all.py:744-790) at full
# size, nothing cut; the CLI drill runs config 8's members and steps for
# more generations, so a kill after generation 1 lands mid-run
MO_SPEC = "accuracy:max,params:min"
# (c)'s depth: a quarter of NS_STEPS, which leaves room in the run's time
# limit for the CPU path's and the suggestion service's phases (the
# MO-over-scalar ratio is taken in turns at one depth either way)
MO_NS_STEPS = 5
C8_P, C8_GENS, C8_STEPS = 8, 3, 40
MO_CLI_GENS = 12
MO_SHA_SPEC = "accuracy:max,latency:min"


def _mo_ledger(path, space, spec, algorithm: str, text: str):
    from mpi_opt_tpu_torch.ledger import SweepLedger

    led = SweepLedger(path, read_only=False)
    led.ensure_header({"mode": "fused", "granularity": "generation" if algorithm == "pbt" else "rung",
                       "algorithm": algorithm, "seed": 0, "space_hash": space.space_hash(),
                       **({"objectives": text} if spec is not None else {})},
                      space_spec=space.spec(), objective_spec=None if spec is None else spec.spec())
    return led


def _front_fault(res, what: str, selection: str = "feasible") -> str | None:
    p = res["pareto"]
    if p is None or p["selection"] != selection or p["front_size"] < 1 or not math.isfinite(p["hypervolume"]):
        return f"{what}: pareto {p}"
    if p["front_size"] != len(p["front_members"]) or any(
            len(v) != len(res["objectives"]) or not all(map(math.isfinite, v)) for v in p["front_scores"]):
        return f"{what}: pareto {p}"
    return None


def mo_config8_phase(smi):
    """(a) BENCH_ALL.json config 8 at full size: ``fused_pbt`` over
    ``digits_mlp``, C8_P members x C8_GENS x C8_STEPS, one generation a
    launch, ``accuracy:max,params:min``: a call on a fresh workload (the
    digits table parsed inside it), a timed call, then two journaled
    calls and one at ``gen_chunk=3``. Member-generations/s, the front,
    its hypervolume and the winner's vector (the front member with the
    best primary, as the JAX bench reports it); every call must end in
    the first one's state digest, the journaled calls in the same
    records (2-vectors), the gen-chunk split included."""
    import shutil

    from mpi_opt_tpu_torch import get_workload
    from mpi_opt_tpu_torch.ledger import validate_ledger
    from mpi_opt_tpu_torch.objectives import ObjectiveSpec
    from mpi_opt_tpu_torch.train.fused_pbt import fused_pbt

    spec = ObjectiveSpec.parse(MO_SPEC)
    wl = get_workload("digits_mlp")  # fresh: the table is parsed inside the first call
    space = wl.default_space()
    tmp = os.path.join(ROOT, "build", "chip_smoke_mo")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    out = {"card": smi, "workload": "digits_mlp", "objectives": MO_SPEC, "population": C8_P,
           "generations": C8_GENS, "steps_per_gen": C8_STEPS, "runs": {}}
    digests, records = {}, {}
    try:
        for tag, chunk, journaled in (("setup_included", 1, False), ("warm", 1, False),
                                      ("ledger", 1, True), ("ledger_again", 1, True),
                                      ("ledger_gen_chunk3", 3, True)):
            path = os.path.join(tmp, f"{tag}.jsonl")
            led = _mo_ledger(path, space, spec, "pbt", MO_SPEC) if journaled else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                res = fused_pbt(wl, population=C8_P, generations=C8_GENS, steps_per_gen=C8_STEPS, seed=0,
                                gen_chunk=chunk, objectives=spec, ledger=led)
                torch.cuda.synchronize()
            finally:
                if led is not None:
                    led.close()
            wall = time.perf_counter() - t0
            p = res["pareto"]
            out["runs"][tag] = {
                "wall_s": wall, "member_generations_per_s": C8_P * C8_GENS / wall,
                "best_score": res["best_score"], "best_curve": res["best_curve"].tolist(),
                "member_failures": res["member_failures"], "front_size": p["front_size"],
                "hypervolume": p["hypervolume"], "selection": p["selection"],
                "winner": max(p["front_scores"], key=lambda v: v[0]), "front_scores": p["front_scores"]}
            print(f"mo config 8 {tag} ({smi}): {json.dumps(out['runs'][tag])}")
            bad = sweep_fault(res, C8_GENS, {"gn_fwd": 0, "gn_bwd": 0, "plain": 0}, f"mo config 8 {tag}",
                              kernels=False) or _front_fault(res, f"mo config 8 {tag}")
            if bad:
                return out, bad
            digests[tag] = _state_digest(res)
            if journaled:
                records[tag] = _records(path)
                problems = validate_ledger(path)
                vectors = [len(r["scores"]) for r in records[tag] if r["status"] == "ok"]
                if problems or len(records[tag]) != C8_P * C8_GENS or set(vectors) != {2}:
                    return out, f"mo config 8 {tag}: ledger {problems}, vectors {vectors}"
        out["same_digest"] = len(set(digests.values())) == 1
        out["same_records"] = records["ledger"] == records["ledger_again"] == records["ledger_gen_chunk3"]
        print(f"mo config 8: one state digest {out['same_digest']}, the same records {out['same_records']}")
        if not (out["same_digest"] and out["same_records"]):
            return out, f"mo config 8: digests {digests}, same records {out['same_records']}"
        return out, None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def mo_cli_phase(smi):
    """(b) The CLI on digits_mlp with ``--objectives``, a ledger and
    snapshots (config 8's members and steps, MO_CLI_GENS generations),
    three runs at once: an unkilled run, the degraded run below and a
    run SIGKILLed once generation 1 is journaled, then
    ``--resume`` to the unkilled run's records (vectors included), best,
    curve and front; ``--resume`` under other objectives exits 2; a bound
    no member meets (``params:min<=1``) ends in ``least_violation`` with
    an ``objective_degraded`` event; ``--wave-size`` and ``--step-chunk``
    with ``--objectives`` exit 2."""
    import shutil

    import mpi_opt_tpu_torch.cli as cli
    from mpi_opt_tpu_torch.utils.exitcodes import EX_USAGE

    tmp = os.path.join(ROOT, "build", "chip_smoke_mo_cli")
    shutil.rmtree(tmp, ignore_errors=True)

    def argv(name, *extra, spec=MO_SPEC):
        os.makedirs(os.path.join(tmp, name), exist_ok=True)
        return [sys.executable, "-m", "mpi_opt_tpu_torch", "--workload", "digits_mlp", "--algorithm", "pbt",
                "--fused", "--population", str(C8_P), "--generations", str(MO_CLI_GENS),
                "--steps-per-generation", str(C8_STEPS), "--gen-chunk", "1", "--seed", "0", "--device", "cuda",
                "--objectives", spec, "--checkpoint-dir", os.path.join(tmp, name, "ck"),
                "--ledger", os.path.join(tmp, name, "ledger.jsonl"),
                "--metrics-file", os.path.join(tmp, name, "metrics.jsonl"), *extra]

    def journaled(path, n):
        def ready():
            try:
                with open(path) as f:
                    return sum(1 for x in f if '"boundary"' in x) >= n * C8_P
            except OSError:
                return False
        return ready

    def events(name, kind):
        with open(os.path.join(tmp, name, "metrics.jsonl")) as f:
            return [e for e in map(json.loads, f) if e.get("event") == kind]

    out = {"card": smi}
    try:
        # the unkilled, killed and degraded runs are independent: at once
        cut = argv("cut")
        (rc, whole), (rc_k, _, err), (rc_g, degraded) = _together(
            lambda: _run_to_end(argv("whole")),
            lambda: _interrupt(cut, journaled(os.path.join(tmp, "cut", "ledger.jsonl"), 1), signal.SIGKILL,
                               "mo CLI SIGKILL"),
            lambda: _run_to_end(argv("degraded", "--generations", str(C8_GENS),
                                     spec="accuracy:max,params:min<=1")))
        out["unkilled"] = {"exit": rc, "summary": whole}
        if rc != 0 or whole.get("objectives") != ["accuracy", "params"] or not whole.get("pareto"):
            return out, f"mo CLI: the unkilled run exited {rc}: {whole}"
        if len(events("whole", "pareto_front")) != 1 or events("whole", "objective_degraded"):
            return out, "mo CLI: the unkilled run's events are not one pareto_front and no degradation"
        out["killed"] = {"exit": rc_k}
        if rc_k != -signal.SIGKILL:
            return out, f"mo CLI: the killed run exited {rc_k}:\n{err[-3000:]}"
        resumed = _resume(cut, "mo CLI")
        out["resumed"] = resumed
        recs, want = _records(os.path.join(tmp, "cut", "ledger.jsonl")), _records(
            os.path.join(tmp, "whole", "ledger.jsonl"))
        same = recs == want and all(len(r["scores"]) == 2 for r in recs if r["status"] == "ok")
        out["same_records"] = same
        keys = ("best_score", "best_curve", "pareto")
        print(f"mo CLI ({smi}): unkilled {whole.get('trials_per_sec_per_chip')} trials/s (beside the killed "
              f"and degraded runs, not a metric), best "
              f"{whole.get('best_score')}, front {whole['pareto']['front_size']}; SIGKILL exit {rc_k}; resumed "
              f"journal {resumed.get('journal')}, same records {same}")
        if not same or any(resumed.get(k) != whole.get(k) for k in keys):
            return out, "mo CLI: the resumed run's records, best, curve or front differ from the unkilled run's"
        other = subprocess.run([*argv("cut", spec="accuracy:max,latency:min"), "--resume"], cwd=ROOT,
                               capture_output=True, text=True, timeout=300)
        out["other_objectives_resume_exit"] = other.returncode
        if other.returncode != EX_USAGE:
            return out, f"mo CLI: a resume under other objectives exited {other.returncode}"
        ev = events("degraded", "objective_degraded")
        out["degraded"] = {"exit": rc_g, "pareto": degraded.get("pareto"), "events": ev}
        print(f"mo CLI degraded ({smi}): exit {rc_g}, pareto {degraded.get('pareto')}, events {ev}")
        if rc_g != 0 or (degraded.get("pareto") or {}).get("selection") != "least_violation" or len(ev) != 1:
            return out, f"mo CLI: the unmeetable bound gave exit {rc_g}, {degraded.get('pareto')}, events {ev}"
        # usage errors: refused before anything touches the card
        for flag, value in (("--wave-size", "4"), ("--step-chunk", "5")):
            try:
                cli.main([*argv("refused", flag, value)[3:]])
                code = 0
            except SystemExit as e:
                code = e.code
            out[f"refused{flag}"] = code
            if code != EX_USAGE:
                return out, f"mo CLI: --objectives with {flag} exited {code}"
        return out, None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def mo_north_star_phase(gn, get_workload, smi):
    """(c) The north star's width and population: full-width cifar10_cnn,
    CNN_P members, member chunk CNN_CHUNK, NS_GENS x MO_NS_STEPS, one
    generation a launch, scalar and under ``accuracy:max,params:min`` in
    turns (scalar, MO, MO, scalar). Both GN kernels must launch in every
    generation at the scalar run's counts and the plain versions never;
    a finite best, curves in [0, 1], the two MO runs one digest. Then, by
    CUDA events at n=CNN_P: ``pareto_score`` at m=2 and m=3 on the final
    population's objective matrix, ``member_effective_params`` over its
    weights, the whole MO exploit against the scalar one, and the MO
    evaluation against the accuracy alone. Returns (record, GN launches
    of the MO runs, problem)."""
    from mpi_opt_tpu_torch.objectives import ObjectiveSpec, pareto_score
    from mpi_opt_tpu_torch.ops.pbt import PBTConfig, pbt_exploit_explore, pbt_exploit_explore_mo
    from mpi_opt_tpu_torch.train.common import eval_population_objectives, workload_arrays
    from mpi_opt_tpu_torch.train.fused_pbt import fused_pbt
    from mpi_opt_tpu_torch.train.population import PopulationTrainer
    from mpi_opt_tpu_torch.utils import resources

    spec = ObjectiveSpec.parse(MO_SPEC)
    wl = get_workload("cifar10_cnn")
    # set-up (the data on the card, the trainer) before the runs in turns
    trainer, space, _, _, val_x, val_y = workload_arrays(wl, CNN_CHUNK, torch.device("cuda"))
    out = {"card": smi, "population": CNN_P, "member_chunk": CNN_CHUNK, "generations": NS_GENS,
           "steps_per_gen": MO_NS_STEPS, "objectives": MO_SPEC, "runs": []}
    launches = {"gn_fwd": 0, "gn_bwd": 0, "plain": 0}
    by_gen, digests, mo_res = {}, [], None
    for tag in ("scalar", "mo", "mo", "scalar"):
        per_gen, at_boundary = _per_boundary(gn, "pbt launch")
        gn.reset_launches()
        resources.set_boundary_fault_injector(at_boundary)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            res = fused_pbt(wl, population=CNN_P, generations=NS_GENS, steps_per_gen=MO_NS_STEPS, seed=0,
                            member_chunk=CNN_CHUNK, gen_chunk=1, objectives=spec if tag == "mo" else None)
            torch.cuda.synchronize()
        finally:
            resources.set_boundary_fault_injector(None)
        wall = time.perf_counter() - t0
        run_launches = dict(gn.LAUNCHES)
        deltas = [{k: c[k] - (per_gen[i - 1][k] if i else 0) for k in c} for i, c in enumerate(per_gen)]
        rec = {"tag": tag, "wall_s": wall, "member_generations_per_s": CNN_P * NS_GENS / wall,
               "best_score": res["best_score"], "best_curve": res["best_curve"].tolist(),
               "launches": run_launches, "launches_by_generation": deltas}
        if tag == "mo":
            rec.update(front_size=res["pareto"]["front_size"], hypervolume=res["pareto"]["hypervolume"],
                       selection=res["pareto"]["selection"])
        out["runs"].append(rec)
        print(f"mo north star {tag} ({smi}): {json.dumps(rec)}")
        bad = sweep_fault(res, NS_GENS, run_launches, f"the MO north star ({tag})")
        if tag == "mo":
            bad = bad or _front_fault(res, "the MO north star")
        if bad:
            return out, launches, bad
        if len(deltas) != NS_GENS or any(d["gn_fwd"] <= 0 or d["gn_bwd"] <= 0 or d["plain"] for d in deltas):
            return out, launches, f"the MO north star ({tag}): launches by generation {deltas}"
        if by_gen.setdefault(tag, deltas) != deltas:
            return out, launches, f"the MO north star ({tag}): launch counts differ between runs"
        if tag == "mo":
            for k in launches:
                launches[k] += run_launches[k]
            digests.append(_state_digest(res))
            mo_res = res
    rate = lambda t: [r["member_generations_per_s"] for r in out["runs"] if r["tag"] == t]
    out["mo_over_scalar"] = sum(rate("mo")) / sum(rate("scalar"))
    print(f"mo north star ({smi}): scalar {rate('scalar')}, MO {rate('mo')} member-generations/s, "
          f"MO / scalar {out['mo_over_scalar']}")
    if by_gen["mo"] != by_gen["scalar"]:
        return out, launches, f"the MO north star: GN launches {by_gen['mo']} vs the scalar {by_gen['scalar']}"
    if digests[0] != digests[1]:
        return out, launches, "the MO north star: the two MO runs end in different states"
    # the MO pieces alone, by CUDA events, on the final population
    state = mo_res["state"]
    mo3 = eval_population_objectives(trainer, state, val_x, val_y, ("accuracy", "params", "latency"))
    spec3 = ObjectiveSpec.parse("accuracy:max,params:min,latency:min")
    norm2, norm3 = spec.normalize(mo3[:, :2].contiguous()), spec3.normalize(mo3)
    unit = torch.as_tensor(mo_res["unit"], device=val_x.device)
    disc = space.discrete_mask()
    gen = torch.Generator(device=val_x.device).manual_seed(0)
    ms = {
        "pareto_score_m2": _event_ms(lambda: pareto_score(norm2)),
        "pareto_score_m3": _event_ms(lambda: pareto_score(norm3)),
        "member_effective_params": _event_ms(lambda: PopulationTrainer.member_effective_params(state)),
        "exploit_mo": _event_ms(lambda: pbt_exploit_explore_mo(gen, unit, norm2, disc, PBTConfig())),
        "exploit_scalar": _event_ms(lambda: pbt_exploit_explore(gen, unit, mo3[:, 0], disc, PBTConfig())),
        "eval_mo": _event_ms(lambda: eval_population_objectives(trainer, state, val_x, val_y, spec.names),
                             iters=5, warmup=1),
        "eval_accuracy": _event_ms(lambda: trainer.eval_population(state, val_x, val_y), iters=5, warmup=1),
    }
    out["event_ms"] = ms
    print(f"mo pieces at n={CNN_P} ({smi}), ms a call by CUDA events: {json.dumps(ms)}")
    return out, launches, None


def mo_sha_phase(smi):
    """(d) Fused SHA with objectives on fashion_mlp at BENCH_ALL.json
    config 2's shape (SHA_TRIALS trials, SHA_MIN -> SHA_MAX, eta
    SHA_ETA), resident and journaled, ``accuracy:max,latency:min``,
    against the scalar sweep in turns (scalar, MO, MO, scalar): rungs
    [64, 22, 8, 3], every ok record a 2-vector, trials/s."""
    import shutil

    from mpi_opt_tpu_torch import get_workload
    from mpi_opt_tpu_torch.objectives import ObjectiveSpec
    from mpi_opt_tpu_torch.train.common import workload_arrays
    from mpi_opt_tpu_torch.train.fused_asha import fused_sha

    spec = ObjectiveSpec.parse(MO_SHA_SPEC)
    wl = get_workload("fashion_mlp")
    # set-up (the data on the card, the trainer) before the runs in turns
    space = workload_arrays(wl, 0, torch.device("cuda"))[1]
    tmp = os.path.join(ROOT, "build", "chip_smoke_mo_sha")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    out = {"card": smi, "n_trials": SHA_TRIALS, "budgets": [SHA_MIN, SHA_MAX], "eta": SHA_ETA,
           "objectives": MO_SHA_SPEC, "runs": []}
    try:
        for i, tag in enumerate(("scalar", "mo", "mo", "scalar")):
            objectives = spec if tag == "mo" else None
            path = os.path.join(tmp, f"{i}.jsonl")
            led = _mo_ledger(path, space, objectives, "asha", MO_SHA_SPEC)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                res = fused_sha(wl, n_trials=SHA_TRIALS, min_budget=SHA_MIN, max_budget=SHA_MAX, eta=SHA_ETA,
                                seed=0, ledger=led, objectives=objectives)
                torch.cuda.synchronize()
            finally:
                led.close()
            wall = time.perf_counter() - t0
            recs = _records(path)
            vectors = {len(r["scores"]) for r in recs if r["status"] == "ok"} if objectives else set()
            rec = {"tag": tag, "wall_s": wall, "trials_per_s": SHA_TRIALS / wall, "best_score": res["best_score"],
                   "best_trial": res["best_trial"], "rung_sizes": res["rung_sizes"], "records": len(recs),
                   "pareto": res["pareto"]}
            out["runs"].append(rec)
            print(f"mo sha {tag} ({smi}): {json.dumps(rec)}")
            if res["rung_sizes"] != [64, 22, 8, 3] or not math.isfinite(res["best_score"]):
                return out, f"mo sha {tag}: rungs {res['rung_sizes']}, best {res['best_score']}"
            if objectives and (vectors != {2} or any("scores" not in r for r in recs)
                               or _front_fault(res, "mo sha")):
                return out, f"mo sha: vectors {vectors}, pareto {res['pareto']}"
        rate = lambda t: [r["trials_per_s"] for r in out["runs"] if r["tag"] == t]
        out["mo_over_scalar"] = sum(rate("mo")) / sum(rate("scalar"))
        print(f"mo sha ({smi}): scalar {rate('scalar')}, MO {rate('mo')} trials/s, MO / scalar "
              f"{out['mo_over_scalar']}")
        return out, None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the driver path (phase 15): config 3's driver half (PBT, population 32,
# 8 x 100), the ResNet-18 slot pool's population and depth, and the CLI
# drill's pool (a few batches of 16, so the SIGTERM lands mid-sweep)
DRV_PBT_P, DRV_PBT_GENS, DRV_PBT_STEPS = 32, 8, 100
DRV_RN_P, DRV_RN_GENS, DRV_RN_STEPS = 16, 2, 10
DRV_CLI_P = 16


def _driver_records(algo):
    """(trial id, status, score, rung, history) of every trial, brackets
    flattened: what two runs of one search must agree on, bit for bit."""
    trials = ([t for b in algo.brackets for t in b.trials.values()] if hasattr(algo, "brackets")
              else list(algo.trials.values()))
    return [(t.trial_id, t.status.value, t.score, t.rung, [tuple(h) for h in t.history])
            for t in trials]


def _driver_search(make_algo, backend):
    """Run ``run_search`` on a fresh algorithm; (result, algorithm, wall)
    with the card synchronised on both sides of the wall."""
    from mpi_opt_tpu_torch.driver import run_search

    algo = make_algo()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_search(algo, backend)
    torch.cuda.synchronize()
    return res, algo, time.perf_counter() - t0


def _search_fault(res, algo, n_trials: int, what: str) -> str | None:
    best = res.best
    if res.n_trials != n_trials or best is None or not (math.isfinite(best.score) and 0 <= best.score <= 1):
        return f"{what}: {res.n_trials} trials, best {None if best is None else best.score}"
    if not algo.finished():
        return f"{what}: the search did not finish"
    return None


class _ShapeRecorder:
    """Wraps the GN kernels' wrappers for the span of a ``with``: each
    (input shape, groups, relu, dtype) they are called at is recorded."""

    def __init__(self, gn):
        self.gn, self.shapes = gn, set()

    def __enter__(self):
        gn, self.real = self.gn, (self.gn.gn_fwd, self.gn.gn_bwd)

        def fwd(x, gamma, beta, groups, eps, relu):
            self.shapes.add((tuple(x.shape), groups, bool(relu), x.dtype))
            return self.real[0](x, gamma, beta, groups, eps, relu)

        def bwd(x, dy, gamma, beta, mean, rstd, groups, relu):
            self.shapes.add((tuple(x.shape), groups, bool(relu), x.dtype))
            return self.real[1](x, dy, gamma, beta, mean, rstd, groups, relu)

        gn.gn_fwd, gn.gn_bwd = fwd, bwd
        return self

    def __exit__(self, *exc):
        self.gn.gn_fwd, self.gn.gn_bwd = self.real


def _driver_cli(tmp, name, *extra):
    """argv of the CLI's driver path (ASHA at config 2's budgets on
    fashion_mlp, a pool of DRV_CLI_P) with a ledger and snapshots."""
    return [sys.executable, "-m", "mpi_opt_tpu_torch", "--workload", "fashion_mlp", "--algorithm",
            "asha", "--trials", str(SHA_TRIALS), "--min-budget", str(SHA_MIN), "--max-budget",
            str(SHA_MAX), "--eta", str(SHA_ETA), "--population", str(DRV_CLI_P), "--seed", "0",
            "--device", "cuda", "--ledger", os.path.join(tmp, name, "ledger.jsonl"),
            "--checkpoint-dir", os.path.join(tmp, name, "ck"), *extra]


def driver_phase(gn, get_workload, smi):
    """The driver path (``run_search`` over the ``gpu`` slot-pool
    backend), each at full width: (a) config 2's driver half, ASHA on
    fashion_mlp (SHA_TRIALS trials, SHA_MIN -> SHA_MAX, eta SHA_ETA, a
    pool of SHA_TRIALS): a warm-up search, ``reset``, the timed search:
    both bit-identical; (b) config 3's
    driver half, PBT on cifar10_cnn, DRV_PBT_P members x DRV_PBT_GENS x
    DRV_PBT_STEPS; (c) config 4's driver half, TPE on tabular_mlp
    (C4_TRIALS trials, budget C4_BUDGET, a pool of C4_BATCH) after a
    warm-up of 192 trials at seed 1, so the surrogate ran before the timed
    search; (d) PBT on cifar100_resnet18, DRV_RN_P x DRV_RN_GENS x
    DRV_RN_STEPS: both GN kernels launched, the plain versions never, and
    both held against their plain versions at every shape the phase
    launched them at; (e) the CLI without ``--fused`` with a ledger and
    snapshots, SIGTERMed once its first batch is journaled: exit 75, then
    ``--resume`` exit 0 with the unkilled run's records. Returns (record,
    GN launches by path, max abs error of each kernel, problem)."""
    import shutil
    import tempfile

    from mpi_opt_tpu_torch.algorithms import ASHA, PBT, TPE
    from mpi_opt_tpu_torch.backends import get_backend
    from mpi_opt_tpu_torch.utils.exitcodes import EX_TEMPFAIL

    out = {"card": smi}
    launches = {}
    errs = {"gn_fwd": 0.0, "gn_bwd": 0.0}

    # (a) config 2's driver half, twice on one backend
    wl = get_workload("fashion_mlp")
    wl.data()
    be = get_backend("gpu", wl, population=SHA_TRIALS, seed=0)
    make = lambda: ASHA(wl.default_space(), seed=0, max_trials=SHA_TRIALS, min_budget=SHA_MIN,
                        max_budget=SHA_MAX, eta=SHA_ETA)
    gn.reset_launches()
    runs = []
    for tag in ("warm_up", "timed"):
        if runs:
            be.reset()
        res, algo, wall = _driver_search(make, be)
        bad = _search_fault(res, algo, SHA_TRIALS, f"driver asha {tag}")
        if bad:
            return out, launches, errs, bad
        runs.append(_driver_records(algo))
        out[f"asha_{tag}"] = {"wall_s": wall, "trials_per_s": SHA_TRIALS / wall, "evals": res.n_evals,
                              "evals_per_s": res.n_evals / wall, "best_score": res.best.score,
                              "best_trial": res.best.trial_id}
        print(f"driver asha config 2 {tag} ({smi}): {json.dumps(out[f'asha_{tag}'])}")
    launches["driver_fashion_mlp"] = dict(gn.LAUNCHES)
    if runs[1] != runs[0]:
        return out, launches, errs, "driver asha: a reset search did not reproduce the records"
    if launches["driver_fashion_mlp"]["plain"]:
        return out, launches, errs, f"driver asha called the plain GroupNorm: {launches}"
    del be

    # (b) config 3's driver half
    wl = get_workload("cifar10_cnn")
    wl.data()
    be = get_backend("gpu", wl, population=DRV_PBT_P, seed=0)
    torch.cuda.reset_peak_memory_stats()
    gn.reset_launches()
    res, algo, wall = _driver_search(lambda: PBT(wl.default_space(), seed=0, population=DRV_PBT_P,
                                                 generations=DRV_PBT_GENS,
                                                 steps_per_generation=DRV_PBT_STEPS), be)
    launches["driver_smallcnn"] = dict(gn.LAUNCHES)
    n = DRV_PBT_P * DRV_PBT_GENS
    out["pbt_config3"] = {"population": DRV_PBT_P, "generations": DRV_PBT_GENS,
                          "steps_per_generation": DRV_PBT_STEPS, "wall_s": wall,
                          "member_generations_per_s": n / wall, "best_score": res.best.score,
                          "launches": launches["driver_smallcnn"],
                          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"driver pbt config 3 ({smi}): {json.dumps(out['pbt_config3'])}")
    bad = _search_fault(res, algo, n, "driver pbt config 3")
    lc = launches["driver_smallcnn"]
    if bad or not (lc["gn_fwd"] > 0 and lc["gn_bwd"] > 0) or lc["plain"]:
        return out, launches, errs, bad or f"driver pbt config 3: GN launches {lc}"
    del be

    # (c) config 4's driver half, after a warm-up search at seed 1
    wl = get_workload("tabular_mlp")
    wl.data()
    be = get_backend("gpu", wl, population=C4_BATCH, seed=0)
    space = wl.default_space()
    _, _, warm_wall = _driver_search(lambda: TPE(space, seed=1, max_trials=192, budget=C4_BUDGET), be)
    be.reset()
    res, algo, wall = _driver_search(lambda: TPE(space, seed=0, max_trials=C4_TRIALS, budget=C4_BUDGET), be)
    out["tpe_config4"] = {"warm_up_wall_s": warm_wall, "wall_s": wall, "trials_per_s": C4_TRIALS / wall,
                          "best_score": res.best.score, "best_params": {
                              k: v for k, v in res.best.params.items() if not k.startswith("__")}}
    print(f"driver tpe config 4 ({smi}): {json.dumps(out['tpe_config4'])}")
    bad = _search_fault(res, algo, C4_TRIALS, "driver tpe config 4")
    if bad:
        return out, launches, errs, bad
    del be

    # (d) the ResNet-18 slot pool, its GN launch shapes recorded
    wl = get_workload("cifar100_resnet18")
    wl.data()
    be = get_backend("gpu", wl, population=DRV_RN_P, seed=0)
    gn.reset_launches()
    with _ShapeRecorder(gn) as rec:
        res, algo, wall = _driver_search(lambda: PBT(wl.default_space(), seed=0, population=DRV_RN_P,
                                                     generations=DRV_RN_GENS,
                                                     steps_per_generation=DRV_RN_STEPS), be)
    launches["driver_resnet18"] = dict(gn.LAUNCHES)
    n = DRV_RN_P * DRV_RN_GENS
    lr = launches["driver_resnet18"]
    out["pbt_resnet18"] = {"population": DRV_RN_P, "generations": DRV_RN_GENS,
                           "steps_per_generation": DRV_RN_STEPS, "wall_s": wall,
                           "member_steps_per_s": n * DRV_RN_STEPS / wall, "best_score": res.best.score,
                           "launches": lr, "launch_width": be.launch_width,
                           "gn_shapes": sorted([list(s), g, r, str(d)] for s, g, r, d in rec.shapes)}
    print(f"driver pbt resnet18 ({smi}): {json.dumps(out['pbt_resnet18'])}")
    bad = _search_fault(res, algo, n, "driver pbt resnet18")
    if bad or not (lr["gn_fwd"] > 0 and lr["gn_bwd"] > 0) or lr["plain"]:
        return out, launches, errs, bad or f"driver pbt resnet18: GN launches {lr}"
    del be
    torch.cuda.empty_cache()
    check_shapes(gn, rec.shapes, errs, seed=5, empty_cache=True)
    out["pbt_resnet18"]["max_abs_err"] = dict(errs)
    print(f"driver resnet18 GN shapes checked against the plain versions: {len(rec.shapes)} "
          f"(max abs err {json.dumps(errs)})")

    # (e) the CLI drill: unkilled, SIGTERMed after its first batch, resumed
    tmp = tempfile.mkdtemp(prefix="chip_smoke_driver_")
    try:
        rc, want = _run_to_end(_driver_cli(tmp, "unkilled"))
        if rc != 0:
            return out, launches, errs, f"driver cli: the unkilled run exited {rc}"
        argv = _driver_cli(tmp, "killed")
        ledger = os.path.join(tmp, "killed", "ledger.jsonl")

        def first_batch():
            try:
                with open(ledger) as f:
                    return sum(1 for _ in f) > DRV_CLI_P
            except OSError:
                return False

        rc, stdout, _ = _interrupt(argv, first_batch, signal.SIGTERM, "driver cli")
        last = json.loads(stdout.strip().splitlines()[-1])
        if rc != EX_TEMPFAIL or not last.get("preempted"):
            return out, launches, errs, f"driver cli: SIGTERM gave exit {rc}, {last}"
        got = _resume(argv, "driver cli")
        # a driver record's wall_s is the evaluation's own wall: not compared
        strip = lambda recs: [{k: v for k, v in r.items() if k != "wall_s"} for r in recs]
        same = strip(_records(ledger)) == strip(_records(os.path.join(tmp, "unkilled", "ledger.jsonl")))
        out["cli"] = {"preempted_at": last["at"], "trials_done_before": last.get("trials_done"),
                      "same_records": same, "best_score": got["best_score"],
                      "unkilled_best_score": want["best_score"],
                      "trials_per_s_unkilled": want["trials_per_sec_per_chip"]}
        print(f"driver cli ({smi}): {json.dumps(out['cli'])}")
        if not same or got["best_params"] != want["best_params"]:
            return out, launches, errs, "driver cli: the resumed run's records differ from the unkilled run's"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, launches, errs, None


# The warm-start, fsck and report path: (c)'s PBT at phase 9's
# population and chunk, WARM_GENS generations after a WARM_COLD_GENS cold
# run; (d)'s killed sweep DUR_GENS generations, as phase 9's
WARM_P, WARM_CHUNK, WARM_COLD_GENS, WARM_GENS, WARM_STEPS = 32, 32, 2, 3, 20


def _in_process(main, argv):
    """(exit code, stdout lines that are JSON) of ``main(argv)`` run in
    this process with its standard output captured: the CLI, ``report``
    or ``fsck`` as a user calls it, without another process's start."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]


def _flip_tensor_byte(path):
    """Flip one byte in the middle of the largest tensor entry of a
    step's ``sweep.pt`` (a zip archive); returns the entry's name."""
    import struct
    import zipfile

    with zipfile.ZipFile(path) as z:
        info = max((i for i in z.infolist() if "/data/" in i.filename), key=lambda i: i.file_size)
    with open(path, "r+b") as f:
        f.seek(info.header_offset + 26)
        name_len, extra_len = struct.unpack("<HH", f.read(4))
        f.seek(info.header_offset + 30 + name_len + extra_len + info.file_size // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x01]))
    return info.filename


def warm_phase(gn, smi):
    """A sweep's ledger read back, on the card through the CLI. (a) Fused
    TPE at config 4's shape, cold with a ledger, then warm-started from
    it: n_warm, trials/s both ways, the warm run's ledger and history
    exactly its own C4_TRIALS trials, the library call on the same priors
    at the CLI's best. (b) The driver path's TPE warm-started from (a)'s
    fused ledger: its ``warm_start`` event counts that ledger's ok
    records; resumed from its snapshot with ``--warm-start``, it logs
    ``warm_start_skipped``. (c) Fused PBT over full-width cifar10_cnn
    (WARM_P members, chunk WARM_CHUNK, WARM_STEPS steps a generation)
    warm-started from a short cold run's ledger: member 0 starts at the
    prior best, both GN kernels launch and the plain versions never, and
    both are held against their plain versions at every shape the run
    launched them at. (d) The durability config (DUR_P x DUR_GENS x
    DUR_STEPS) SIGKILLed once snapshot 2 is committed: ``fsck`` exits 0
    with the ledger cross-checked; a flipped byte in the newest step's
    ``sweep.pt`` exits 1 naming it, ``--repair`` quarantines it, and
    ``--resume`` ends in the unkilled run's records; ``fsck --deep``
    passes the unkilled run's directory; ``report --json`` and
    ``--validate`` pass every ledger of the phase. Returns (record, GN
    launches of (c)'s warm run, max abs error of each kernel, problem)."""
    import shutil

    from mpi_opt_tpu_torch import cli, get_workload
    from mpi_opt_tpu_torch.ledger.report import report_main
    from mpi_opt_tpu_torch.ledger.warmstart import best_observation, load_observations
    from mpi_opt_tpu_torch.train.fused_tpe import fused_tpe
    from mpi_opt_tpu_torch.utils import integrity

    tmp = os.path.join(ROOT, "build", "chip_smoke_warm")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    at = lambda *p: os.path.join(tmp, *p)
    out = {"card": smi}
    launches = {}
    errs = {"gn_fwd": 0.0, "gn_bwd": 0.0}
    cuda = ["--seed", "0", "--device", "cuda"]
    try:
        # (a) fused TPE cold, then warm from its ledger
        tpe = ["--workload", "tabular_mlp", "--algorithm", "tpe", "--trials", str(C4_TRIALS),
               "--population", str(C4_BATCH), "--budget", str(C4_BUDGET), *cuda]
        rc, cold = _in_process(cli.main, [*tpe, "--fused", "--ledger", at("tpe_cold.jsonl")])
        if rc != 0:
            return out, launches, errs, f"warm (a): the cold TPE run exited {rc}"
        rc, warm = _in_process(cli.main, [*tpe, "--fused", "--ledger", at("tpe_warm.jsonl"),
                                          "--warm-start", at("tpe_cold.jsonl")])
        if rc != 0:
            return out, launches, errs, f"warm (a): the warm TPE run exited {rc}"
        space = get_workload("tabular_mlp").default_space()
        obs, skips = load_observations(at("tpe_cold.jsonl"), space)
        n_warm = sum(math.isfinite(o.score) for o in obs)
        res = fused_tpe(get_workload("tabular_mlp"), n_trials=C4_TRIALS, batch=C4_BATCH,
                        budget=C4_BUDGET, seed=0, warm_obs=obs)
        recs = _records(at("tpe_warm.jsonl"))
        event = next(x for x in warm if x.get("event") == "warm_start")
        out["tpe"] = {"n_warm": res["n_warm"], "observations": event["observations"],
                      "skipped": event["skipped"],
                      "cold": {k: cold[-1][k] for k in ("trials_per_sec_per_chip", "best_score")},
                      "warm": {k: warm[-1][k] for k in ("trials_per_sec_per_chip", "best_score")},
                      "library_warm_best": res["best_score"],
                      "history_rows": int(res["obs_unit"].shape[0])}
        print(f"warm (a) fused TPE config 4 ({smi}): {json.dumps(out['tpe'])}")
        if res["n_warm"] != n_warm or n_warm != C4_TRIALS or res["obs_unit"].shape[0] != C4_TRIALS:
            return out, launches, errs, f"warm (a): n_warm {res['n_warm']} of {n_warm} priors"
        if [r["member"] for r in recs] != list(range(C4_TRIALS)):
            return out, launches, errs, "warm (a): the warm ledger is not its own trials"
        if round(res["best_score"], 6) != warm[-1]["best_score"]:
            return out, launches, errs, "warm (a): the library's warm best differs from the CLI's"

        # (b) the driver path from the fused ledger; resumed, no second ingest
        drv = [*tpe, "--warm-start", at("tpe_cold.jsonl"), "--ledger", at("driver.jsonl"),
               "--checkpoint-dir", at("driver_ck")]
        rc, first = _in_process(cli.main, drv)
        rc2, again = _in_process(cli.main, [*drv, "--resume"])
        n_ok = sum(r["status"] == "ok" for r in _records(at("tpe_cold.jsonl")))
        ev = [x for x in first if x.get("event") == "warm_start"]
        skipped = [x for x in again if x.get("event", "").startswith("warm_start")]
        out["driver"] = {"exit": rc, "observations": ev[0]["observations"] if ev else None,
                         "ok_records": n_ok, "best_score": first[-1].get("best_score"),
                         "trials_per_sec_per_chip": first[-1].get("trials_per_sec_per_chip"),
                         "resume_exit": rc2, "resume_events": [x["event"] for x in skipped]}
        print(f"warm (b) driver TPE from the fused ledger ({smi}): {json.dumps(out['driver'])}")
        if rc != 0 or len(ev) != 1 or ev[0]["observations"] != n_ok:
            return out, launches, errs, f"warm (b): exit {rc}, warm_start events {ev}"
        if rc2 != 0 or [x["event"] for x in skipped] != ["warm_start_skipped"]:
            return out, launches, errs, f"warm (b): the resume exited {rc2} with {skipped}"

        # (c) fused PBT over the full-width SmallCNN, warm from a short cold run
        pbt = ["--workload", "cifar10_cnn", "--algorithm", "pbt", "--fused", "--population",
               str(WARM_P), "--member-chunk", str(WARM_CHUNK), "--steps-per-generation",
               str(WARM_STEPS), "--gen-chunk", "1", "--device", "cuda"]
        rc, _ = _in_process(cli.main, [*pbt, "--generations", str(WARM_COLD_GENS), "--seed", "0",
                                       "--ledger", at("pbt_cold.jsonl")])
        if rc != 0:
            return out, launches, errs, f"warm (c): the cold PBT run exited {rc}"
        gn.reset_launches()
        with _ShapeRecorder(gn) as rec:
            rc, lines = _in_process(cli.main, [*pbt, "--generations", str(WARM_GENS), "--seed", "1",
                                               "--ledger", at("pbt_warm.jsonl"), "--warm-start",
                                               at("pbt_cold.jsonl")])
        launches["warm_smallcnn"] = dict(gn.LAUNCHES)
        lw = launches["warm_smallcnn"]
        cnn_space = get_workload("cifar10_cnn").default_space()
        best = best_observation(load_observations(at("pbt_cold.jsonl"), cnn_space)[0])
        member0 = next(r for r in _records(at("pbt_warm.jsonl"))
                       if r["boundary"] == 0 and r["member"] == 0)
        want = cnn_space.canonical_params(cnn_space.materialize_row(best.unit))
        out["pbt"] = {"exit": rc, "launches": lw, "prior_best_score": best.score,
                      "member0_starts_at_prior_best": member0["params"] == want,
                      "member_generations_per_s": WARM_P * WARM_GENS / lines[-1]["wall_s"]
                      if rc == 0 else None,
                      "best_score": lines[-1].get("best_score") if lines else None}
        print(f"warm (c) fused PBT cifar10_cnn P={WARM_P} ({smi}): {json.dumps(out['pbt'])}; "
              f"gn_fwd {lw['gn_fwd']} launches, gn_bwd {lw['gn_bwd']}")
        if rc != 0 or member0["params"] != want:
            return out, launches, errs, f"warm (c): exit {rc}, member 0 {member0['params']} != {want}"
        if not (lw["gn_fwd"] > 0 and lw["gn_bwd"] > 0) or lw["plain"]:
            return out, launches, errs, f"warm (c): GN launches {lw}"
        if not (lines[-1]["best_score"] is not None and 0 <= lines[-1]["best_score"] <= 1):
            return out, launches, errs, f"warm (c): best {lines[-1]['best_score']}"
        check_shapes(gn, rec.shapes, errs)
        out["pbt"]["gn_shapes"] = sorted([list(s), g, r, str(d)] for s, g, r, d in rec.shapes)
        out["pbt"]["max_abs_err"] = dict(errs)
        print(f"warm (c) GN shapes checked against the plain versions: {len(rec.shapes)} "
              f"(max abs err {json.dumps(errs)})")

        # (d) fsck and report: the durability config killed, audited,
        # corrupted, repaired and resumed
        from mpi_opt_tpu_torch.utils.integrity import fsck_main

        dur = lambda name: _cli(tmp, name)[3:]  # phase 9's CLI arguments, for this process
        rc, whole = _in_process(cli.main, dur("unkilled"))
        if rc != 0:
            return out, launches, errs, f"warm (d): the unkilled run exited {rc}"
        ck = at("killed", "ck")
        rc, _, err = _interrupt(_cli(tmp, "killed"), _committed(ck, 2), signal.SIGKILL, "warm (d)")
        if rc != -signal.SIGKILL:
            return out, launches, errs, f"warm (d): the killed run exited {rc}:\n{err[-3000:]}"
        ledger = at("killed", "ledger.jsonl")
        fsck = {}
        rc, (rep,) = _in_process(fsck_main, [ck, "--ledger", ledger, "--json"])
        fsck["killed"] = {"exit": rc, "steps": [s["step"] for s in rep["steps"]],
                          "ledger": rep["ledger"]}
        if rc != 0 or not rep["ledger"]["cross_checked"] or rep["ledger"]["problems"]:
            return out, launches, errs, f"warm (d): fsck of the killed sweep: {rc}, {rep}"
        newest = integrity._committed_steps(ck)[-1]
        entry = _flip_tensor_byte(os.path.join(ck, str(newest), integrity.SWEEP_FILE))
        rc, (rep,) = _in_process(fsck_main, [ck, "--ledger", ledger, "--json"])
        bad = [(s["step"], s["status"]) for s in rep["steps"] if s["status"] != "verified"]
        fsck["flipped"] = {"step": newest, "entry": entry, "exit": rc, "bad": bad}
        if rc != 1 or bad != [(newest, "corrupt")]:
            return out, launches, errs, f"warm (d): fsck after the flip: {rc}, {bad}"
        rc, (rep,) = _in_process(fsck_main, [ck, "--repair", "--json"])
        fsck["repair"] = {"exit": rc, "quarantined": rep["quarantined"]}
        if rep["quarantined"] != [f"{newest}.corrupt"]:
            return out, launches, errs, f"warm (d): fsck --repair quarantined {rep['quarantined']}"
        rc, resumed = _in_process(cli.main, [*dur("killed"), "--resume"])
        same = _records(ledger) == _records(at("unkilled", "ledger.jsonl"))
        fsck["resume"] = {"exit": rc, "same_records": same,
                          "best_score": resumed[-1].get("best_score") if resumed else None,
                          "unkilled_best_score": whole[-1]["best_score"]}
        if rc != 0 or not same:
            return out, launches, errs, f"warm (d): --resume exited {rc}, same records {same}"
        rc, (rep,) = _in_process(fsck_main, [at("unkilled", "ck"), "--deep", "--json"])
        fsck["deep_unkilled"] = {"exit": rc, "steps": [s["status"] for s in rep["steps"]]}
        if rc != 0:
            return out, launches, errs, f"warm (d): fsck --deep of a clean directory: {rep}"
        ledgers = sorted(os.path.join(r, f) for r, _, fs in os.walk(tmp) for f in fs
                         if f.endswith(".jsonl"))
        rc, (rep,) = _in_process(report_main, [*ledgers, "--json"])
        rc_v, (val,) = _in_process(report_main, ["--validate", "--json", *ledgers])
        fsck["report"] = {"ledgers": len(rep["ledgers"]), "exit": rc, "validate_exit": rc_v,
                          "best": rep["best"]["score"]}
        out["fsck"] = fsck
        print(f"warm (d) fsck and report ({smi}): {json.dumps(fsck)}")
        if rc != 0 or rc_v != 0 or len(rep["ledgers"]) != len(ledgers) or not val["valid"]:
            return out, launches, errs, f"warm (d): report {rc}, --validate {rc_v}: {val}"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, launches, errs, None


# The CPU path (phase 18): BASELINE.json config 1, the chaos drills, the
# per-trial path on the card
C1_TRIALS, C1_BUDGET = 16, 100  # BASELINE.json config 1, as bench_all.py runs it
CHAOS_TRIALS, CHAOS_WORKERS, CHAOS_TIMEOUT = 32, 4, 2
CHAOS_SPEC = "exc=0.1,nan=0.1,hang=0.05,crash=0.05,seed=7"
PREEMPT_SPEC, PREEMPT_TRIALS, PREEMPT_RUNS = "preempt=0.2,seed=3", 16, 10
# the per-trial path: one full-width member, a few steps, a cut validation set
PT_STEPS, PT_TRAIN, PT_VAL, PT_SEED = 2, 512, 128, 5
PT_PARAMS = {"lr": 0.05, "momentum": 0.9, "weight_decay": 1e-4, "flip_prob": 0.25, "shift": 2.0}
# card against CPU: the update (trained minus initial weights) by its
# relative norm, and the accuracy. bf16 activations on two compute
# stacks: on an H100 the SmallCNN reads 0.0096 and ResNet-18 0.080, and
# the fault planted on the card, its learning rate halved, 0.60 and 0.57;
# the limit sits between them, ~2.5x from each
PT_UPDATE_RTOL, PT_ACC_TOL = 0.2, 0.04


def _trial_records(path):
    """A driver ledger's trial records: id, params, status, score, step."""
    keep = ("trial_id", "params", "status", "score", "step")
    return [{k: r[k] for k in keep} for r in _records(path)]


class _WorkerWatch:
    """Wraps ``CPUBackend.evaluate`` for the span of a ``with``: after a
    call, every worker's start-up report (``CPUBackend.worker_report``:
    what the worker knew of CUDA once it had hidden the card) is kept. A
    worker that starts with no visible device can hold no CUDA context
    later: the CUDA driver fixes its device list when it first
    initialises."""

    def __init__(self):
        self.reports = {}

    def __enter__(self):
        from mpi_opt_tpu_torch.backends import cpu

        self.cls, self.real = cpu.CPUBackend, cpu.CPUBackend.evaluate

        def evaluate(backend, trials):
            out = self.real(backend, trials)
            self.reports.update(backend.worker_report())
            return out

        self.cls.evaluate = evaluate
        return self

    def fault(self, what: str) -> str | None:
        if not self.reports:
            return f"{what}: no pool worker was seen"
        clean = {"CUDA_VISIBLE_DEVICES": "", "cuda_initialized": False, "device_count": 0}
        bad = {p: r for p, r in self.reports.items() if r != clean}
        return f"{what}: a cpu worker did not report a hidden card: {bad}" if bad else None

    def __exit__(self, *exc):
        self.cls.evaluate = self.real


def _update_rel(init, got, want) -> float:
    """How far one training update is from another, relative to it:
    ``||(got - init) - (want - init)|| / ||want - init||`` over all the
    weights at once (float64)."""
    num = sum(float((got[k].double() - want[k].double()).square().sum()) for k in want)
    den = sum(float((want[k].double() - init[k].double()).square().sum()) for k in want)
    return math.sqrt(num / den)


class _DrawTape:
    """Records the per-trial path's draws on the card (the member's
    initial weights, each step's batch and augmentation) and its trained
    state; then replays them on the CPU, so the two runs differ only in
    where they compute."""

    def __init__(self):
        self.init = self.state = None
        self.batches, self.augs = [], []

    @contextlib.contextmanager
    def _patched(self, init, batch, augment, evaluate=None):
        from mpi_opt_tpu_torch.train import population as tpop

        real = (tpop.PopulationTrainer.init_population, tpop.draw_batch, tpop.draw_augment,
                tpop.PopulationTrainer.eval_population)
        tpop.PopulationTrainer.init_population = lambda trainer, g, n: init(real[0], trainer, g, n)
        tpop.draw_batch = lambda g, n, b: batch(real[1], g, n, b)
        tpop.draw_augment = lambda g, f, s, b: augment(real[2], g, f, s, b)
        if evaluate is not None:
            tpop.PopulationTrainer.eval_population = (
                lambda trainer, state, *a, **k: evaluate(real[3], trainer, state, *a, **k))
        try:
            yield
        finally:
            (tpop.PopulationTrainer.init_population, tpop.draw_batch, tpop.draw_augment,
             tpop.PopulationTrainer.eval_population) = real

    def record(self):
        def init(real, trainer, g, n):
            st = real(trainer, g, n)
            self.init = {k: v.detach().cpu().clone() for k, v in st.params.items()}
            return st

        def batch(real, g, n, b):
            idx = real(g, n, b)
            self.batches.append(idx.cpu())
            return idx

        def augment(real, g, f, s, b):
            aug = real(g, f, s, b)
            self.augs.append(tuple(a.cpu() for a in aug))
            return aug

        def evaluate(real, trainer, state, *a, **k):
            self.state = {n: v.detach().float().cpu() for n, v in state.params.items()}
            return real(trainer, state, *a, **k)

        return self._patched(init, batch, augment, evaluate)

    def replay(self, device):
        from mpi_opt_tpu_torch.train import population as tpop

        batches = [b.to(device) for b in self.batches]
        augs = [tuple(a.to(device) for a in aug) for aug in self.augs]
        out = {}

        def init(real, trainer, g, n):
            p = {k: v.to(trainer.device, copy=True) for k, v in self.init.items()}
            return tpop.PopState(p, {k: torch.zeros_like(v) for k, v in p.items()},
                                 torch.zeros(n, dtype=torch.int32, device=trainer.device))

        def evaluate(real, trainer, state, *a, **k):
            out["state"] = {n: v.detach().float().cpu() for n, v in state.params.items()}
            return real(trainer, state, *a, **k)

        self.replayed = out
        return self._patched(init, lambda real, g, n, b: batches.pop(0),
                             lambda real, g, f, s, b: augs.pop(0), evaluate)


def cpu_phase(gn, smi):
    """The CPU path on the card's host. (a) BASELINE.json config 1 at full
    size, as ``bench_all.py`` runs it: random search over ``digits``, 16
    trials at budget 100, one worker (inline, in this process), after one
    warm trial outside the window: trials/s and the best. (b) The CLI's
    chaos drill, ``--backend cpu --workload digits`` (stateless, so the
    pool of CHAOS_WORKERS reaps hangs and crashes; quadratic is stateful
    and would evaluate in the CLI's own process, where a crash fault
    kills the CLI and a hang is never reaped) with CHAOS_SPEC and a
    ledger: exit 0, each trial's status what ``fault_for`` predicts from
    the ledger's params (exc/nan failed, hang/crash timeout), the
    summary's counts those, every clean trial's record the clean sweep's,
    and the best the clean sweep's best over the unfaulted trials (the
    clean sweep: the same trials scored in this process, since random
    search does not adapt). (c)
    The preempt drill on the in-parent stateful path (``quadratic``,
    PREEMPT_SPEC): exit 75, then ``--resume`` until exit 0, each drained
    run journaling more; the final ledger holds the chaos-free sweep's
    records; then ``--isolate-stateful --trial-timeout 2 --chaos
    hang=1.0`` reaps the hang as ``timeout`` and ``stalls_detected``
    counts it. (d) The per-trial path on the card: ``evaluate`` of one
    full-width cifar10_cnn and cifar100_resnet18 member (PT_STEPS steps),
    with both GN kernels launched (at population 1: G groups) and the
    plain versions never, and held against the same call on the CPU
    given the card's draws; then the CLI's ``--backend cpu --workload
    fashion_mlp --trials 4 --workers 2`` exits 0. In (b) and (d) no pool
    worker holds a CUDA context: each reports at its start that it sees
    no device and has not initialised CUDA. Returns (record, GN launches of (d), max abs error of each
    kernel, problem)."""
    import shutil

    from mpi_opt_tpu_torch import cli
    from mpi_opt_tpu_torch.algorithms import RandomSearch
    from mpi_opt_tpu_torch.backends.cpu import CPUBackend
    from mpi_opt_tpu_torch.driver import run_search
    from mpi_opt_tpu_torch.workloads import get_workload
    from mpi_opt_tpu_torch.workloads.chaos import parse_chaos_spec

    tmp = os.path.join(ROOT, "build", "chip_smoke_cpu")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    at = lambda *p: os.path.join(tmp, *p)
    out = {"card": smi}
    launches = {}
    errs = {"gn_fwd": 0.0, "gn_bwd": 0.0}
    t_phase = time.perf_counter()
    try:
        # (a) config 1 at full size
        wl = get_workload("digits")
        space = wl.default_space()
        backend = CPUBackend(wl, n_workers=1, seed=0)
        try:
            run_search(RandomSearch(space, seed=1, max_trials=1, budget=C1_BUDGET), backend)
            res = run_search(RandomSearch(space, seed=0, max_trials=C1_TRIALS, budget=C1_BUDGET),
                             backend)
            workers = backend.worker_pids
        finally:
            backend.close()
        out["config1"] = {"n_trials": res.n_trials, "n_failed": res.n_failed,
                          "trials_per_s": res.trials_per_sec_per_chip, "wall_s": res.wall_s,
                          "best_score": res.best.score if res.best else None,
                          "pool_workers": len(workers)}
        print(f"cpu (a) config 1, digits random search 16 x 100, 1 worker ({smi}): "
              f"{json.dumps(out['config1'])}")
        if res.n_trials != C1_TRIALS or res.n_failed or not 0.9 <= out["config1"]["best_score"] <= 1:
            return out, launches, errs, f"cpu (a): config 1 {out['config1']}"

        # (b) the CLI's chaos drill through the pool
        t0 = time.perf_counter()
        base = ["--backend", "cpu", "--workload", "digits", "--algorithm", "random", "--trials",
                str(CHAOS_TRIALS), "--workers", str(CHAOS_WORKERS), "--trial-timeout",
                str(CHAOS_TIMEOUT), "--seed", "0"]
        with _WorkerWatch() as watch:
            rc, lines = _in_process(cli.main, [*base, "--chaos", CHAOS_SPEC, "--ledger",
                                               at("chaos.jsonl")])
        wall = time.perf_counter() - t0
        chaos_wl = get_workload("chaos", inner="digits", **parse_chaos_spec(CHAOS_SPEC))
        recs = _trial_records(at("chaos.jsonl"))
        faults = {r["trial_id"]: chaos_wl.fault_for(r["params"]) for r in recs}
        # the clean sweep: random search does not adapt, so it evaluates
        # the same trials; scored here, in this process
        clean_recs = [{**r, "status": "ok", "score": wl.evaluate(r["params"], C1_BUDGET, 0)}
                      for r in recs]
        # the statuses the JAX package's CLI and CPUBackend give these
        # faults (tests/port/test_torch_chaos.py holds the port to them)
        want = {None: "ok", "exc": "failed", "nan": "failed", "hang": "timeout", "crash": "timeout"}
        kinds = sorted(str(f) for f in faults.values())
        survivors = [r for r in clean_recs if faults[r["trial_id"]] is None]
        best = max(survivors, key=lambda r: r["score"])
        clean_best = max(clean_recs, key=lambda r: r["score"])
        summary = lines[-1] if lines else {}
        out["chaos"] = {
            "exit": rc, "wall_s": wall, "faults": {k: kinds.count(k) for k in set(kinds)},
            "trials_failed": summary.get("trials_failed"),
            "trials_timeout": summary.get("trials_timeout"),
            "best_score": summary.get("best_score"), "clean_best_score": clean_best["score"],
            "clean_best_unfaulted_score": best["score"],
            "clean_best_faulted": faults[clean_best["trial_id"]] is not None,
            "workers": watch.reports}
        print(f"cpu (b) chaos drill, digits, {CHAOS_SPEC}, {CHAOS_WORKERS} workers ({smi}): "
              f"{json.dumps({k: v for k, v in out['chaos'].items() if k != 'workers'})}")
        if rc != 0:
            return out, launches, errs, f"cpu (b): the chaos drill exited {rc}"
        bad = [r["trial_id"] for r in recs if r["status"] != want[faults[r["trial_id"]]]]
        n_failed = sum(f in ("exc", "nan") for f in faults.values())
        n_timeout = sum(f in ("hang", "crash") for f in faults.values())
        if bad or len(recs) != CHAOS_TRIALS:
            return out, launches, errs, f"cpu (b): trials {bad} not as fault_for predicts"
        if (summary["trials_failed"], summary["trials_timeout"]) != (n_failed, n_timeout):
            return out, launches, errs, (f"cpu (b): summary counts {summary} against predicted "
                                         f"{n_failed} failed, {n_timeout} timeout")
        if [r for r in recs if r["status"] == "ok"] != survivors:
            return out, launches, errs, "cpu (b): a clean trial's record differs from the clean sweep's"
        if summary["best_score"] != round(best["score"], 6) or summary["best_params"] != best["params"]:
            return out, launches, errs, f"cpu (b): best {summary['best_score']} against {best}"
        bad = watch.fault("cpu (b)")
        if bad:
            return out, launches, errs, bad

        # (c) the preempt drill on the in-parent stateful path, then a hang
        # reaped on the isolated one
        t0 = time.perf_counter()
        base = ["--backend", "cpu", "--workload", "quadratic", "--trials", str(PREEMPT_TRIALS),
                "--workers", "4", "--seed", "0"]
        rc, _ = _in_process(cli.main, [*base, "--ledger", at("quad_clean.jsonl")])
        argv = [*base, "--chaos", PREEMPT_SPEC, "--ledger", at("quad_chaos.jsonl")]
        rcs, sizes = [], []
        for _ in range(PREEMPT_RUNS):
            r, _ = _in_process(cli.main, argv + (["--resume"] if rcs else []))
            rcs.append(r)
            sizes.append(len(_trial_records(at("quad_chaos.jsonl"))))
            if r != 75:
                break
        same = _trial_records(at("quad_chaos.jsonl")) == _trial_records(at("quad_clean.jsonl"))
        rc_h, hung = _in_process(cli.main, ["--backend", "cpu", "--workload", "quadratic",
                                            "--trials", "1", "--workers", "1", "--isolate-stateful",
                                            "--trial-timeout", str(CHAOS_TIMEOUT), "--chaos",
                                            "hang=1.0"])
        ev = next((x for x in hung if x.get("event") == "summary"), {})
        out["preempt"] = {"clean_exit": rc, "exits": rcs, "records": sizes, "same_records": same,
                          "hang_exit": rc_h, "hang_timeouts": hung[-1].get("trials_timeout")
                          if hung else None, "stalls_detected": ev.get("stalls_detected"),
                          "wall_s": time.perf_counter() - t0}
        print(f"cpu (c) preempt drill, quadratic, {PREEMPT_SPEC} ({smi}): {json.dumps(out['preempt'])}")
        progress = sizes and sizes[0] > 0 and all(sizes[i] > sizes[i - 1] for i in range(1, len(sizes) - 1))
        if rc != 0 or rcs[0] != 75 or rcs[-1] != 0 or set(rcs[:-1]) != {75} or not progress:
            return out, launches, errs, f"cpu (c): exits {rcs}, records {sizes}"
        if not same:
            return out, launches, errs, "cpu (c): the resumed ledger differs from the chaos-free run's"
        if rc_h != 0 or out["preempt"]["hang_timeouts"] != 1 or ev.get("stalls_detected") != 1:
            return out, launches, errs, f"cpu (c): the isolated hang: exit {rc_h}, {hung[-2:]}"

        # (d) the per-trial path on the card, held against the CPU
        out["per_trial"] = {}
        for name in ("cifar10_cnn", "cifar100_resnet18"):
            card = get_workload(name, n_train=PT_TRAIN, n_val=PT_VAL)
            card.data()  # host data is set-up
            tape = _DrawTape()
            gn.reset_launches()
            t0 = time.perf_counter()
            with _ShapeRecorder(gn) as rec, tape.record():
                acc = card.evaluate(PT_PARAMS, PT_STEPS, PT_SEED)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            lw = launches[f"pertrial_{name}"] = dict(gn.LAUNCHES)
            host = get_workload(name, n_train=PT_TRAIN, n_val=PT_VAL)
            host.set_eval_device("cpu")
            t0 = time.perf_counter()
            with tape.replay("cpu"):
                acc_cpu = host.evaluate(PT_PARAMS, PT_STEPS, PT_SEED)
            cpu_s = time.perf_counter() - t0
            want = tape.replayed["state"]
            # the planted fault: the card's run again on the same draws,
            # its learning rate halved; the check must refuse it
            with tape.replay("cuda"):
                card.evaluate({**PT_PARAMS, "lr": PT_PARAMS["lr"] / 2}, PT_STEPS, PT_SEED)
            rel, rel_fault = (_update_rel(tape.init, got, want)
                              for got in (tape.state, tape.replayed["state"]))
            diff = max(float((tape.state[k] - want[k]).abs().max()) for k in want)
            groups = sorted({(shape[-1], g) for shape, g, _, _ in rec.shapes})
            out["per_trial"][name] = {"accuracy": acc, "cpu_accuracy": acc_cpu,
                                      "update_rel_err": rel, "update_rel_err_lr_halved": rel_fault,
                                      "max_param_diff": diff, "card_s": card_s, "cpu_s": cpu_s,
                                      "launches": lw, "gn_shapes": sorted(
                                          [list(s), g, r, str(d)] for s, g, r, d in rec.shapes)}
            print(f"cpu (d) per-trial {name}, 1 member x {PT_STEPS} steps ({smi}): accuracy {acc} "
                  f"(CPU {acc_cpu}), update relative error {rel} (lr halved: {rel_fault}), max "
                  f"|param diff| {diff}, card {card_s:.3f} s, CPU {cpu_s:.3f} s; gn_fwd "
                  f"{lw['gn_fwd']} launches, gn_bwd {lw['gn_bwd']}, (channels, groups) {groups}")
            if not (lw["gn_fwd"] > 0 and lw["gn_bwd"] > 0) or lw["plain"]:
                return out, launches, errs, f"cpu (d): GN launches {lw} on {name}"
            if (abs(acc - acc_cpu) > PT_ACC_TOL or not rel <= PT_UPDATE_RTOL < rel_fault
                    or not 0 <= acc <= 1):
                return out, launches, errs, f"cpu (d): {name} card against CPU: {out['per_trial'][name]}"
            check_shapes(gn, rec.shapes, errs)
        out["per_trial_max_abs_err"] = dict(errs)
        with _WorkerWatch() as watch:
            rc, lines = _in_process(cli.main, ["--backend", "cpu", "--workload", "fashion_mlp",
                                               "--trials", "4", "--workers", "2", "--seed", "0"])
        out["fashion_mlp"] = {"exit": rc, "best_score": lines[-1].get("best_score") if lines else None,
                              "trials_per_sec": lines[-1].get("trials_per_sec_per_chip")
                              if lines else None, "workers": watch.reports}
        print(f"cpu (d) --backend cpu fashion_mlp, 4 trials, 2 workers ({smi}): exit {rc}, best "
              f"{out['fashion_mlp']['best_score']}; workers {json.dumps(watch.reports)}")
        if rc != 0 or not 0 <= (out["fashion_mlp"]["best_score"] or -1) <= 1:
            return out, launches, errs, f"cpu (d): fashion_mlp exit {rc}, {lines[-1:]}"
        bad = watch.fault("cpu (d)")
        if bad:
            return out, launches, errs, bad
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        out["wall_s"] = time.perf_counter() - t_phase
    return out, launches, errs, None


# The measuring tools (phase 19): launch windows of torch.profiler through
# the CLI, and the trace subcommand's --timeline, --diff and --gate. (a)'s
# sweep is the ResNet-18 slice's population at WIN_GENS x WIN_STEPS, one
# generation a launch; (b) profiles configs 2 and 4's driver halves (phase
# 15's shapes) over their steady batches
WIN_GENS, WIN_STEPS, WIN_LAUNCH = 3, 5, 2
WIN_DRIVER = {
    "asha_config2": (["--workload", "fashion_mlp", "--algorithm", "asha", "--trials", str(SHA_TRIALS),
                      "--min-budget", str(SHA_MIN), "--max-budget", str(SHA_MAX), "--eta", str(SHA_ETA),
                      "--population", str(SHA_TRIALS)], "2:4"),
    "tpe_config4": (["--workload", "tabular_mlp", "--algorithm", "tpe", "--trials", str(C4_TRIALS),
                     "--budget", str(C4_BUDGET), "--population", str(C4_BATCH)], "2:4"),
}
# a gate loose enough for two runs of one sweep (a launch may take 4x; the
# host's set-up is not gated: two runs' set-up spans differed 4.2x on the
# card), and one that plants a regression: 99% of the card's bf16 peak
WIN_GATES = {"loose": {"default": 3.0, "ignore": ["setup"], "wall_max_rel_increase": 3.0},
             "planted": {"min_mxu_frac": 0.99}}
WIN_PEAK_TFLOPS = "989"  # H100 SXM, bf16 dense (data sheet)


def _window_trace(directory):
    """(file name, trace-event document) of the one trace a window wrote,
    or (problem, None)."""
    names = os.listdir(directory) if os.path.isdir(directory) else []
    if len(names) != 1:
        return f"{directory}: {len(names)} trace files, not 1: {names}", None
    with open(os.path.join(directory, names[0])) as f:
        return names[0], json.load(f)


def _window_device(doc):
    """Kernels in a window's trace: their count by name, and the device's
    busy share, the union of the kernel intervals over the window's wall
    (the earliest event's start to the latest event's end)."""
    evs = [e for e in doc["traceEvents"] if e.get("ph") == "X" and isinstance(e.get("ts"), (int, float))]
    kern = [e for e in evs if e.get("cat") == "kernel"]
    by_name = {}
    for e in kern:
        by_name[e["name"]] = by_name.get(e["name"], 0) + 1
    lo = min(e["ts"] for e in evs)
    hi = max(e["ts"] + e.get("dur", 0) for e in evs)
    busy, top = 0.0, -math.inf
    for a, b in sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in kern):
        if b > top:
            busy += b - max(a, top)
            top = b
    ranges = [e["name"] for e in evs if e.get("cat") == "user_annotation"]
    return {"kernels": len(kern), "kernel_names": len(by_name), "wall_ms": (hi - lo) / 1e3,
            "busy_ms": busy / 1e3, "busy_share": busy / (hi - lo) if hi > lo else None,
            "ranges": {n: ranges.count(n) for n in sorted(set(ranges))}, "by_name": by_name}


def windows_phase(gn, smi):
    """The measuring tools, through the entry points a user calls. (a) The
    full-width ResNet-18 slice (cifar100_resnet18, population P, WIN_GENS
    x WIN_STEPS, one generation a launch) through the CLI in this process
    with ``--trace --profile-dir --profile-launches 2:2``: one trace lands,
    it holds one ``train`` range, and its ``gn_fwd_kernel`` and
    ``gn_bwd_kernel`` events equal the GN wrappers' launch-counter delta
    over launch 2 (read at the launch ticks), both non-zero, the plain
    versions never; launch 2's wall beside launches 1 and 3. (b) Configs 2
    and 4's driver halves (ASHA on fashion_mlp, TPE on tabular_mlp, phase
    15's shapes) through the CLI with ``--profile-launches 2:4``: each
    window's kernels and device busy share. (c) ``trace --timeline`` of
    (a)'s stream passes ``validate_timeline``. (d) A second traced run of
    (a), unprofiled: ``trace --diff`` of the two exits 0 under a loose
    gate (WIN_GATES: the set-up is not gated) and 1 under
    ``min_mxu_frac: 0.99`` (a planted regression), whose
    violation must be the utilization floor. Returns (record, GN launches
    by path, problem)."""
    import shutil
    import tempfile

    from mpi_opt_tpu_torch import cli
    from mpi_opt_tpu_torch.obs import report, timeline
    from mpi_opt_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    out = {"card": smi}
    launches = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_windows_")
    path = lambda *p: os.path.join(tmp, *p)
    resnet = ["--workload", "cifar100_resnet18", "--algorithm", "pbt", "--fused", "--population", str(P),
              "--generations", str(WIN_GENS), "--steps-per-generation", str(WIN_STEPS), "--gen-chunk", "1",
              "--seed", "0", "--device", "cuda", "--trace"]
    real_tick, at_tick, tick_s = profiling.launch_tick, [], []

    def tick():  # the GN counters at the top of each launch, and what moving the window took
        at_tick.append(dict(gn.LAUNCHES))
        t0 = time.perf_counter()
        real_tick()
        tick_s.append(time.perf_counter() - t0)

    try:
        # (a) one profiled launch of the ResNet-18 slice
        gn.reset_launches()
        profiling.launch_tick = tick
        try:
            t0 = time.perf_counter()
            rc, lines = _in_process(cli.main, [*resnet, "--metrics-file", path("a.jsonl"), "--profile-dir",
                                               path("prof_a"), "--profile-launches", f"{WIN_LAUNCH}:{WIN_LAUNCH}"])
            wall_a = time.perf_counter() - t0
        finally:
            profiling.launch_tick = real_tick
        launches["windows_resnet18"] = dict(gn.LAUNCHES)
        if rc != 0 or len(at_tick) != WIN_GENS:
            return out, launches, f"windows (a): exit {rc}, {len(at_tick)} launch ticks, {lines[-1:]}"
        name, doc = _window_trace(path("prof_a"))
        if doc is None:
            return out, launches, f"windows (a): {name}"
        dev = _window_device(doc)
        want = {k: at_tick[WIN_LAUNCH][k] - at_tick[WIN_LAUNCH - 1][k] for k in ("gn_fwd", "gn_bwd", "plain")}
        got = {k: sum(n for kn, n in dev["by_name"].items() if f"{k}_kernel" in kn) for k in ("gn_fwd", "gn_bwd")}
        spans_a = [r for r in report.load_stream(path("a.jsonl")) if r.get("event") == "span"]
        trains = {r["launch"]: r["dur_s"] for r in spans_a if r["span"] == "train"}
        # the window opens in launch 2's tick and closes (synchronise, stop,
        # export) in launch 3's, outside both train spans
        out["a"] = {"trace": name, "wall_s": wall_a, "gn_in_window": got, "gn_counter_delta": want,
                    "train_ranges": dev["ranges"].get("train", 0), "kernels": dev["kernels"],
                    "kernel_names": dev["kernel_names"], "window_wall_ms": dev["wall_ms"],
                    "busy_share": dev["busy_share"], "launch_train_s": trains,
                    "window_start_s": tick_s[WIN_LAUNCH - 1], "window_stop_s": tick_s[WIN_LAUNCH],
                    "profiled_launch_s": trains[WIN_LAUNCH] + tick_s[WIN_LAUNCH - 1] + tick_s[WIN_LAUNCH],
                    "setup_s": [r["self_s"] for r in spans_a if r["span"] == "setup"]}
        print(f"windows (a) resnet18 P={P} {WIN_GENS}x{WIN_STEPS}, launch {WIN_LAUNCH} profiled ({smi}): "
              f"{json.dumps({k: v for k, v in out['a'].items()})}")
        if dev["kernels"] == 0:
            return out, launches, "windows (a): the window's trace holds no device kernels"
        if got != {k: want[k] for k in got} or not (got["gn_fwd"] > 0 and got["gn_bwd"] > 0) or want["plain"]:
            return out, launches, f"windows (a): GN kernels in the window {got}, counter delta {want}"
        if out["a"]["train_ranges"] != 1:
            return out, launches, f"windows (a): {out['a']['train_ranges']} train ranges, not 1"

        # (b) the driver path's steady batches, configs 2 and 4
        for key, (argv, window) in WIN_DRIVER.items():
            at_tick.clear()
            tick_s.clear()
            profiling.launch_tick = tick
            try:
                t0 = time.perf_counter()
                rc, lines = _in_process(cli.main, [*argv, "--seed", "0", "--device", "cuda", "--profile-dir",
                                                   path(f"prof_{key}"), "--profile-launches", window])
                wall = time.perf_counter() - t0
            finally:
                profiling.launch_tick = real_tick
            name, doc = _window_trace(path(f"prof_{key}"))
            if rc != 0 or doc is None:
                return out, launches, f"windows (b) {key}: exit {rc}, {name}"
            dev = _window_device(doc)
            top = sorted(dev.pop("by_name").items(), key=lambda kv: -kv[1])[:5]
            a, b = (int(x) for x in window.split(":"))
            out[key] = {"window": window, "batches": len(at_tick), "cli_wall_s": wall, **dev,
                        "top_kernels_by_count": top, "trials_per_s": lines[-1].get("trials_per_sec_per_chip")}
            print(f"windows (b) driver {key}, batches {window} of {len(at_tick)} ({smi}): device busy "
                  f"share {dev['busy_share']} of {dev['wall_ms']} ms, {dev['kernels']} kernels; "
                  f"{json.dumps(out[key])}")
            # a batch is one train range; a window past the last batch closes at the end
            if dev["kernels"] == 0 or dev["ranges"].get("train") != min(b, len(at_tick)) - a + 1:
                return out, launches, (f"windows (b) {key}: {dev['kernels']} kernels, ranges {dev['ranges']}, "
                                       f"{len(at_tick)} batches")

        # (c) the timeline of (a)'s stream
        rc, _ = _in_process(report.trace_main, [path("a.jsonl"), "--timeline", path("a.timeline.json")])
        with open(path("a.timeline.json")) as f:
            tl = json.load(f)
        problems = timeline.validate_timeline(tl)
        out["c"] = {"exit": rc, "events": len(tl["traceEvents"]), "problems": problems[:5]}
        print(f"windows (c) timeline of (a): {json.dumps(out['c'])}")
        if rc != 0 or problems:
            return out, launches, f"windows (c): exit {rc}, problems {problems[:5]}"

        # (d) a second traced run, unprofiled; the diff under two gates
        gn.reset_launches()
        t0 = time.perf_counter()
        rc, _ = _in_process(cli.main, [*resnet, "--metrics-file", path("d.jsonl")])
        wall_d = time.perf_counter() - t0
        for k, v in gn.LAUNCHES.items():
            launches["windows_resnet18"][k] += v
        if rc != 0:
            return out, launches, f"windows (d): the second run exited {rc}"
        spans_d = [r for r in report.load_stream(path("d.jsonl")) if r.get("event") == "span"]
        out["d"] = {"wall_s": wall_d, "launch_train_s": {r["launch"]: r["dur_s"] for r in spans_d
                                                         if r["span"] == "train"},
                    "setup_s": [r["self_s"] for r in spans_d if r["span"] == "setup"]}
        for gate, tol in WIN_GATES.items():
            with open(path(f"{gate}.json.tmp"), "w") as f:
                json.dump(tol, f)
            os.replace(path(f"{gate}.json.tmp"), path(f"{gate}.json"))
            rc, rep = _in_process(report.trace_main, [
                "--diff", path("a.jsonl"), path("d.jsonl"), "--json", "--gate", path(f"{gate}.json"),
                "--peak-tflops", WIN_PEAK_TFLOPS])
            gate_out = rep[-1]["gate"] if rep else None
            out["d"][gate] = {"exit": rc, "gate": gate_out,
                              "roofline": rep[-1]["roofline"] if rep else None}
            print(f"windows (d) trace --diff (a) (d), {gate} gate: exit {rc}, {json.dumps(out['d'][gate])}")
            floor = gate_out is not None and any("below the 99% floor" in v for v in gate_out["violations"])
            if (gate, rc) not in (("loose", 0), ("planted", 1)) or (gate == "planted" and not floor):
                return out, launches, f"windows (d): the {gate} gate exited {rc}: {gate_out}"
        print(f"windows profiled launch ({smi}): launch {WIN_LAUNCH} profiled "
              f"{out['a']['profiled_launch_s']} s (train {trains[WIN_LAUNCH]} s, window start "
              f"{out['a']['window_start_s']} s, stop and export {out['a']['window_stop_s']} s); "
              f"unprofiled: run (a) {json.dumps(trains)}, run (d) {json.dumps(out['d']['launch_train_s'])}")
    finally:
        profiling.launch_tick = real_tick
        shutil.rmtree(tmp, ignore_errors=True)
        out["wall_s"] = time.perf_counter() - t_phase
    return out, launches, None


# the multi-process path: the ResNet-18 slice at phase 18's depth over 2
# ranks on the one card (gloo: NCCL refuses two ranks on one device)
MESH_P, MESH_GENS, MESH_STEPS, MESH_RANKS = 16, 3, 5, 2
MESH_TOL = 0.02  # the data axis against one process (tests/test_parallel.py's)
# the data axis's update (the trained minus the initial weights of all 16
# members, before the exploit) against one process's, by relative norm: on
# an H100 it reads 0.035, and the planted fault (one process on the first
# half of every batch: rank 0 with its gradient average dropped) 1.63; the
# limit sits between them, 5.7x and 8.2x from each
MESH_UPDATE_RTOL = 0.2
# a rank of the port's CLI that records its GN wrappers' launch counts and
# launch shapes and writes them to $MESH_COUNTS_DIR/rank<R>.gn.json at exit
# (its counts start at 0: a fresh process, reset again before the CLI runs).
# With $MESH_PRE_EXPLOIT set it also records its final state's digest, and
# rank 0 saves its weights as the first exploit finds them to that path.
_MESH_RANK = """
import atexit, json, os, runpy, sys
from mpi_opt_tpu_torch.ops import group_norm as gn
argv = sys.argv[1:]
rank = argv[argv.index("--process-id") + 1]
final, pre = {}, os.environ.get("MESH_PRE_EXPLOIT")
if pre:
    import torch
    from mpi_opt_tpu_torch.train import fused_pbt as fp
    from mpi_opt_tpu_torch.train import population as tpop
    from mpi_opt_tpu_torch.utils import integrity
    real_gm, real_fp = tpop.PopulationTrainer.gather_members, fp.fused_pbt
    def gather_members(self, state, src_idx):
        if rank == "0" and not os.path.exists(pre):
            torch.save({k: v.detach().cpu() for k, v in state.params.items()}, pre)
        return real_gm(self, state, src_idx)
    def fused_pbt(*a, **k):
        res = real_fp(*a, **k)
        st = res["state"]
        final["digest"] = integrity.tree_digest({"params": st.params, "momentum": st.momentum,
                                                 "step": st.step})
        return res
    tpop.PopulationTrainer.gather_members, fp.fused_pbt = gather_members, fused_pbt
shapes, real = set(), (gn.gn_fwd, gn.gn_bwd)
def fwd(x, gamma, beta, groups, eps, relu):
    shapes.add((tuple(x.shape), groups, bool(relu), str(x.dtype)))
    return real[0](x, gamma, beta, groups, eps, relu)
def bwd(x, dy, gamma, beta, mean, rstd, groups, relu):
    shapes.add((tuple(x.shape), groups, bool(relu), str(x.dtype)))
    return real[1](x, dy, gamma, beta, mean, rstd, groups, relu)
gn.gn_fwd, gn.gn_bwd = fwd, bwd
gn.reset_launches()
def dump():
    path = os.path.join(os.environ["MESH_COUNTS_DIR"], f"rank{rank}.gn.json")
    with open(path + ".tmp", "w") as f:
        json.dump({"launches": dict(gn.LAUNCHES), "shapes": sorted(list(s) for s in shapes),
                   "digest": final.get("digest")}, f)
    os.replace(path + ".tmp", path)
atexit.register(dump)
sys.argv = ["mpi_opt_tpu_torch", *argv]
runpy.run_module("mpi_opt_tpu_torch", run_name="__main__", alter_sys=True)
"""
# the port's launch supervisor, each rank it spawns run through _MESH_RANK
_MESH_SUPERVISOR = """
import sys
from mpi_opt_tpu_torch import launch
real = launch.subprocess.Popen
def popen(argv, **kw):
    if list(argv[1:3]) == ["-m", "mpi_opt_tpu_torch"]:
        argv = [argv[0], "-c", sys.argv[1], *argv[3:]]
    return real(argv, **kw)
launch.subprocess.Popen = popen
sys.exit(launch.main(sys.argv[2:]))
"""


def _mesh_start(tmp, name, mesh_args, *extra, launcher=(), env=None):
    """Start the slice through ``python -m mpi_opt_tpu_torch.launch
    --n-proc 2`` (each rank counting its GN launches; ``env`` adds to
    their environment); ``_mesh_wait`` collects it. The supervisor's
    output goes to files in its log dir."""
    logs = os.path.join(tmp, name)
    os.makedirs(logs)
    argv = [sys.executable, "-c", _MESH_SUPERVISOR, _MESH_RANK, "--n-proc", str(MESH_RANKS),
            "--log-dir", logs, "--term-grace", "2", "--restart-backoff", "0", *launcher, "--",
            "--workload", "cifar100_resnet18", "--algorithm", "pbt", "--fused", "--population",
            str(MESH_P), "--generations", str(MESH_GENS), "--steps-per-generation", str(MESH_STEPS),
            "--gen-chunk", "1", "--seed", "0", "--device", "cuda", "--coord-timeout", "120",
            *mesh_args, *extra]
    out, err = open(os.path.join(logs, "supervisor.out"), "w"), open(os.path.join(logs, "supervisor.err"), "w")
    proc = subprocess.Popen(argv, cwd=ROOT, env=dict(os.environ, MESH_COUNTS_DIR=logs, **(env or {})), text=True,
                            stdout=out, stderr=err)
    return name, logs, proc, (out, err), time.perf_counter()


def _mesh_wait_all(runs: dict) -> dict:
    """``_mesh_wait`` of every run, each timed to its own end."""
    ends, deadline = {}, time.perf_counter() + 300
    while len(ends) < len(runs) and time.perf_counter() < deadline:
        for k, run in runs.items():
            if k not in ends and run[2].poll() is not None:
                ends[k] = time.perf_counter()
        time.sleep(0.1)
    return {k: _mesh_wait(run, ends.get(k)) for k, run in runs.items()}


def _mesh_wait(run, end=None):
    """(exit code, supervisor events and relayed summary, the last
    attempt's per-rank counts, wall) of a ``_mesh_start``ed run."""
    name, logs, proc, files, t0 = run
    try:
        rc = proc.wait(timeout=1)
    except subprocess.TimeoutExpired:
        rc = None  # past _mesh_wait_all's deadline
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for f in files:
            f.close()
    wall = (end or time.perf_counter()) - t0
    with open(os.path.join(logs, "supervisor.out")) as f:
        lines = [json.loads(x) for x in f if x.startswith("{")]
    counts = []
    for r in range(MESH_RANKS):
        path = os.path.join(logs, f"rank{r}.gn.json")
        counts.append(json.load(open(path)) if os.path.exists(path) else None)
    if rc != 0:
        tails = {f: open(os.path.join(logs, f)).read()[-1500:] for f in ("supervisor.err", "rank0.err", "rank1.err")
                 if os.path.exists(os.path.join(logs, f))}
        print(f"mesh {name}: supervisor exit {rc}; {json.dumps(tails)}")
    return rc, lines, counts, wall


def _final_digest(ckpt) -> str | None:
    """The state digest of a checkpoint directory's newest step."""
    from mpi_opt_tpu_torch.utils import integrity

    steps = integrity._committed_steps(ckpt)
    if not steps:
        return None
    _, _, sweep = integrity.read_step(ckpt, steps[-1])
    return integrity.tree_digest(sweep["state"])


def _per_generation(records):
    """(best, mean) of each boundary's member scores in a ledger."""
    by = {}
    for r in records:
        by.setdefault(r["boundary"], []).append(r["score"])
    return ([max(v) for _, v in sorted(by.items())],
            [sum(v) / len(v) for _, v in sorted(by.items())])


@contextlib.contextmanager
def _pbt_states(halve_batch=False):
    """Within: the first fused PBT generation's weights kept on the host,
    ``{"init": ..., "trained": ...}``: the initial weights
    (``init_population``) and the trained ones as the exploit finds them
    (``gather_members``'s input). With ``halve_batch`` every step trains
    on the first half of its batch alone: rank 0 of a data split whose
    gradient average was dropped."""
    from mpi_opt_tpu_torch.train import population as tpop

    cls, got = tpop.PopulationTrainer, {}
    real = (cls.init_population, cls.gather_members, cls._pop_update)
    host = lambda st: {k: v.detach().cpu().clone() for k, v in st.params.items()}

    def init_population(self, generator, n):
        st = real[0](self, generator, n)
        got.setdefault("init", host(st))
        return st

    def gather_members(self, state, src_idx):
        got.setdefault("trained", host(state))
        return real[1](self, state, src_idx)

    def pop_update(self, state, hp, aug, bx, by, active=None):
        k = bx.shape[0] // 2
        aug = None if aug is None else (aug[0][:, :k], aug[1], aug[2])
        return real[2](self, state, hp, aug, bx[:k], by[:k], active)

    cls.init_population, cls.gather_members = init_population, gather_members
    if halve_batch:
        cls._pop_update = pop_update
    try:
        yield got
    finally:
        cls.init_population, cls.gather_members, cls._pop_update = real


def _rank_step_times(gn, members: int, batch: int, flush, bandwidth):
    """One rank's population step of GN at its shard shape (``members``
    folded into channels, ``batch`` rows), summed over the ResNet-18
    sites as ``kernel_phase`` sums the slice's: ms of kernel, plain
    version, library call and the bytes bound."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    tot = {k: dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"), 0.0) for k in ("gn_fwd", "gn_bwd")}
    for s, c, n_relu, n_plain in SHAPES:
        cc, g = members * c, members * GROUPS
        x = torch.randn((batch, s, cc), generator=gen, device="cuda").to(_BF16)
        dy = torch.randn((batch, s, cc), generator=gen, device="cuda").to(_BF16)
        gamma = 1.0 + 0.5 * torch.randn(cc, generator=gen, device="cuda")
        beta = 0.1 * torch.randn(cc, generator=gen, device="cuda")
        for relu, n_sites in ((True, n_relu), (False, n_plain)):
            row = time_shape(gn, x, dy, gamma, beta, g, relu, None, flush, bandwidth)
            for k, kk in (("gn_fwd", "fwd"), ("gn_bwd", "bwd")):
                tot[k]["ms"] += n_sites * row[kk + "_ms"]
                tot[k]["plain_ms"] += n_sites * row[kk + "_plain_ms"]
                tot[k]["library_ms"] += n_sites * row[kk + "_lib_ms"]
                tot[k]["bound_ms"] += n_sites * row[kk + "_bound_ms"]
        del x, dy
    torch.cuda.empty_cache()
    return tot


def mesh_phase(gn, smi, bandwidth):
    """Multi-process SPMD on the card, through the entry points a user
    calls: ``python -m mpi_opt_tpu_torch.launch --n-proc 2`` over the
    full-width ResNet-18 slice (cifar100_resnet18, MESH_P members,
    MESH_GENS x MESH_STEPS, one generation a launch), each rank on the
    card and counting its GN launches. (a) ``--n-pop 2``, with a ledger
    and a final snapshot: each rank trains 8 members through both GN
    kernels (the plain versions never), and the ledger and the final
    snapshot's state digest equal a one-process run in this process at
    ``--member-chunk 8`` (the ranks' launch width) bit for bit. (b)
    ``--n-pop 1 --n-data 2`` (each rank half of every batch, gradients
    averaged over gloo), one generation: its best and mean score within
    MESH_TOL of a one-process run's, both ranks' final states of one
    digest, and its update (the weights rank 0 holds when the exploit
    comes, minus the initial ones) within MESH_UPDATE_RTOL of the
    one-process run's by relative norm; the same run in this process on
    the first half of every batch alone (rank 0 with its gradient
    average dropped) must fall outside it. (c) (a) with snapshots every
    2 launches, ``--rank-kill rank=1,at=2`` and ``--retries 1``: rank 1
    is SIGKILLed at generation 2's boundary, the supervisor relaunches
    both ranks with ``--resume`` and exits 0, and the ledger and digest
    equal (a)'s. The three supervisors run at once, their six ranks on
    the card, and the one-process runs in this process after them.
    Then every GN shape a rank launched is held against the plain
    versions, and a rank's GN time a population step timed at its shard
    shape, alone on the card. Returns (record, GN launches by path, max
    abs error of each kernel, problem)."""
    import gc
    import shutil
    import tempfile

    from mpi_opt_tpu_torch import cli

    t_phase = time.perf_counter()
    # six ranks of ~10 GB share the card: give back what earlier phases
    # left in this process's allocator cache first
    gc.collect()
    torch.cuda.empty_cache()
    out = {"card": smi, "this_process_gb": {"allocated": torch.cuda.memory_allocated() / 1e9,
                                            "reserved": torch.cuda.memory_reserved() / 1e9},
           "free_gb": torch.cuda.mem_get_info()[0] / 1e9}
    launches = {}
    errs = {"gn_fwd": 0.0, "gn_bwd": 0.0}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    path = lambda *p: os.path.join(tmp, *p)
    marker = path("killed.marker")
    runs = {}
    pbt = lambda gens, *extra: [
        "--workload", "cifar100_resnet18", "--algorithm", "pbt", "--fused", "--population", str(MESH_P),
        "--generations", str(gens), "--steps-per-generation", str(MESH_STEPS), "--gen-chunk", "1",
        "--seed", "0", "--device", "cuda", *extra]
    try:
        runs["a"] = _mesh_start(tmp, "a", ["--n-pop", "2"], "--ledger", path("a.jsonl"),
                                "--checkpoint-dir", path("ck_a"), "--checkpoint-every", str(MESH_GENS))
        runs["c"] = _mesh_start(tmp, "c", ["--n-pop", "2"], "--ledger", path("c.jsonl"), "--checkpoint-dir",
                                path("ck_c"), "--checkpoint-every", "2", "--rank-kill",
                                f"rank=1,at=2,marker={marker}", launcher=("--retries", "1"))
        runs["b"] = _mesh_start(tmp, "b", ["--n-pop", "1", "--n-data", "2", "--generations", "1"],
                                "--ledger", path("b.jsonl"), env={"MESH_PRE_EXPLOIT": path("b_trained.pt")})
        done = _mesh_wait_all(runs)
        runs.clear()
        out["walls_s"] = {k: d[3] for k, d in done.items()}
        # then one process at the ranks' launch width, in this process
        gn.reset_launches()
        t0 = time.perf_counter()
        rc_ref, ref_lines = _in_process(cli.main, pbt(
            MESH_GENS, "--member-chunk", str(MESH_P // 2), "--ledger", path("ref.jsonl"),
            "--checkpoint-dir", path("ck_ref"), "--checkpoint-every", str(MESH_GENS)))
        ref_wall = time.perf_counter() - t0
        launches["mesh_reference_resnet18"] = dict(gn.LAUNCHES)
        print(f"mesh: supervisors (a) (b) (c) at once, {json.dumps(out['walls_s'])} s; then one process "
              f"at --member-chunk {MESH_P // 2}, exit {rc_ref}, {ref_wall} s ({smi})")
        recs_ref, digest_ref = _records(path("ref.jsonl")), _final_digest(path("ck_ref"))
        out["reference"] = {"exit": rc_ref, "wall_s": ref_wall, "summary": ref_lines[-1] if ref_lines else None,
                            "digest": digest_ref, "launches": launches["mesh_reference_resnet18"]}
        if rc_ref != 0 or not recs_ref:
            return out, launches, errs, f"mesh: the one-process run exited {rc_ref}"

        # (a) pop-sharded: bit-equal to one process at the same width
        rc, lines, counts, wall = done["a"]
        digest_a, recs_a = _final_digest(path("ck_a")), _records(path("a.jsonl"))
        out["a"] = {"exit": rc, "wall_s": wall, "summary": lines[-2] if len(lines) > 1 else None,
                    "events": [e["event"] for e in lines if "event" in e], "counts": counts,
                    "digest": digest_a, "records_equal": recs_a == recs_ref}
        print(f"mesh (a) 2 ranks --n-pop 2 ({smi}): {json.dumps(out['a'])}")
        if rc != 0 or None in counts:
            return out, launches, errs, f"mesh (a): exit {rc}, counts {counts}"
        launches["mesh_resnet18"] = {k: sum(c["launches"][k] for c in counts) for k in gn.LAUNCHES}
        for r, c in enumerate(counts):
            if not (c["launches"]["gn_fwd"] > 0 and c["launches"]["gn_bwd"] > 0) or c["launches"]["plain"]:
                return out, launches, errs, f"mesh (a): rank {r} GN launches {c['launches']}"
        if digest_a is None or digest_a != digest_ref or recs_a != recs_ref:
            return out, launches, errs, "mesh (a): the 2-rank run differs from one process at the same width"

        # (b) the data axis: each rank half of every batch, held by its
        # update against one process's and against the planted fault
        rc, lines, counts_b, wall = done["b"]
        out["b"] = {"exit": rc, "wall_s": wall, "summary": lines[-2] if len(lines) > 1 else None,
                    "counts": counts_b}
        if rc != 0 or None in counts_b:
            return out, launches, errs, f"mesh (b): exit {rc}, counts {counts_b}"
        launches["mesh_data_resnet18"] = {k: sum(c["launches"][k] for c in counts_b) for k in gn.LAUNCHES}
        for r, c in enumerate(counts_b):
            if not (c["launches"]["gn_fwd"] > 0 and c["launches"]["gn_bwd"] > 0) or c["launches"]["plain"]:
                return out, launches, errs, f"mesh (b): rank {r} GN launches {c['launches']}"
        t0 = time.perf_counter()
        with _pbt_states() as ref_b:
            rc_rb, _ = _in_process(cli.main, pbt(1, "--ledger", path("ref_b.jsonl")))
        with _pbt_states(halve_batch=True) as fault_b:
            rc_fb, _ = _in_process(cli.main, pbt(1))
        out["b"]["reference_walls_s"] = time.perf_counter() - t0
        if rc_rb != 0 or rc_fb != 0 or "trained" not in ref_b or "trained" not in fault_b:
            return out, launches, errs, f"mesh (b): the one-process runs exited {rc_rb}, {rc_fb}"
        best_b, mean_b = _per_generation(_records(path("b.jsonl")))
        best_r, mean_r = _per_generation(_records(path("ref_b.jsonl")))
        gap = max(abs(a - b) for a, b in zip(best_b + mean_b, best_r + mean_r))
        card = lambda tree: {k: v.cuda() for k, v in tree.items()}
        init, want = card(ref_b["init"]), card(ref_b["trained"])
        rel = _update_rel(init, card(torch.load(path("b_trained.pt"))), want)
        rel_fault = _update_rel(init, card(fault_b["trained"]), want)
        del init, want, ref_b, fault_b
        torch.cuda.empty_cache()
        digests = [c["digest"] for c in counts_b]
        out["b"].update(best=best_b, mean=mean_b, reference_best=best_r, reference_mean=mean_r, max_gap=gap,
                        update_rel_err=rel, update_rel_err_average_dropped=rel_fault, digests=digests)
        print(f"mesh (b) 2 ranks --n-data 2 ({smi}): {wall} s, best {best_b} mean {mean_b} against one "
              f"process's {best_r} {mean_r}: max gap {gap} (limit {MESH_TOL}); update relative error "
              f"{rel} (gradient average dropped: {rel_fault}; limit {MESH_UPDATE_RTOL}); rank digests {digests}")
        if len(best_b) != 1 or gap > MESH_TOL:
            return out, launches, errs, f"mesh (b): the data axis is {gap} from one process"
        if not rel <= MESH_UPDATE_RTOL < rel_fault:
            return out, launches, errs, f"mesh (b): update relative error {rel}, the planted fault's {rel_fault}"
        if None in digests or len(set(digests)) != 1:
            return out, launches, errs, f"mesh (b): the data ranks end apart: {digests}"

        # (c) rank 1 SIGKILLed at generation 2's boundary, relaunched, resumed
        rc, lines, counts_c, wall = done["c"]
        events = [e for e in lines if "event" in e]
        recs_c, digest_c = _records(path("c.jsonl")), _final_digest(path("ck_c"))
        out["c"] = {"exit": rc, "wall_s": wall, "events": events, "digest": digest_c, "counts": counts_c,
                    "records_equal": recs_c == recs_a, "killed": os.path.exists(marker)}
        print(f"mesh (c) --rank-kill rank=1,at=2 ({smi}): {json.dumps(out['c'])}")
        kinds = [e["event"] for e in events]
        if (rc != 0 or kinds != ["launch", "restart", "launch", "done"] or not out["c"]["killed"]
                or recs_c != recs_a or digest_c != digest_a):
            return out, launches, errs, f"mesh (c): exit {rc}, events {kinds}, records equal {recs_c == recs_a}"

        # every GN shape a rank launched against the plain versions, then
        # each rank's GN time a population step at its shard shape
        gen = torch.Generator(device="cuda")
        gen.manual_seed(7)
        shapes = {(tuple(s[0]), s[1], s[2], s[3]) for c in counts + counts_b for s in c["shapes"]}
        for shape, g, relu, dtype in sorted(shapes, key=str):
            dt = {"torch.bfloat16": _BF16, "torch.float32": _F32}[dtype]
            x = torch.randn(shape, generator=gen, device="cuda").to(dt)
            dy = torch.randn(shape, generator=gen, device="cuda").to(dt)
            ch = shape[-1]
            gamma = 1.0 + 0.5 * torch.randn(ch, generator=gen, device="cuda")
            beta = 0.1 * torch.randn(ch, generator=gen, device="cuda")
            e = check_shape(gn, x, dy, gamma, beta, g, relu, "bf16" if dt == _BF16 else "f32", None)
            for k in errs:
                errs[k] = max(errs[k], e[k])
            del x, dy
        torch.cuda.empty_cache()
        out["gn_shapes"] = sorted([list(s), g, r, d] for s, g, r, d in shapes)
        out["max_abs_err"] = dict(errs)
        flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
        out["rank_step_pop"] = _rank_step_times(gn, MESH_P // 2, BATCH, flush, bandwidth)
        out["rank_step_data"] = _rank_step_times(gn, MESH_P, BATCH // 2, flush, bandwidth)
        print(f"mesh GN shapes checked against the plain versions: {len(shapes)} (max abs err "
              f"{json.dumps(errs)}); a rank's GN ms a population step ({smi}): pop-sharded "
              f"{json.dumps(out['rank_step_pop'])}, data-split {json.dumps(out['rank_step_data'])}")
    finally:
        for run in runs.values():  # a phase that failed early: stop what it started
            if run[2].poll() is None:
                run[2].kill()
                run[2].wait()
        shutil.rmtree(tmp, ignore_errors=True)
        out["wall_s"] = time.perf_counter() - t_phase
        print(f"mesh phase wall: {out['wall_s']} s")
    return out, launches, errs, None


# phase 21, the sweep service: T1 is BASELINE.json config 3 (fused PBT,
# cifar10_cnn, 32 members x 4 generations x 20 steps, one generation a
# launch), T2 the same at another seed (the same program key), T3 fused
# PBT on the full-width ResNet-18 at 16 members in chunks of 8, 2 x 10
SVC_T1 = ["--workload", "cifar10_cnn", "--algorithm", "pbt", "--fused", "--population", "32",
          "--generations", "4", "--steps-per-generation", "20", "--gen-chunk", "1", "--seed", "0"]
SVC_T2 = [*SVC_T1[:-1], "1"]
SVC_T3 = ["--workload", "cifar100_resnet18", "--algorithm", "pbt", "--fused", "--population", "16",
          "--member-chunk", "8", "--generations", "2", "--steps-per-generation", "10",
          "--gen-chunk", "1", "--seed", "0"]
# config 2's fused SHA on fashion_mlp: the fleet drill's tenants
SVC_SHA = ["--workload", "fashion_mlp", "--algorithm", "asha", "--fused", "--trials", str(SHA_TRIALS),
           "--min-budget", str(SHA_MIN), "--max-budget", str(SHA_MAX), "--eta", str(SHA_ETA)]
# config 4's fused TPE (phase 16 (a)'s cold run), for the corpus
SVC_C4 = ["--workload", "tabular_mlp", "--algorithm", "tpe", "--fused", "--trials", str(C4_TRIALS),
          "--population", str(C4_BATCH), "--budget", str(C4_BUDGET), "--seed", "0", "--device", "cuda"]

# a fleet server (id "a") that SIGKILLs itself at the first boundary of
# its first slice, once its peer (id "b") has registered on the spool
_SERVE_KILL = """
import os, signal, sys, time
from mpi_opt_tpu_torch.service.scheduler import SweepService
sd = sys.argv[1]
def die(t, stage, n):
    end = time.monotonic() + 120
    while not os.path.exists(os.path.join(sd, "servers", "b.json")) and time.monotonic() < end:
        time.sleep(0.05)
    os.kill(os.getpid(), signal.SIGKILL)
sys.exit(SweepService(sd, server_id="a", slice_boundaries=1, drain_on_empty=True, poll_seconds=0.05,
                      on_boundary=die).serve())
"""


def _spool_client(*argv):
    """(exit code, stdout) of a spool client, run as a user runs it."""
    proc = subprocess.run([sys.executable, "-m", "mpi_opt_tpu_torch", *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    return proc.returncode, proc.stdout


def _serve(sd, log, *extra, script=None):
    """Start a server on the spool ``sd`` (``script``: a launcher given
    the spool), its output to ``log``; returns (process, log file)."""
    f = open(log, "w")
    argv = ([sys.executable, "-c", script, sd] if script else
            [sys.executable, "-m", "mpi_opt_tpu_torch", "serve", "--state-dir", sd, "--poll-seconds",
             "0.1", *extra])
    return subprocess.Popen(argv, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT, text=True), f


def _wait_until(ready, procs, what: str, timeout: float = 300):
    """Poll ``ready()``; fails if a server in ``procs`` ends first or the
    deadline passes."""
    end = time.monotonic() + timeout
    while not ready():
        dead = [p.returncode for p in procs if p.poll() is not None]
        if dead or time.monotonic() > end:
            raise AssertionError(f"{what}: servers ended ({dead}) or timed out")
        time.sleep(0.05)


def _stop(servers):
    """Kill and reap whatever server is still running; close the logs."""
    for proc, f in servers:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        f.close()


def _events(sd, name):
    with open(os.path.join(sd, "server-metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r.get("event") == name]


def _solo_ref(cli, tmp, name, argv):
    """A solo CLI run of ``argv`` in this process, with a ledger and
    snapshots: (its records, its final state digest)."""
    d = os.path.join(tmp, name)
    rc, _ = _in_process(cli.main, [*argv, "--device", "cuda", "--ledger", os.path.join(d, "l.jsonl"),
                                   "--checkpoint-dir", os.path.join(d, "ck")])
    if rc != 0:
        raise AssertionError(f"the solo run {name} exited {rc}")
    return _records(os.path.join(d, "l.jsonl")), _final_digest(os.path.join(d, "ck"))


def service_phase(gn, smi):
    """The sweep service (``python -m mpi_opt_tpu_torch serve``) on the
    card. (a) Three tenants (SVC_T1: config 3; SVC_T2: the same at seed
    1, one program key; SVC_T3: the ResNet-18 in chunks of 8) through
    ``SweepService(...).serve()`` in this process at one boundary a
    slice, drained on empty: all done in >= 9 slices, each ledger's
    records and final state digest equal a solo CLI run's, ``report
    --validate`` passes, T2 a program-cache hit from its first slice and
    T1 a miss, both GN kernels launched and the plain versions never,
    held against the plain versions at every shape the tenants launched;
    each tenant's wall and slices, the set-up before its first launch,
    the server's peak memory over what the script held before it, and
    what the card holds at every slice's end (the program cache's arrays
    and the cuBLAS workspace, gated) and once the server is gone. (b) T1 submitted through ``submit`` to a
    resident server subprocess: ``status`` shows a live phase,
    SIGTERM once the heartbeat shows generation 1 exits 0 with T1
    parked; a queued job ``cancel``led ends cancelled; ``drain`` of a
    restarted server mid-slice exits 0 and loses no job; a third server
    finishes T1 to the solo run's records and digest. (c) Two servers
    (ids a and b) on one spool with two SVC_SHA tenants: a SIGKILLs
    itself mid-slice, b takes over its lease and finishes both to their
    solo records. (d) ``corpus index`` over a directory holding config
    4's cold ledger, then fused TPE with ``--warm-start auto:DIR``: its
    observations and records equal a ``--warm-start PATH`` run's on the
    ledger merged by (params, budget) as the corpus merges it, and
    ``corpus resolve`` names the source. (a)'s server runs alone on the
    card; then (b) and (c) run in threads while (a)'s solo references
    and (d) run in this process.
    Returns (record, GN launches by path, max abs error of each kernel,
    problem)."""
    import gc
    import shutil

    from mpi_opt_tpu_torch import cli
    from mpi_opt_tpu_torch.health.heartbeat import read_beat
    from mpi_opt_tpu_torch.ledger.report import report_main
    from mpi_opt_tpu_torch.service.scheduler import SweepService
    from mpi_opt_tpu_torch.service.spool import Spool
    from mpi_opt_tpu_torch.utils.metrics import MetricsLogger

    tmp = os.path.join(ROOT, "build", "chip_smoke_service")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    out = {"card": smi}
    launches = {}
    errs = {"gn_fwd": 0.0, "gn_bwd": 0.0}

    def drained():
        """(b) T1 through the spool clients and resident servers."""
        sd = os.path.join(tmp, "b")
        servers = []
        res = {}
        try:
            rc, o = _spool_client("submit", "--state-dir", sd, "--tenant", "t1", "--", *SVC_T1)
            job = json.loads(o)["job"]
            servers.append(_serve(sd, os.path.join(tmp, "b1.log")))
            hb = os.path.join(sd, "tenants", job, "heartbeat.json")
            _wait_until(lambda: ((read_beat(hb) or {}).get("progress") or {}).get("launch", 0) >= 1,
                        [servers[0][0]], "service (b): generation 1")
            rc_s, o = _spool_client("status", "--state-dir", sd, "--json")
            live = next(j for j in json.loads(o)["jobs"] if j["job"] == job)
            servers[0][0].send_signal(signal.SIGTERM)
            rc1 = servers[0][0].wait(timeout=120)
            spool = Spool(sd)
            res.update(status={k: live.get(k) for k in ("state", "phase", "slice_elapsed_s")},
                       sigterm_exit=rc1, after_sigterm=spool.tenant(job).status["state"])
            _, o = _spool_client("submit", "--state-dir", sd, "--tenant", "t2", "--", *SVC_SHA)
            other = json.loads(o)["job"]
            _, o = _spool_client("submit", "--state-dir", sd, "--tenant", "t3", "--", *SVC_SHA,
                                 "--seed", "1")
            queued = json.loads(o)["job"]
            _, o = _spool_client("cancel", "--state-dir", sd, queued)
            res["cancel"] = json.loads(o)["state"]
            n0 = len(_events(sd, "slice_start"))
            servers.append(_serve(sd, os.path.join(tmp, "b2.log"), "--slice-boundaries", "1"))
            _wait_until(lambda: len(_events(sd, "slice_start")) > n0, [servers[1][0]],
                        "service (b): the restarted server's first slice")
            rc_d, _ = _spool_client("drain", "--state-dir", sd, "--wait", "180")
            res.update(drain_exit=rc_d, drained_server_exit=servers[1][0].wait(timeout=60),
                       after_drain={j: spool.tenant(j).status["state"] for j in (job, other, queued)})
            servers.append(_serve(sd, os.path.join(tmp, "b3.log"), "--drain-on-empty"))
            res["final_server_exit"] = servers[2][0].wait(timeout=300)
            res["final"] = {j: spool.tenant(j).status["state"] for j in (job, other, queued)}
            ok = (rc == rc_s == rc_d == 0 and live["state"] == "running" and live.get("phase")
                  and rc1 == 0 and res["after_sigterm"] == "parked" and res["cancel"] == "cancelled"
                  and res["drained_server_exit"] == 0
                  and "parked" in res["after_drain"].values()
                  and res["after_drain"][queued] == "cancelled"
                  and res["final_server_exit"] == 0
                  and res["final"] == {job: "done", other: "done", queued: "cancelled"})
            return res, None if ok else f"service (b): {res}", spool.tenant(job)
        finally:
            _stop(servers)

    def fleet():
        """(c) two servers on one spool, one SIGKILLed mid-slice."""
        sd = os.path.join(tmp, "c")
        spool = Spool(sd)
        jobs = [spool.submit([*SVC_SHA, "--seed", str(i)], tenant=f"s{i}") for i in range(2)]
        servers = []
        try:
            servers.append(_serve(sd, os.path.join(tmp, "c_a.log"), script=_SERVE_KILL))
            _wait_until(lambda: any(spool.tenant(j) and spool.tenant(j).status.get("server") == "a"
                                    for j in jobs), [servers[0][0]], "service (c): a's first slice")
            servers.append(_serve(sd, os.path.join(tmp, "c_b.log"), "--server-id", "b",
                                  "--slice-boundaries", "1", "--drain-on-empty"))
            rc_a = servers[0][0].wait(timeout=300)  # reaped: its pid is gone
            rc_b = servers[1][0].wait(timeout=300)
            takeovers = [(e["job"], e["from_server"], e["to_server"]) for e in _events(sd, "tenant_takeover")]
            res = {"a_exit": rc_a, "b_exit": rc_b, "takeovers": takeovers,
                   "states": [spool.tenant(j).status["state"] for j in jobs]}
            return res, (None if rc_a == -signal.SIGKILL and rc_b == 0 and len(takeovers) == 1
                         and takeovers[0][1:] == ("a", "b") and res["states"] == ["done", "done"]
                         else f"service (c): {res}"), [spool.tenant(j).ledger for j in jobs]
        finally:
            _stop(servers)

    def served():
        """(a) three tenants in one server in this process, alone on the
        card; (the problem or None, what the solo check needs)."""
        sd = os.path.join(tmp, "a")
        spool = Spool(sd)
        names = {spool.submit(SVC_T1, tenant="t1"): "T1", spool.submit(SVC_T2, tenant="t2"): "T2",
                 spool.submit(SVC_T3, tenant="t3"): "T3"}
        first_launch = {}
        kept = []  # at each slice's end: (job, bytes over base, cached bytes)

        def cached_bytes(svc):
            """The bytes of the on-card arrays the program cache holds."""
            return sum(t.numel() * t.element_size() for w in svc.programs._workloads.values()
                       for t in getattr(w, "_fused_cache", ())[3:] if isinstance(t, torch.Tensor))

        class Clock(MetricsLogger):
            """The server's metrics, remembering whose slice runs now and
            reading what the card holds once each slice is over."""
            job = svc = None

            def log(self, event, **fields):
                if event == "slice_start":
                    Clock.job = fields["job"]
                elif event == "slice_end":  # after the slice's frames are collected
                    torch.cuda.synchronize()
                    kept.append((fields["job"], torch.cuda.memory_allocated() - base,
                                 cached_bytes(Clock.svc)))
                return super().log(event, **fields)

        real_fwd = gn.gn_fwd

        def first_fwd(*a, **k):  # the first GN launch of each tenant
            first_launch.setdefault(Clock.job, time.time())
            return real_fwd(*a, **k)

        gc.collect()
        base = torch.cuda.memory_allocated()
        gn.reset_launches()
        gn.gn_fwd = first_fwd
        try:
            with _ShapeRecorder(gn) as rec:
                svc = Clock.svc = SweepService(sd, slice_boundaries=1, drain_on_empty=True, poll_seconds=0.05,
                                               metrics=Clock(path=spool.metrics_path), device="cuda")
                t0 = time.perf_counter()
                rc = svc.serve()
                wall = time.perf_counter() - t0
        finally:
            gn.gn_fwd = real_fwd
        launches["service"] = dict(gn.LAUNCHES)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        cached = cached_bytes(svc)
        del svc
        Clock.svc = None
        gc.collect()
        # what is left is the process's, not a tenant's: cuBLAS keeps a
        # workspace a handle and stream once a matmul ran (64 MiB here)
        workspace = torch.cuda.memory_allocated() - base
        getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)()
        left = torch.cuda.memory_allocated() - base
        # the server's own peak: the script's earlier phases hold `base`
        summary = _events(sd, "summary")[-1]
        peak = summary["device_memory_peak_bytes"]
        starts, ends, admits = (_events(sd, e) for e in ("slice_start", "slice_end", "tenant_admit"))
        tenants = {}
        for job, name in names.items():
            st = spool.tenant(job).status
            first = next(e for e in starts if e["job"] == job)
            tenants[name] = {
                "state": st["state"], "slices": st["slices"],
                "wall_s": sum(e["wall_s"] for e in ends if e["job"] == job),
                "first_slice_wall_s": st["first_slice_wall_s"],
                "first_slice_program_cache_hit": st["first_slice_program_cache_hit"],
                "setup_s": first_launch.get(job, math.nan) - first["ts"],
                "admission_to_first_launch_s": first_launch.get(job, math.nan)
                - next(e["ts"] for e in admits if e["job"] == job),
                "peak_over_base_bytes": max(e["mem_peak_bytes"] for e in ends if e["job"] == job) - base,
            }
        # a parked or finished tenant pins nothing: at every slice's end
        # the server holds the program cache's arrays and the cuBLAS
        # workspace (`workspace`, the process's), within 1 MiB
        over = max(k - c for _, k, c in kept)
        la = launches["service"]
        out["serve"] = {"exit": rc, "wall_s": wall, "slices": summary["slices"],
                        "tenants_done": summary["tenants_done"], "tenants": tenants, "launches": la,
                        "program_cache": [summary["program_cache_hits"], summary["program_cache_misses"]],
                        "script_base_bytes": base, "server_peak_over_base_bytes": peak - base,
                        "held_at_slice_ends_bytes": [k for _, k, _ in kept],
                        "cached_at_slice_ends_bytes": [c for _, _, c in kept],
                        "held_after_serve_bytes": held, "cached_array_bytes": cached,
                        "left_after_server_bytes": workspace, "left_without_cublas_workspace_bytes": left}
        print(f"service (a) three tenants in one server, alone on the card ({smi}): {json.dumps(out['serve'])}")
        if rc != 0 or summary["slices"] < 9 or any(t["state"] != "done" for t in tenants.values()):
            return f"service (a): exit {rc}, {summary['slices']} slices, {tenants}", None
        if tenants["T1"]["first_slice_program_cache_hit"] or not tenants["T2"]["first_slice_program_cache_hit"]:
            return f"service (a): the program cache: {tenants}", None
        if not (la["gn_fwd"] > 0 and la["gn_bwd"] > 0) or la["plain"]:
            return f"service (a): GN launches {la}", None
        if over > workspace + (1 << 20) or held - cached > workspace + (1 << 20):
            return (f"service (a): the server held {over} bytes at a slice's end and {held - cached} after "
                    f"serve beyond the program cache's arrays (cuBLAS workspace {workspace})"), None
        if left > 1 << 20:
            return f"service (a): {left} bytes still allocated once the server is gone", None
        return None, (names, spool, rec)

    def against_solo(names, spool, rec):
        """(a)'s tenants against solo CLI runs of their argv; the GN
        shapes they launched against the plain versions."""
        gn.reset_launches()
        for job, name in names.items():
            solo[name] = _solo_ref(cli, tmp, name, {"T1": SVC_T1, "T2": SVC_T2, "T3": SVC_T3}[name])
            t = spool.tenant(job)
            got = (_records(t.ledger), _final_digest(t.ckpt))
            rc_v, _ = _in_process(report_main, [t.ledger, "--validate"])
            out["serve"]["tenants"][name].update(same_records=got[0] == solo[name][0],
                                                 same_digest=got[1] == solo[name][1], validate=rc_v)
            if got != solo[name] or rc_v != 0:
                return f"service (a): {name} against its solo run: {out['serve']}"
        launches["service_solo"] = dict(gn.LAUNCHES)
        check_shapes(gn, rec.shapes, errs)
        out["serve"]["gn_shapes"] = sorted([list(s), g, r, str(d)] for s, g, r, d in rec.shapes)
        out["serve"]["max_abs_err"] = dict(errs)
        print(f"service (a) against solo runs: records and digests equal, reports validate; GN shapes "
              f"checked against the plain versions: {len(rec.shapes)} (max abs err {json.dumps(errs)})")
        return None

    def corpus():
        """(d) --warm-start auto:DIR against --warm-start PATH. The corpus
        merges a prior's records by (params, budget), newest first
        (``corpus/resolve.py``, as the JAX package does), and config 4's
        space has integer dimensions, so TPE's ledger can hold one point
        twice: auto:DIR is held against PATH on that merged copy of the
        ledger, and against PATH on the ledger itself for the record."""
        from mpi_opt_tpu_torch import get_workload

        d = os.path.join(tmp, "d")
        cold = os.path.join(d, "corpus", "cold.jsonl")
        rc, _ = _in_process(cli.main, [*SVC_C4, "--ledger", cold])
        rc_i, _ = _in_process(cli.main, ["corpus", "index", os.path.dirname(cold)])
        space = get_workload("tabular_mlp").default_space()
        with open(cold) as f:
            head, *lines = f.read().splitlines()
        merged = {}
        for line in lines:
            rec = json.loads(line)
            if rec["status"] != "ok" or rec.get("score") is None:
                continue
            key = (space.params_key(rec["params"]), int(rec["step"]))
            if key not in merged or rec["ts"] >= json.loads(merged[key])["ts"]:
                merged[key] = line
        prior = os.path.join(d, "prior_merged.jsonl")
        with open(prior + ".tmp", "w") as f:
            f.write("\n".join([head, *merged.values()]) + "\n")
        os.replace(prior + ".tmp", prior)
        runs = {}
        for name, warm in (("auto", f"auto:{os.path.dirname(cold)}"),
                           ("merged", prior), ("path", cold)):
            rc_w, lines = _in_process(cli.main, [*SVC_C4, "--ledger", os.path.join(d, f"{name}.jsonl"),
                                                 "--warm-start", warm])
            ev = next((x for x in lines if x.get("event") == "warm_start"), {})
            runs[name] = {"exit": rc_w, "observations": ev.get("observations"),
                          "sources": ev.get("sources"), "records": _records(os.path.join(d, f"{name}.jsonl"))}
        rc_r, lines = _in_process(cli.main, ["corpus", "resolve", os.path.dirname(cold), "--workload",
                                             "tabular_mlp", "--json"])
        res = {"cold_exit": rc, "index_exit": rc_i, "resolve_exit": rc_r,
               "resolve": lines[-1] if lines else None, "distinct_points": len(merged),
               "observations": {k: v["observations"] for k, v in runs.items()},
               "auto_sources": runs["auto"]["sources"],
               "same_records_as_merged": runs["auto"]["records"] == runs["merged"]["records"],
               "same_records_as_path": runs["auto"]["records"] == runs["path"]["records"]}
        ok = (rc == rc_i == rc_r == 0 and all(v["exit"] == 0 for v in runs.values())
              and res["observations"]["auto"] == res["observations"]["merged"] == len(merged)
              and res["observations"]["path"] == C4_TRIALS and res["same_records_as_merged"]
              and (res["same_records_as_path"] or len(merged) < C4_TRIALS)
              and [(s["match"], s["path"]) for s in (res["resolve"] or {}).get("sources", [])]
              == [("exact", cold)]
              and [s["path"] for s in res["auto_sources"] or []] == [cold])
        return res, None if ok else f"service (d): {res}"

    # (a) runs alone on the card, so its walls, set-up and peak are the
    # server's own. (b) and (c) drive servers in subprocesses, whose
    # start is most of their wall: they run while (a)'s solo references
    # and (d) run in this process
    solo = {}
    pool = concurrent.futures.ThreadPoolExecutor(2)
    try:
        bad, ctx = served()
        if bad:
            return out, launches, errs, bad
        drills = (pool.submit(drained), pool.submit(fleet))
        bad = against_solo(*ctx)
        d, bad_d = corpus()
        (b, bad_b, t1), (c, bad_c, sha_ledgers) = (f.result() for f in drills)
        if bad:
            return out, launches, errs, bad
    except Exception as e:  # a drill's server or client failed before its gate
        return out, launches, errs, f"service: {type(e).__name__}: {e}"
    finally:
        pool.shutdown(wait=True)
    b.update(same_records=_records(t1.ledger) == solo["T1"][0],
             same_digest=_final_digest(t1.ckpt) == solo["T1"][1])
    out.update(drained=b, fleet=c, corpus=d)
    print(f"service (b) a server drained by SIGTERM and drain ({smi}): {json.dumps(b)}")
    print(f"service (c) two servers, one SIGKILLed ({smi}): {json.dumps(c)}")
    print(f"service (d) --warm-start auto:DIR ({smi}): {json.dumps(d)}")
    if bad_b or bad_c or bad_d or not (b["same_records"] and b["same_digest"]):
        return out, launches, errs, bad_b or bad_c or bad_d or f"service (b): T1 against its solo run: {b}"
    for i, path in enumerate(sha_ledgers):
        want, _ = _solo_ref(cli, tmp, f"sha{i}", [*SVC_SHA, "--seed", str(i)])
        if _records(path) != want:
            return out, launches, errs, f"service (c): tenant {i} against its solo run"
    out["fleet"]["same_records"] = True
    shutil.rmtree(tmp, ignore_errors=True)
    return out, launches, errs, None


# phase 22, the suggestion service: BENCH_ALL.json config 6 (a real
# --suggest-serve server on tabular_mlp driven over its filesystem spool,
# 8 rounds of a 32-point suggestion and its 32 reports) and config 7 (the
# same server behind --http-port 0 --http-queue 64, 4 concurrent clients
# x 12 rounds of a batched suggestion and its batched reports), at full
# size (bench_all.py's bench_config6/bench_config7)
SUG_ROUNDS, SUG_BATCH = 8, 32
HTTP_ROUNDS, HTTP_BURST, HTTP_QUEUE = 12, 4, 64
SUG_RING = 512  # the server's ring (SuggestServer's default buffer)
SUG_UNIT_TOL = 1e-5  # card against CPU units of one acquisition on the same draws
# the exactly-once drill: rounds of an 8-point suggestion and its reports,
# seeded net faults over the first DRILL_WINDOW transport ops of each
# stage, and the server SIGKILLed after journaling round DRILL_KILL's reports
DRILL_ROUNDS, DRILL_BATCH, DRILL_KILL, DRILL_WINDOW = 6, 8, 3, 12
# the tenant drill: 12 suggestions, each followed by a report of a fixed
# point (the records do not depend on what was suggested); the drain after
# the first TENANT_DRAIN of those 24 requests
TENANT_REQUESTS, TENANT_DRAIN = 12, 13


def _suggest_serve(tmp, name, *extra):
    """A ``--suggest-serve`` server on tabular_mlp (the card) in a
    subprocess, its output to a file; returns (process, log file, spool,
    ledger, log path)."""
    d = os.path.join(tmp, name)
    os.makedirs(d, exist_ok=True)
    spool, led, log = (os.path.join(d, x) for x in ("spool", "l.jsonl", "out.log"))
    f = open(log, "a")
    argv = [sys.executable, "-m", "mpi_opt_tpu_torch", "--workload", "tabular_mlp", "--suggest-serve",
            spool, "--suggest-idle-timeout", "120", "--seed", "0", "--ledger", led, *extra]
    return subprocess.Popen(argv, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT, text=True), f, spool, led, log


def _last_json(path):
    with open(path) as f:
        lines = [x for x in f.read().splitlines() if x.startswith("{")]
    return json.loads(lines[-1]) if lines else {}


def _spool_ready(client, spool, proc):
    """The first answered suggestion (import, CUDA, data): set-up, outside
    any timed window."""
    end = time.monotonic() + 300
    while time.monotonic() < end:
        try:
            return client.round_trip(spool, {"op": "suggest", "n": SUG_BATCH}, timeout=10)
        except TimeoutError:
            if proc.poll() is not None:
                break
    raise AssertionError(f"the suggestion server never answered (rc {proc.poll()})")


def _http_ready(client, transport, spool, proc, pid=None):
    """The front door's URL once it is bound (its endpoint file names
    ``pid`` when given: a restart overwrites a killed server's) and its
    first answered suggestion."""
    end = time.monotonic() + 300
    path = os.path.join(spool, "control", "http.json")
    while time.monotonic() < end and proc.poll() is None:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            doc = {}
        if doc.get("url") and (pid is None or doc.get("pid") == pid):
            env = transport.envelope([{"op": "suggest", "n": SUG_BATCH}])
            transport.call_with_retries(transport.HttpTransport(doc["url"], timeout=60), "/v1/batch",
                                        env, retries=8)
            return doc["url"]
        time.sleep(0.05)
    raise AssertionError(f"the front door never answered (rc {proc.poll()})")


def _idem_pairs(path):
    return [(r.get("idem_key"), r.get("idem_op")) for r in _records(path)]


def _journaled_reports(path) -> int:
    """Records a ledger holds whole (a line the server is still writing
    is not counted)."""
    with open(path) as f:
        return max(0, f.read().count("\n") - 1)


def suggest_phase(gn, smi):
    """The suggestion service (``--suggest-serve``, ``suggest-client``,
    the HTTP front door) on the card. (a) BENCH config 6 at full size: a
    server subprocess on tabular_mlp driven by ``client.bench`` over its
    spool, 8 rounds x 32, every suggestion reported: suggestions/s,
    round-trip p50/p95, and the ledger's 256 reports, each once. (b)
    BENCH config 7 at full size: a server behind ``--http-port 0
    --http-queue 64`` driven by ``bench_http`` with 4 clients x 12 rounds
    x 32: suggestions/s, round-trip and queue-wait p50/p95, the server's
    shed/replayed/expired counters, every report once. (c) The
    exactly-once drill: a front door on the card, the client under seeded
    ``inject_net`` faults (refused, torn, delayed), the server SIGKILLed
    after journaling a report batch and before its reply, restarted with
    ``--resume`` on a new port, the client retrying the same envelope into
    it: every acked (idem_key, idem_op) journaled once, the retried batch
    answered ``journal_replayed``. (d) One ``SuggestServer.suggest(32)``
    over a full ring (512 rows of tabular_mlp's space) in this process on
    the card, timed by CUDA events, against the same draws on the CPU
    (equal picks, units within SUG_UNIT_TOL, a near-tie named where the
    greedy picks part) with the CPU call's time beside it, the ring's
    acquisition tensors on cuda. (e) A suggestion tenant under ``serve``
    on the card: submitted, fed fixed-point requests, ``drain`` parks it
    (the server exits 0), a restarted server resumes it, the stop flag
    completes it (done): its records equal those of one unparked server
    fed the same requests. (a) and (b) each run alone; their servers
    start together. (c) and (e) run together.
    Returns (record, GN launches, problem)."""
    import shutil

    from mpi_opt_tpu_torch.algorithms import tpe as atpe
    from mpi_opt_tpu_torch.algorithms.base import Observation
    from mpi_opt_tpu_torch.corpus import client, transport
    from mpi_opt_tpu_torch.corpus.serve import SuggestServer
    from mpi_opt_tpu_torch.ops.tpe import TPEDraws, pick_components, tpe_apply, tpe_fit
    from mpi_opt_tpu_torch.service.spool import Spool
    from mpi_opt_tpu_torch.workloads import get_workload
    from mpi_opt_tpu_torch.workloads.chaos import NetFaultInjector

    tmp = os.path.join(ROOT, "build", "chip_smoke_suggest")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    t_phase = time.perf_counter()
    out = {"card": smi}
    servers = []
    gn.reset_launches()
    try:
        # (a) and (b): both servers start at once; each bench runs alone
        c6 = _suggest_serve(tmp, "c6")
        c7 = _suggest_serve(tmp, "c7", "--http-port", "0", "--http-queue", str(HTTP_QUEUE))
        servers += [c6[:2], c7[:2]]
        _spool_ready(client, c6[2], c6[0])
        url = _http_ready(client, transport, c7[2], c7[0])
        rec = client.bench(c6[2], rounds=SUG_ROUNDS, batch=SUG_BATCH)
        client.request_stop(c6[2])
        rc = c6[0].wait(timeout=120)
        recs = _records(c6[3])
        rec.update(card=smi, rc=rc, ledger_records=len(recs),
                   ledger_ok=sum(r["status"] == "ok" for r in recs))
        print("suggest-config6 " + json.dumps(rec))
        out["config6"] = rec
        if rc != 0 or [r["trial_id"] for r in recs] != list(range(SUG_ROUNDS * SUG_BATCH)) or \
                rec["ledger_ok"] != SUG_ROUNDS * SUG_BATCH:
            return out, {}, f"suggest (a): rc {rc}, {len(recs)} records, {rec['ledger_ok']} ok"
        rec = client.bench_http(url, rounds=HTTP_ROUNDS, batch=SUG_BATCH, burst=HTTP_BURST)
        transport.HttpTransport(url, timeout=30).call("/v1/stop", {})
        rc = c7[0].wait(timeout=120)
        summary = _last_json(c7[4])
        pairs = _idem_pairs(c7[3])
        want = SUG_BATCH * (1 + HTTP_ROUNDS * HTTP_BURST)  # bench_http's warm-up batch too
        rec.update(card=smi, rc=rc, ledger_records=len(pairs), server={
            k: summary.get(k) for k in ("served", "ops", "suggestions", "reports", "shed", "replayed",
                                        "expired", "breaker_trips")})
        print("suggest-config7 " + json.dumps(rec))
        out["config7"] = rec
        if rc != 0 or len(pairs) != want or len(set(pairs)) != want:
            return out, {}, f"suggest (b): rc {rc}, {len(pairs)} records ({len(set(pairs))} distinct)" \
                            f" of {want}"

        # (d) the acquisition in this process: card against CPU, one ring
        space = get_workload("tabular_mlp").default_space()
        rng = np.random.default_rng(22)
        obs = [Observation(unit=rng.random(space.dim, dtype=np.float32), score=float(s), budget=1)
               for s in rng.normal(size=SUG_RING)]

        def server(device):
            s = SuggestServer(space, seed=0, device=device)
            s.ingest(obs)
            return s

        seen = []
        real_fit = atpe.tpe_fit
        atpe.tpe_fit = lambda u, *a: (seen.append(str(u.device.type)), real_fit(u, *a))[1]
        try:
            card, host = server("cuda"), server("cpu")
            got, want_u = card.suggest(SUG_BATCH)["units"], host.suggest(SUG_BATCH)["units"]
        finally:
            atpe.tpe_fit = real_fit
        diff = np.abs(np.float32(got) - np.float32(want_u)).max(axis=1)
        parted = next((i for i, d in enumerate(diff) if d > SUG_UNIT_TOL), None)
        acq = {}
        if parted is not None:
            # where the greedy picks part, both devices' picked candidates
            # must score alike (a near-tie), else the acquisition is wrong
            draws = card._draw_tpe((0, 0), SUG_RING, space.dim)
            for dev in ("cuda", "cpu"):
                ring = [torch.from_numpy(a).to(dev) for a in (card._obs_unit, card._obs_score, card._valid)]
                dr = TPEDraws(*(x.to(dev) for x in draws))
                model = tpe_fit(*ring, card.config)
                comp = pick_components(dr.u_pick, model.probs)
                acq[dev] = tpe_apply(ring[0], model, comp, dr.jitter, dr.uni, SUG_BATCH, card.config)[1].cpu()
        warm = server("cuda")
        for _ in range(3):
            warm.suggest(SUG_BATCH)
        card_ms = []
        for _ in range(10):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            warm.suggest(SUG_BATCH)
            e1.record()
            torch.cuda.synchronize()
            card_ms.append(e0.elapsed_time(e1))
        cpu = server("cpu")
        cpu.suggest(SUG_BATCH)
        cpu_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            cpu.suggest(SUG_BATCH)
            cpu_ms.append((time.perf_counter() - t0) * 1e3)
        rec = {"card": smi, "ring": SUG_RING, "dim": space.dim, "candidates": card.config.n_candidates,
               "n": SUG_BATCH, "ring_devices": seen, "max_unit_diff": float(diff.max()),
               "picks_equal": SUG_BATCH if parted is None else parted,
               "card_ms": card_ms, "card_ms_median": float(np.median(card_ms)),
               "cpu_ms": cpu_ms, "cpu_ms_median": float(np.median(cpu_ms))}
        if parted is not None:
            rec["near_tie"] = [float(acq["cuda"][parted]), float(acq["cpu"][parted])]
        print("suggest-acquisition " + json.dumps(rec))
        out["acquisition"] = rec
        if seen != ["cuda", "cpu"]:
            return out, {}, f"suggest (d): the ring's acquisition tensors were on {seen}"
        if parted is not None and (parted < 8 or not np.isclose(*rec["near_tie"], rtol=1e-5, atol=1e-5)):
            return out, {}, f"suggest (d): card and CPU picks part at {parted} without a near-tie"

        def drill():
            """(c) exactly once across seeded net faults and a SIGKILL."""
            proc, f, spool, led, log = _suggest_serve(tmp, "drill", "--http-port", "0")
            servers.append((proc, f))
            state = {"armed": None, "killed": False, "restarted": None}
            injector = NetFaultInjector(refuse=3, torn=3, delay=3, delay_s=0.05, seed=15,
                                        ops_window=DRILL_WINDOW)

            def seam(stage, at):
                if state["armed"] is not None and stage == "read":
                    expect, state["armed"] = state["armed"], None
                    end = time.monotonic() + 60  # the batch is written: wait until it is journaled
                    while _journaled_reports(led) < expect and time.monotonic() < end:
                        time.sleep(0.005)
                    proc.kill()
                    proc.wait()
                    state["killed"] = True
                    raise transport.TornResponse(f"drill: {at} SIGKILLed before its reply")
                injector(stage, at)

            def sleep(s):
                if state["killed"] and state["restarted"] is None:
                    p2, f2 = _suggest_serve(tmp, "drill", "--http-port", "0", "--resume")[:2]
                    servers.append((p2, f2))
                    state["restarted"] = p2
                    new = transport.HttpTransport(_http_ready(client, transport, spool, p2, pid=p2.pid))
                    cli.transport.host, cli.transport.port = new.host, new.port
                    cli.transport.base_url = new.base_url
                time.sleep(min(s, 0.05))

            cli = client.SuggestHttpClient(_http_ready(client, transport, spool, proc), client_id="drill",
                                           timeout=60, retries=10, backoff_s=0.02, sleep=sleep)
            acked, replayed = [], None
            transport.set_net_fault_injector(seam)
            try:
                for r in range(DRILL_ROUNDS):
                    params = cli.suggest(DRILL_BATCH)["params"]
                    ops = [{"op": "report", "params": p, "score": client._synthetic_score(p), "budget": 1}
                           for p in params]
                    if r == DRILL_KILL:
                        state["armed"] = _journaled_reports(led) + len(ops)
                    env = transport.envelope(ops, client="drill")
                    ans = transport.call_with_retries(cli.transport, "/v1/batch", env, retries=10,
                                                      backoff_s=0.02, sleep=sleep)
                    if any(x.get("error") for x in ans["results"]):
                        raise AssertionError(f"drill: round {r} refused: {ans['results'][:2]}")
                    acked += [(env["key"], i) for i in range(len(ops))]
                    if r == DRILL_KILL:
                        replayed = [bool(x.get("journal_replayed")) for x in ans["results"]]
            finally:
                transport.set_net_fault_injector(None)
            cli.stop()
            p2 = state["restarted"]
            rc2 = p2.wait(timeout=120) if p2 is not None else None
            pairs = _idem_pairs(led)
            rec = {"card": smi, "rounds": DRILL_ROUNDS, "batch": DRILL_BATCH, "killed_at_round": DRILL_KILL,
                   "faults_fired": dict(injector.faults_fired), "killed_rc": proc.returncode,
                   "restarted_rc": rc2, "acked": len(acked), "ledger_records": len(pairs),
                   "distinct": len(set(pairs)), "journal_replayed": replayed}
            bad = None
            if not state["killed"] or rc2 != 0:
                bad = f"suggest (c): killed {state['killed']}, the restart exited {rc2}"
            elif sorted(pairs) != sorted(acked) or len(set(pairs)) != len(pairs):
                bad = "suggest (c): the ledger does not hold every acked report exactly once"
            elif not replayed or not all(replayed):
                bad = f"suggest (c): the retried batch was not answered from the journal: {replayed}"
            elif min(injector.faults_fired.values()) < 1:
                bad = f"suggest (c): a net fault never fired: {injector.faults_fired}"
            return rec, bad

        # the tenant's requests: a suggestion, then a report of a fixed point
        ops = []
        for i in range(TENANT_REQUESTS):
            ops += [{"op": "suggest", "n": 4},
                    {"op": "report", "params": {"lr": 0.001 * (i + 1), "momentum": 0.05 * i,
                                                "weight_decay": 1e-5 * (i + 1)},
                     "score": 0.01 * i, "budget": 2}]

        def feed(spool, part):
            for op in part:
                ans = client.round_trip(spool, op, timeout=300)
                if ans.get("error"):
                    raise AssertionError(f"tenant: {op['op']} refused: {ans['error']}")

        def tenant():
            """(e) parked by a drain, resumed, stopped: the unparked records."""
            sd, spool = os.path.join(tmp, "e", "state"), os.path.join(tmp, "e", "spool")
            ref = _suggest_serve(tmp, "e-ref")
            servers.append(ref[:2])
            p1 = _serve(sd, os.path.join(tmp, "e1.log"), "--slice-boundaries", "3")
            servers.append(p1)
            rc_sub, o = _spool_client("submit", "--state-dir", sd, "--tenant", "ext", "--", "--workload",
                                      "tabular_mlp", "--suggest-serve", spool, "--suggest-idle-timeout",
                                      "120", "--seed", "0")
            job = json.loads(o)["job"]
            feed(ref[2], ops)
            client.request_stop(ref[2])
            feed(spool, ops[:TENANT_DRAIN])
            _spool_client("drain", "--state-dir", sd)
            feed(spool, ops[TENANT_DRAIN:TENANT_DRAIN + 1])  # served, then the slice parks
            rc1 = p1[0].wait(timeout=120)
            parked = Spool(sd).tenant(job).status
            p2 = _serve(sd, os.path.join(tmp, "e2.log"), "--slice-boundaries", "3", "--drain-on-empty")
            servers.append(p2)
            feed(spool, ops[TENANT_DRAIN + 1:])
            rc_stop, _ = _spool_client("suggest-client", "--dir", spool, "stop")
            rc2 = p2[0].wait(timeout=120)
            rc_ref = ref[0].wait(timeout=120)
            st = Spool(sd).tenant(job).status
            got, want = _records(Spool(sd).tenant(job).ledger), _records(ref[3])
            keep = ("trial_id", "params", "status", "score", "step")
            same = [{k: r[k] for k in keep} for r in got] == [{k: r[k] for k in keep} for r in want]
            rec = {"card": smi, "requests": len(ops), "drained_after": TENANT_DRAIN + 1,
                   "server_rcs": [rc1, rc2], "parked_state": parked.get("state"),
                   "state": st.get("state"), "slices": st.get("slices"), "records": len(got),
                   "reference_rc": rc_ref, "records_equal_unparked": same, "submit_rc": rc_sub,
                   "stop_rc": rc_stop}
            bad = None
            if rc1 != 0 or rc2 != 0 or rc_ref != 0 or parked.get("state") != "parked":
                bad = f"suggest (e): servers {rc1}, {rc2}, reference {rc_ref}, parked {parked.get('state')}"
            elif st.get("state") != "done" or not same or len(got) != TENANT_REQUESTS:
                bad = f"suggest (e): state {st.get('state')}, {len(got)} records, equal {same}"
            return rec, bad

        (drill_rec, bad_c), (tenant_rec, bad_e) = _together(drill, tenant)
        print("suggest-drill " + json.dumps(drill_rec))
        print("suggest-tenant " + json.dumps(tenant_rec))
        out.update(drill=drill_rec, tenant=tenant_rec)
        if bad_c or bad_e:
            return out, {}, bad_c or bad_e
    except Exception as e:  # noqa: BLE001 - a phase's failure fails the run
        return out, {}, f"suggest: {type(e).__name__}: {e}"
    finally:
        _stop(servers)
    launches = {"suggest": dict(gn.LAUNCHES)}  # no GN on this path
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"suggest phase wall: {out['wall_s']} s")
    shutil.rmtree(tmp, ignore_errors=True)
    return out, launches, None


# phase 23: the checks of both packages' `lint --json`, in the JAX
# package's order, then the project pass's synthetic entry
LINT_CHECKS = ("exit-code", "journal-order", "ledger-gate", "atomic-write", "ledger-fsync",
               "drain-swallow", "key-reuse", "host-sync", "event-registry", "lease-write",
               "coord-write", "corpus-index-write", "resource-funnel", "fsync-before-rename",
               "http-handler-contained", "guarded-by", "beat-path-nonblocking", "signal-safety",
               "lock-order")
# phase 23 (c): sha256 of each array at seed 0, equal to the JAX package's
# arrays under scikit-learn 1.9 (tests/port/test_torch_data.py holds them)
DATASET_SHA256 = {
    "digits_image": {
        "train_x": "d0e52c7d72be80615ca9da810e1e9d8cc50577fa92b089031854b6a070446bf1",
        "train_y": "7b44826d30d9028635dd890a8b3d5783bc8184a19c1104dafad53512e2232371",
        "val_x": "2a9d39b8a808f7f67fde3d74038cdfd47501c8866a2e48337712ad7cff241132",
        "val_y": "92ec73515af8e038fd138d25fde5e1efa50ae11aff56613e2d1f42f2fccf20df",
    },
    "diabetes": {
        "train_x": "9cba0da496eee70ba0f314807123dfdedd63f17909c83cc9ef04cdf4d644df95",
        "train_y": "60d4274b40e3746b63d3839864c39963d66f16f164ddf7d2e75b520be4ad1c99",
        "val_x": "f46ecad4dc4004bea12ddaa0cfd3e7a6f0b390395a0b317844813ad2bad72639",
        "val_y": "26c25412e19f24fd4f00a35322632b52ad6952687ae21eaed573b103e0319bc4",
    },
}
# phase 23 (b): one planted fault for each per-file check (three shapes of
# key-reuse, two of resource-funnel), each a new file at a path in its
# check's scope; a line ending in "# planted <check>" is where its
# finding must land. Held as strings: no planted fault is code of the repo
LINT_PLANTS = {
    "mpi_opt_tpu_torch/planted_exit_code.py": (
        "import sys\n\n\ndef planted_bail():\n    sys.exit(75)  # planted exit-code\n"),
    "mpi_opt_tpu_torch/train/planted_journal.py": (
        "def planted_boundaries(snap, journal):\n    for g in range(3):\n"
        "        snap.save(g, sweep={})  # planted journal-order\n"
        "        journal_boundary(journal, g, [], [], [], step=1)\n"),
    "mpi_opt_tpu_torch/planted_ledger_gate.py": (
        "def planted_open(path):\n    return SweepLedger(path)  # planted ledger-gate\n"),
    "mpi_opt_tpu_torch/planted_atomic.py": (
        "def planted_status(path):\n"
        "    with open(path + \".json\", \"w\") as f:  # planted atomic-write\n"
        "        f.write(\"{}\")\n"),
    "mpi_opt_tpu_torch/ledger/planted_fsync.py": (
        "class PlantedJournal:\n    def planted_append(self, rec):\n"
        "        self._file.write(rec + \"\\n\")  # planted ledger-fsync\n"
        "        self._file.flush()\n"),
    "mpi_opt_tpu_torch/planted_drain.py": (
        "def planted_step(step):\n    try:\n        step()\n"
        "    except KeyboardInterrupt:  # planted drain-swallow\n        pass\n"),
    "mpi_opt_tpu_torch/planted_draws.py": (
        "import torch\n\n\ndef planted_noise(n, seed):\n"
        "    torch.manual_seed(seed)  # planted key-reuse\n"
        "    a, b = torch.Generator(), torch.Generator()\n"
        "    a.manual_seed(seed)\n"
        "    b.manual_seed(seed)  # planted key-reuse\n"
        "    return torch.randn(n)  # planted key-reuse\n"),
    "mpi_opt_tpu_torch/train/fused_planted.py": (
        "def planted_hot(scores):\n    return scores.tolist()  # planted host-sync\n"),
    "mpi_opt_tpu_torch/planted_event.py": (
        "def planted_emit(metrics):\n"
        "    metrics.log(\"planted_unregistered_event\", n=1)  # planted event-registry\n"),
    "mpi_opt_tpu_torch/service/planted_lease.py": (
        "import os\n\n\ndef planted_drop(d):\n"
        "    os.unlink(d + \"/lease.json\")  # planted lease-write\n"),
    "mpi_opt_tpu_torch/planted_coord.py": (
        "import os\n\n\ndef planted_scrub(coord_dir):\n"
        "    os.unlink(coord_dir + \"/READY.json\")  # planted coord-write\n"),
    "mpi_opt_tpu_torch/planted_corpus.py": (
        "import os\n\n\ndef planted_sneak(tmp, d):\n"
        "    os.replace(tmp, d + \"/corpus-index.json\")  # planted corpus-index-write\n"),
    "mpi_opt_tpu_torch/planted_oom.py": (
        "import errno\n\nimport torch\n\n\ndef planted_run(step):\n    try:\n        return step()\n"
        "    except torch.cuda.OutOfMemoryError:  # planted resource-funnel\n        return None\n\n\n"
        "def planted_full(e):\n    return e.errno == errno.ENOSPC  # planted resource-funnel\n"),
    "mpi_opt_tpu_torch/service/planted_status.py": (
        "import json\nimport os\n\n\ndef planted_publish(path, obj):\n    tmp = path + \".tmp\"\n"
        "    with open(tmp, \"w\") as f:\n        json.dump(obj, f)\n"
        "    os.replace(tmp, path)  # planted fsync-before-rename\n"),
    "mpi_opt_tpu_torch/service/planted_http.py": (
        "from http.server import BaseHTTPRequestHandler\n\n\n"
        "class PlantedRequestHandler(BaseHTTPRequestHandler):\n"
        "    def do_GET(self):  # planted http-handler-contained\n        self.send_response(200)\n"),
}
# runs `python -m mpi_opt_tpu_torch lint ARGS` in this process and then
# reports, on the last line of stderr, its exit code and whether torch or
# jax was imported
_LINT_PROBE = """
import json, runpy, sys
sys.argv = ["mpi_opt_tpu_torch", "lint", *sys.argv[1:]]
try:
    runpy.run_module("mpi_opt_tpu_torch", run_name="__main__", alter_sys=True)
    rc = 0
except SystemExit as e:
    rc = e.code
print(json.dumps({"rc": rc, "torch": "torch" in sys.modules, "jax": "jax" in sys.modules}),
      file=sys.stderr)
sys.exit(rc)
"""


def plant_lint_faults(root: str) -> set:
    """Write ``LINT_PLANTS`` under ``root``; the planted (check, relpath,
    line) set."""
    want = set()
    for rel, src in LINT_PLANTS.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(src)
        for i, line in enumerate(src.splitlines(), start=1):
            if "# planted " in line:
                want.add((line.rsplit("# planted ", 1)[1].strip(), rel, i))
    return want


def run_lint(*args):
    """``python -m mpi_opt_tpu_torch lint ARGS`` in a subprocess from the
    repo root: (exit code, stdout, the probe's record, wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _LINT_PROBE, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    tail = proc.stderr.strip().splitlines()
    probe = json.loads(tail[-1]) if tail and tail[-1].startswith("{") else {}
    return proc.returncode, proc.stdout, probe, wall


def lint_phase(smi):
    """Phase 23: (a) the port's lint over its own tree, (b) over a copy
    of the tree with ``LINT_PLANTS`` planted, then with a baseline of
    them, (c) the two tabular datasets ported last, by digest. Returns
    (record, problem)."""
    import shutil
    import tempfile

    from mpi_opt_tpu_torch.data import load_dataset

    t_phase = time.perf_counter()
    out = {"card": smi}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lint_")
    try:
        tree = os.path.join(tmp, "tree")
        shutil.copytree(os.path.join(ROOT, "mpi_opt_tpu_torch"), os.path.join(tree, "mpi_opt_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tree)
        want = plant_lint_faults(tree)
        (rc, stdout, probe, wall), (rc_p, stdout_p, _, wall_p) = _together(
            lambda: run_lint("--json"), lambda: run_lint(tree, "--json"))

        # (a) the port's tree: clean, the 19 checks and the project pass,
        # without torch or jax
        rep = json.loads(stdout)
        ids = [c["id"] for c in rep["checks"]]
        table = rep["project"] or {}
        a = {"rc": rc, "ok": rep["ok"], "files_scanned": rep["files_scanned"], "wall_s": wall,
             "checks_wall_s": sum(c["wall_s"] for c in rep["checks"]),
             "check_wall_s": {c["id"]: c["wall_s"] for c in rep["checks"]},
             "findings": len(rep["findings"]), "errors": rep["errors"],
             "imported_torch": probe.get("torch"), "imported_jax": probe.get("jax"),
             "project": {k: len(table.get(k) or ()) for k in
                         ("locks", "thread_entries", "signal_handlers", "beat_entries")}}
        a["project"]["lock_order_edges"] = len((table.get("lock_order") or {}).get("edges") or ())
        a["project"]["lock_order_cycles"] = len((table.get("lock_order") or {}).get("cycles") or ())
        out["tree"] = a
        print(f"lint ({smi}): {a['files_scanned']} files in {wall} s (checks {a['checks_wall_s']} s), "
              f"{a['findings']} findings, torch imported {a['imported_torch']}; per check "
              f"{json.dumps(a['check_wall_s'])}; project {json.dumps(a['project'])}")
        if rc != 0 or not rep["ok"] or rep["errors"] or rep["findings"]:
            return out, f"lint (a): exit {rc}, ok {rep['ok']}, {len(rep['findings'])} findings, errors {rep['errors']}"
        if ids != [*LINT_CHECKS, "project-table"]:
            return out, f"lint (a): checks {ids}"
        if probe.get("torch") is not False or probe.get("jax") is not False:
            return out, f"lint (a): the lint process imported torch/jax: {probe}"

        # (b) the planted tree: exactly the planted findings, exit 1; then
        # a baseline of them: exit 0, every one baselined
        def found(rows):
            return {(f["check"], os.path.relpath(os.path.join(ROOT, f["file"]), tree), f["line"])
                    for f in rows}

        rep_p = json.loads(stdout_p)
        got = found(rep_p["findings"])
        base = os.path.join(tmp, "baseline.json")
        rc_w, _, _, wall_w = run_lint(tree, "--write-baseline", base)
        rc_b, stdout_b, _, wall_b = run_lint(tree, "--baseline", base, "--json")
        rep_b = json.loads(stdout_b)
        b = {"planted": len(want), "rc": rc_p, "found": len(got), "missed": sorted(want - got),
             "unexpected": sorted(got - want), "files_scanned": rep_p["files_scanned"], "wall_s": wall_p,
             "write_baseline_rc": rc_w, "baseline_rc": rc_b, "baselined": len(rep_b["baselined"]),
             "after_baseline_findings": len(rep_b["findings"]), "baseline_walls_s": [wall_w, wall_b]}
        out["planted"] = b
        print(f"lint-planted ({smi}): {json.dumps(b)}")
        if rc_p != 1 or got != want:
            return out, f"lint (b): exit {rc_p}, missed {b['missed']}, unexpected {b['unexpected']}"
        if rc_w != 0 or rc_b != 0 or rep_b["findings"] or found(rep_b["baselined"]) != want:
            return out, (f"lint (b): --write-baseline exit {rc_w}, --baseline exit {rc_b}, "
                         f"{len(rep_b['findings'])} findings, {len(rep_b['baselined'])} baselined")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (c) the datasets ported last, on the card's host (no scikit-learn)
    out["datasets"] = {}
    for name, pinned in DATASET_SHA256.items():
        d = load_dataset(name, seed=0)
        rec = {k: {"shape": list(d[k].shape), "dtype": str(d[k].dtype),
                   "sha256": hashlib.sha256(d[k].tobytes()).hexdigest()} for k in pinned}
        rec["n_classes"] = d["n_classes"]
        out["datasets"][name] = rec
        print(f"dataset {name} ({smi}): {json.dumps(rec)}")
        bad = [k for k in pinned if rec[k]["sha256"] != pinned[k]]
        if bad:
            return out, f"lint (c): {name} {bad} differ from the JAX package's arrays"
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"lint phase wall ({smi}): {out['wall_s']} s")
    return out, None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline-cu", default=None,
                    help="the two-pass GroupNorm source of commit 788c451, "
                    "timed beside the kernels")
    ap.add_argument("--phases", default=None, metavar="LIST",
                    help="run only these phases after the build (comma-separated: "
                    f"{','.join(PHASES)}); a partial run prints no result line")
    args = ap.parse_args()
    phases = PHASES if args.phases is None else tuple(args.phases.split(","))
    if set(phases) - set(PHASES):
        return fail(f"unknown phases {sorted(set(phases) - set(PHASES))}; choose from {PHASES}")
    if not torch.cuda.is_available():
        return fail("CUDA is not available")
    sys.path.insert(0, ROOT)
    from mpi_opt_tpu_torch import bench, fused_pbt, get_workload
    from mpi_opt_tpu_torch.models import ResNet18, SmallCNN
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

    res_out = {"card": smi}  # every phase's record, for chiprun_out/chip_smoke.json
    launches = {}  # path -> kernel launches while it ran
    # seconds from the previous record (the build, for the first) to each
    # record: where the script's wall goes, record by record
    record_s, since = {}, [T_START]

    def done(name, rec):
        res_out[name] = rec
        now = time.perf_counter()
        record_s[name], since[0] = now - since[0], now
        out = os.path.join(ROOT, "chiprun_out", "chip_smoke.json")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out + ".tmp", "w") as f:
            json.dump({**res_out, "wall_s": now - T_START, "record_s": record_s,
                       "launches": launches}, f, indent=1)
        os.replace(out + ".tmp", out)

    if "kernels" in phases:
        # 3. kernels against their plain versions, then the models on card
        # vs CPU; f32 comparisons without TF32, restored for the paths after
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        tot, rows = kernel_phase(gn, bandwidth, base)
        clamp = clamp_check(gn)
        print("clamp-check " + json.dumps(clamp))
        model = model_check(ResNet18)
        print("model-check " + json.dumps(model))
        cnn_model = smallcnn_check(SmallCNN)
        print("smallcnn-check " + json.dumps(cnn_model))
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        print("kernel-totals " + json.dumps(tot))
        done("totals", tot)
        res_out.update(shapes=rows, clamp=clamp, model_check=model, smallcnn_check=cnn_model)

    if "slice" in phases:
        # 4. the ResNet-18 slice, through the entry points a user calls
        wl = get_workload("cifar100_resnet18")
        wl.data()  # host data generation is set-up, outside the timed sweep
        gens, steps = 2, 25
        torch.cuda.reset_peak_memory_stats()
        gn.reset_launches()
        t0 = time.perf_counter()
        res = fused_pbt(wl, population=P, generations=gens, steps_per_gen=steps, seed=0, gen_chunk=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["resnet18_p16"] = dict(gn.LAUNCHES)
        bad = sweep_fault(res, gens, launches["resnet18_p16"], "the ResNet-18 slice")
        if bad:
            return fail(bad)
        slice_out = {
            "population": P, "generations": gens, "steps_per_gen": steps,
            "wall_s": wall, "launch_walls_s": res["launch_walls"],
            "member_steps_per_s": P * gens * steps / wall,
            "member_steps_per_s_last_launch": P * steps / res["launch_walls"][-1],
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "best_score": res["best_score"], "best_curve": res["best_curve"].tolist(),
            "mean_curve": res["mean_curve"].tolist(), "launches": launches["resnet18_p16"],
        }
        print("slice " + json.dumps(slice_out))
        done("slice", slice_out)
        # 5. where a steady step's device time goes (measurement only)
        done("profile", profile_phase(wl, res))

    if "north_star" in phases:
        # 6. the north star: fused PBT over 256 full-width SmallCNN members
        # on CIFAR-10 through the port's bench (traced), at a cut depth
        gn.reset_launches()
        record, ns = bench.run(population=CNN_P, generations=NS_GENS, steps=NS_STEPS, seed=0,
                               member_chunk=CNN_CHUNK, gen_chunk=1)
        launches["smallcnn_p256"] = dict(gn.LAUNCHES)
        bad = sweep_fault(ns, NS_GENS, launches["smallcnn_p256"], "the north star")
        if bad:
            return fail(bad)
        record["launches"] = launches["smallcnn_p256"]
        print("north-star " + json.dumps(record))
        done("north_star", record)
        # the same run with cuDNN's deterministic algorithms, after the
        # default one above (a second default run after it was cut to make
        # room for phase 22)
        det = {"card": smi, "default": [record["value"]], "deterministic": [], "same_curve": []}
        torch.backends.cudnn.deterministic = True
        try:
            r, _ = bench.run(population=CNN_P, generations=NS_GENS, steps=NS_STEPS, seed=0,
                             member_chunk=CNN_CHUNK, gen_chunk=1)
        finally:
            torch.backends.cudnn.deterministic = False
        det["deterministic"].append(r["value"])
        det["same_curve"].append(r["best_curve"] == record["best_curve"])
        print("determinism-cost " + json.dumps(det))
        done("determinism_cost", det)
        # 7. where a steady north-star step's device time goes
        done("profile_smallcnn", profile_phase(get_workload("cifar10_cnn"), ns, member_chunk=CNN_CHUNK,
                                               label="profile-smallcnn"))

    if "mlp" in phases:
        # 8. a few steps of fashion_mlp (no GroupNorm): finite results
        wl = get_workload("fashion_mlp")
        wl.data()
        gn.reset_launches()
        mlp = fused_pbt(wl, population=16, generations=2, steps_per_gen=5, seed=0, gen_chunk=1)
        launches["fashion_mlp"] = dict(gn.LAUNCHES)
        bad = sweep_fault(mlp, 2, launches["fashion_mlp"], "the fashion_mlp sweep", kernels=False)
        if bad:
            return fail(bad)
        mlp_out = {"best_score": mlp["best_score"], "best_curve": mlp["best_curve"].tolist(),
                   "mean_curve": mlp["mean_curve"].tolist(), "launch_walls_s": mlp["launch_walls"]}
        print("fashion-mlp " + json.dumps(mlp_out))
        done("fashion_mlp", mlp_out)

    if "durability" in phases:
        # 9. durability: snapshots, ledger, drain and crash resumes through
        # the CLI, step_chunk, and the snapshot's cost at the north star's
        # population
        durability, launches["durability"], bad = durability_phase(gn, fused_pbt, get_workload, smi)
        print("durability " + json.dumps(durability))
        done("durability", durability)
        if bad:
            return fail(bad)

    # 10. the wave engine: (a) the north star in waves, traced and not, (b)
    # a real OOM absorbed by the CLI, (b2) one inside a member chunk's
    # launch width, (c) a drain between waves and its resume, (d) SHA
    # resident and in waves, (e) config 5's wave cap
    if "waves" in phases:
        waves, launches["north_star_waves"], bad = north_star_waves_phase(gn, fused_pbt, get_workload, smi)
        done("north_star_waves", waves)
        if bad:
            return fail(bad)
    # (b) and (b2) are independent subprocess drills, each process capped
    # on its own: at once (oom_drill's record_s then holds both)
    drills = {"oom": ("oom-drill", "oom_drill", oom_drill_phase),
              "oom_chunk": ("oom-chunk-drill", "oom_chunk_drill", oom_chunk_drill_phase)}
    drills = [v for k, v in drills.items() if k in phases]
    for (tag, name, _), (rec, bad) in zip(drills, _together(
            *[lambda fn=fn: fn(smi) for _, _, fn in drills]) if drills else ()):
        print(f"{tag} " + json.dumps(rec))
        done(name, rec)
        if bad:
            return fail(bad)
    if "drain" in phases:
        drain, bad = drain_waves_phase(smi)
        print("drain-drill " + json.dumps(drain))
        done("drain_drill", drain)
        if bad:
            return fail(bad)
    if "sha" in phases:
        sha, launches["sha"], bad = sha_phase(gn, get_workload, smi)
        done("sha", sha)
        if bad:
            return fail(bad)
    if "config5" in phases:
        done("config5", config5_phase(get_workload, smi))

    if "hyperband" in phases:
        # 11. fused Hyperband: (a) fashion_mlp through the CLI at its
        # defaults, (b) full-width SmallCNN resident and in waves
        hb_mlp, bad = hyperband_mlp_phase(smi)
        done("hyperband_mlp", hb_mlp)
        if bad:
            return fail(bad)
        hb_cnn, launches["hyperband_smallcnn"], bad = hyperband_cnn_phase(gn, get_workload, smi)
        done("hyperband_cnn", hb_cnn)
        if bad:
            return fail(bad)

    if "tpe" in phases:
        # 12. fused TPE: (a) config 4 at full size, (b) full-width SmallCNN
        # resident and in waves, (c) the CLI killed and resumed
        c4, bad = tpe_config4_phase(smi)
        done("tpe_config4", c4)
        if bad:
            return fail(bad)
        tpe_cnn, launches["tpe_smallcnn"], bad = tpe_cnn_phase(gn, get_workload, smi)
        done("tpe_cnn", tpe_cnn)
        if bad:
            return fail(bad)
        tpe_cli, bad = tpe_cli_phase(smi)
        done("tpe_cli", tpe_cli)
        if bad:
            return fail(bad)

    if "bohb" in phases:
        # 13. fused BOHB: (a) fashion_mlp through the CLI at its defaults,
        # (b) full-width SmallCNN resident and in waves
        bohb_mlp, bad = hyperband_mlp_phase(smi, "bohb")
        done("bohb_mlp", bohb_mlp)
        if bad:
            return fail(bad)
        bohb_cnn, launches["bohb_smallcnn"], bad = hyperband_cnn_phase(gn, get_workload, smi, "bohb")
        done("bohb_cnn", bohb_cnn)
        if bad:
            return fail(bad)

    if "mo" in phases:
        # 14. multi-objective: (a) config 8 at full size, (b) the CLI killed
        # and resumed, (c) the north star's width, (d) fused SHA
        c8, bad = mo_config8_phase(smi)
        done("mo_config8", c8)
        if bad:
            return fail(bad)
        mo_cli, bad = mo_cli_phase(smi)
        done("mo_cli", mo_cli)
        if bad:
            return fail(bad)
        mo_ns, launches["mo_smallcnn"], bad = mo_north_star_phase(gn, get_workload, smi)
        done("mo_north_star", mo_ns)
        if bad:
            return fail(bad)
        mo_sha, bad = mo_sha_phase(smi)
        done("mo_sha", mo_sha)
        if bad:
            return fail(bad)

    if "driver" in phases:
        # 15. the driver path: configs 2, 3 and 4's driver halves, the
        # ResNet-18 slot pool, the CLI drained and resumed
        drv, drv_launches, drv_errs, bad = driver_phase(gn, get_workload, smi)
        launches.update(drv_launches)
        done("driver", drv)
        if bad:
            return fail(bad)

    if "warm" in phases:
        # 16. a sweep's ledger read back: warm start on the fused and the
        # driver path, fsck and report
        warm, warm_launches, warm_errs, bad = warm_phase(gn, smi)
        launches.update(warm_launches)
        done("warm", warm)
        if bad:
            return fail(bad)

    if "cpu" in phases:
        # 17. the CPU path: config 1, the chaos and preempt drills, the
        # per-trial path on the card
        cpu_out, cpu_launches, cpu_errs, bad = cpu_phase(gn, smi)
        launches.update(cpu_launches)
        done("cpu", cpu_out)
        if bad:
            return fail(bad)

    if "windows" in phases:
        # 18. the measuring tools: profiled launch windows on the fused and
        # the driver path, trace --timeline, --diff and --gate
        win, win_launches, bad = windows_phase(gn, smi)
        launches.update(win_launches)
        done("windows", win)
        if bad:
            return fail(bad)

    if "mesh" in phases:
        # 19. multi-process: the ResNet-18 slice over 2 ranks through the
        # launch supervisor, pop-sharded, data-split and rank-killed
        mesh_out, mesh_launches, mesh_errs, bad = mesh_phase(gn, smi, bandwidth)
        launches.update(mesh_launches)
        done("mesh", mesh_out)
        if bad:
            return fail(bad)

    if "service" in phases:
        # 20. the sweep service: three tenants time-sliced in one server,
        # a server drained by signal and restarted, two servers on one
        # spool with one SIGKILLed, and the corpus warm start
        svc_out, svc_launches, svc_errs, bad = service_phase(gn, smi)
        launches.update(svc_launches)
        done("service", svc_out)
        if bad:
            return fail(bad)

    if "suggest" in phases:
        # 21. the suggestion service: configs 6 and 7 at full size, the
        # exactly-once drill, the acquisition card against CPU, a tenant
        # parked and resumed under serve
        sug_out, sug_launches, bad = suggest_phase(gn, smi)
        launches.update(sug_launches)
        done("suggest", sug_out)
        if bad:
            return fail(bad)

    if "lint" in phases:
        # 22. the static-analysis suite and the datasets ported last: the
        # port's lint over its own tree and over planted faults (with a
        # baseline), and the two tabular sets by digest (host only)
        lint_out, bad = lint_phase(smi)
        done("lint", lint_out)
        if bad:
            return fail(bad)

    # 23. no process left running
    left = stop_processes()
    if left:
        return fail(f"processes left running after the phases (killed now): {left}")
    print(f"chip_smoke wall: {time.perf_counter() - T_START} s")
    if phases != PHASES:
        print(f"chip_smoke: partial run ({','.join(phases)}): no result line")
        return 0

    # 24. the kernels line (a population step of each path, summed; launches
    # summed over every path), then the device line
    src = "mpi_opt_tpu_torch/csrc/group_norm.cu"
    kernels = []
    for k, line in (("gn_fwd", "mpi_opt_tpu/ops/pallas_gn.py:167"), ("gn_bwd", "mpi_opt_tpu/ops/pallas_gn.py:207")):
        entry = {"name": k, "route": "cuda", "source": src, "replaces": line,
                 "launches": sum(n[k] for n in launches.values()), "bound_by": "bytes"}
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            entry[key] = sum(tot[path][k][key] for path in STEP_PATHS)
        entry["max_abs_err"] = max(max(t[k]["max_abs_err"] for t in tot.values()), drv_errs[k],
                                   warm_errs[k], cpu_errs[k], mesh_errs[k], svc_errs[k])
        entry["bound_share"] = entry["bound_ms"] / entry["ms"]
        entry["by_path"] = {path: {**tot[path][k], "launches": launches[path][k]} for path in STEP_PATHS}
        for path in ("durability", "north_star_waves", "hyperband_smallcnn", "tpe_smallcnn", "bohb_smallcnn",
                     "mo_smallcnn", "driver_smallcnn", "driver_resnet18", "warm_smallcnn",
                     "pertrial_cifar10_cnn", "pertrial_cifar100_resnet18", "windows_resnet18",
                     "mesh_reference_resnet18", "mesh_data_resnet18", "service", "service_solo"):
            entry["by_path"][path] = {"launches": launches[path][k]}
        # the 2-rank path: both ranks' launches in (a), each rank's GN time
        # a population step at its shard shape (8 members folded in)
        entry["by_path"]["mesh_resnet18"] = {**mesh_out["rank_step_pop"][k],
                                             "launches": launches["mesh_resnet18"][k],
                                             "max_abs_err": mesh_errs[k]}
        kernels.append(entry)
    done("kernels", kernels)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    _become_subreaper()
    try:
        rc = main()
    finally:
        stop_processes()
    sys.exit(rc)

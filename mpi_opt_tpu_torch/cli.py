"""Command line of the port (port of ``mpi_opt_tpu/cli.py``: the driver
path on the gpu and cpu backends, the fused ``--algorithm
pbt|asha|random|hyperband|tpe|bohb`` paths, ``--warm-start`` on both, and
the ``trace``, ``report``, ``fsck`` and ``corpus`` subcommands, the
sweep service's ``serve``, ``submit``, ``status``, ``cancel`` and
``drain``, and the suggestion service: ``--suggest-serve`` behind its
filesystem spool or, with ``--http-port``, the HTTP front door, and
``suggest-client``).

    python -m mpi_opt_tpu_torch --workload fashion_mlp --algorithm asha \\
        --trials 64 --min-budget 10 --max-budget 270 --eta 3 --population 64 \\
        [--ledger L] [--checkpoint-dir C [--resume]] [--trial-retries N] \\
        [--max-failure-rate F] [--device cpu]
    python -m mpi_opt_tpu_torch --workload cifar10_cnn --algorithm pbt --fused \\
        --population 32 --generations 4 --steps-per-generation 20 \\
        --checkpoint-dir ck --ledger sweep.jsonl [--resume] [--device cpu]
    python -m mpi_opt_tpu_torch --workload fashion_mlp --algorithm asha --fused \\
        --trials 64 --min-budget 10 --max-budget 270 --eta 3 [--wave-size 16|auto]
    python -m mpi_opt_tpu_torch --workload fashion_mlp --algorithm hyperband --fused \\
        --max-budget 270 --eta 3 --trace --metrics-file m.jsonl
    python -m mpi_opt_tpu_torch --workload tabular_mlp --algorithm tpe --fused \
        --trials 256 --population 64 --budget 30
    python -m mpi_opt_tpu_torch --workload fashion_mlp --algorithm bohb --fused \
        --max-budget 270 --eta 3
    python -m mpi_opt_tpu_torch --workload digits_mlp --algorithm pbt --fused \
        --population 8 --generations 3 --steps-per-generation 40 \
        --objectives "accuracy:max,params:min"
    python -m mpi_opt_tpu_torch --workload tabular_mlp --algorithm tpe --fused \
        --trials 256 --population 64 --budget 30 --warm-start prior.jsonl
    python -m mpi_opt_tpu_torch --workload cifar100_resnet18 --algorithm pbt --fused \
        --population 16 --generations 3 --steps-per-generation 5 \
        --profile-dir prof --profile-launches 2:2
    python -m mpi_opt_tpu_torch trace m.jsonl [--json] [--timeline t.json]
    python -m mpi_opt_tpu_torch trace --diff base.jsonl new.jsonl [--gate tol.json]
    python -m mpi_opt_tpu_torch report sweep.jsonl [--json] [--validate]
    python -m mpi_opt_tpu_torch fsck ck [--ledger sweep.jsonl] [--repair] [--deep] [--json]
    python -m mpi_opt_tpu_torch corpus index DIR; python -m mpi_opt_tpu_torch corpus resolve \\
        DIR --workload tabular_mlp; ... --warm-start auto:DIR
    python -m mpi_opt_tpu_torch submit --state-dir SD --tenant a -- --workload fashion_mlp \\
        --algorithm pbt --fused --population 4 --generations 4 --gen-chunk 1
    python -m mpi_opt_tpu_torch serve --state-dir SD [--platform cpu] [--slice-boundaries N] \\
        [--drain-on-empty]; status|drain --state-dir SD; cancel --state-dir SD JOB
    python -m mpi_opt_tpu_torch.launch --n-proc 2 -- --workload cifar100_resnet18 \
        --algorithm pbt --fused --n-pop 2 --population 16 --generations 3 \
        --steps-per-generation 5 [--checkpoint-dir ck --ledger sweep.jsonl]
    python -m mpi_opt_tpu_torch --workload tabular_mlp --suggest-serve SDIR \
        [--http-port 0 [--http-queue 64] [--http-state-dir SD]] [--ledger L [--resume]] \
        [--suggest-idle-timeout S] [--warm-start auto:DIR] [--device cpu]
    python -m mpi_opt_tpu_torch suggest-client --dir SDIR suggest -n 8   # or --url URL

Multi-process SPMD: ``--coordinator HOST:PORT --num-processes N
--process-id R`` (which ``launch.py`` passes to each rank) brings up a
``torch.distributed`` process group, one rank a device (gloo when ranks
share a card or run with ``--device cpu``, nccl with a card each); the
fused sweeps and the gpu slot pool then shard over a ``('pop', 'data')``
mesh (``--n-pop``, ``--n-data``, ``--no-mesh``), boundaries agree
through ``--coord-dir``, and only rank 0 writes the ledger and the
snapshots.

Without ``--fused`` the sweep is the JAX CLI's driver path:
``driver.run_search`` over a host algorithm and the ``gpu`` backend, the
device-resident slot pool (``backends/gpu.py``; ``--population`` is its
capacity). It runs on CUDA unless ``--device cpu`` is given.
``--backend cpu`` (the JAX CLI's default) evaluates one trial a process
on the host instead (``backends/cpu.py``: ``--workers``,
``--trial-timeout``, ``--isolate-stateful``), and takes the per-trial
workloads (``quadratic``, ``digits``) and the seeded ``--chaos`` drills:

    python -m mpi_opt_tpu_torch --backend cpu --workload digits --algorithm random \\
        --trials 16 --budget 100 --workers 1
    python -m mpi_opt_tpu_torch --backend cpu --workload quadratic --trials 32 \\
        --workers 4 --trial-timeout 2 --chaos exc=0.1,nan=0.1,hang=0.05,seed=7

The summary is the JAX CLI's single JSON line (after the metrics
events), and so are the exit codes: 0 done; 1 the driver's failure-rate
breaker tripped; 2 usage; 65 a data dead-end (no verified snapshot, or a ledger
that diverges from or lags the sweep); 74 a device OOM or a full disk;
75 a graceful drain on SIGTERM/SIGINT, with the snapshot flushed: rerun
with ``--resume``. Every subcommand of the JAX CLI runs here too,
``lint`` (``analysis/``, the port's sweeplint over the port's tree)
among them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from mpi_opt_tpu_torch.health import SweepInterrupted
from mpi_opt_tpu_torch.health import heartbeat as _heartbeat
from mpi_opt_tpu_torch.health import shutdown as _shutdown
from mpi_opt_tpu_torch.obs import trace as _trace
from mpi_opt_tpu_torch.ops.pbt import PBTConfig
from mpi_opt_tpu_torch.service import SUBCOMMANDS as SERVICE_SUBCOMMANDS
from mpi_opt_tpu_torch.service import service_main
from mpi_opt_tpu_torch.utils import integrity, resources
from mpi_opt_tpu_torch.utils.exitcodes import EX_DATAERR, EX_IOERR, EX_TEMPFAIL
from mpi_opt_tpu_torch.utils.integrity import NoVerifiedSnapshotError
from mpi_opt_tpu_torch.utils.metrics import stdout_logger
from mpi_opt_tpu_torch.utils.profiling import parse_launch_window, profile_window
from mpi_opt_tpu_torch.workloads import _REGISTRY, get_workload

# the JAX CLI's algorithms; the port runs every one, fused and driver
ALGORITHMS = ("asha", "bohb", "hyperband", "pbt", "random", "tpe")
#: the environment variable the sweep service sets around a traced
#: slice: the tenant tag stamped into the slice's span records (env, not
#: a flag, so the argv the tenant submitted stays exactly its own)
TRACE_TAG_ENV = "MPI_OPT_TPU_TRACE_TAG"

def _wire_integrity_observer(metrics):
    """Snapshot-corruption events into this run's metrics stream; each
    ``snapshot_corrupt`` also counts one quarantine."""

    def observe(event, **fields):
        metrics.log(event, **fields)
        if event == "snapshot_corrupt":
            metrics.count_quarantined()

    integrity.set_observer(observe)


def _wire_resource_observer(metrics):
    """Resource events (``oom_backoff``, ``wave_resized``,
    ``snapshot_pruned``) into the metrics stream and its counters."""

    def observe(event, **fields):
        metrics.log(event, **fields)
        if event == "oom_backoff":
            metrics.count_oom_backoffs()
        elif event == "wave_resized":
            metrics.count_wave_resized()
        elif event == "snapshot_pruned":
            metrics.count_pruned()

    resources.set_observer(observe)


def _resource_exit(e, metrics, kind: str, **summary_fields) -> int:
    """A device OOM or a disk still full after the prune retry: durable
    state is intact, but a retry without operator action fails the same
    way, so exit ``EX_IOERR`` (74)."""
    metrics.summary(final=True)
    print(json.dumps({"resource_exhausted": str(e), "kind": kind, **summary_fields}))
    hint = ("free disk space, then relaunch with --resume" if kind == "storage_full"
            else "reduce residency: --wave-size auto (wave mode backs off automatically "
            "via --oom-backoff), smaller --population, or --member-chunk")
    print(f"{e}\n({hint}; exit {EX_IOERR})", file=sys.stderr)
    return EX_IOERR


def _data_error_exit(e, metrics, **summary_fields) -> int:
    """No verified snapshot remains, or the journal diverges from the
    sweep: a retry re-reads the same state, so exit ``EX_DATAERR`` (65)."""
    metrics.summary(final=True)
    print(json.dumps({"data_error": str(e), **summary_fields}))
    print(f"{e}\n(no retry can help: exit {EX_DATAERR})", file=sys.stderr)
    return EX_DATAERR


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_opt_tpu_torch",
        description="hyperparameter optimization on an NVIDIA GPU (the PyTorch port)",
    )
    p.add_argument("--workload", required=True, choices=sorted(_REGISTRY))
    p.add_argument("--algorithm", default="random", choices=ALGORITHMS)
    p.add_argument("--backend", default="gpu",
                   help="driver-path execution backend: gpu, the device-resident slot pool "
                   "(the default: the port runs on the card unless asked otherwise), or cpu, "
                   "a process pool that evaluates one trial a process on the host (the JAX "
                   "CLI's default; its tpu backend is the port's gpu)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trials", type=int, default=16, help="total trials (random/tpe/asha)")
    p.add_argument("--budget", type=int, default=100, help="steps per trial (random/tpe)")
    p.add_argument("--workers", type=int, default=0, help="cpu backend: processes (0=auto)")
    p.add_argument("--metrics-file", default=None, help="JSONL metrics output path")
    p.add_argument("--trace", action="store_true",
                   help="emit span records (setup/train/staging/boundary/journal/save "
                   "phase durations, obs/trace.py) into --metrics-file (required); render "
                   "them with `python -m mpi_opt_tpu_torch trace FILE`. Off by default: an "
                   "untraced sweep does no tracing work")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the sweep here: one Chrome "
                   "trace-event JSON a window, <host>_<pid>.run.pt.trace.json (or "
                   ".launches_<A>-<B>.pt.trace.json), which Perfetto and TensorBoard load; "
                   "CPU activity, plus CUDA kernels on the card. A profiled launch is not "
                   "comparable to an unprofiled one")
    p.add_argument("--profile-launches", default=None, metavar="N|A:B",
                   help="with --profile-dir: profile only this launch window (1-based, "
                   "inclusive: fused launches/rungs/generations/wave intervals, or driver "
                   "batches, counted as the JAX CLI counts them) instead of the whole run; "
                   "e.g. 2:3 skips the first launch's cuDNN autotuning")
    p.add_argument("--ledger", default=None, metavar="PATH",
                   help="journal every final trial result (driver path) or one record per "
                   "population member at every generation (--fused), fsync'd per record; with "
                   "--resume the driver replays it and a fused sweep verifies against it")
    p.add_argument("--trial-retries", type=int, default=0,
                   help="driver path: re-evaluate a failed trial up to this many times "
                   "(jittered exponential backoff) before reporting it failed")
    p.add_argument("--trial-timeout", type=float, default=None, metavar="SECONDS",
                   help="cpu backend: per-trial evaluation deadline; a trial still running "
                   "past it is reaped as a 'timeout' result and its worker pool recycled "
                   "(unset = wait forever)")
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="fault-injection drill (driver path, cpu backend): wrap the workload "
                   "in seeded chaos, e.g. 'exc=0.1,nan=0.05,hang=0.02,slow=0.1,seed=7' "
                   "(probabilities per fault; preempt= drills the graceful-shutdown protocol; "
                   "hang_s=/slow_s= tune durations). Faults are a deterministic function of "
                   "(seed, trial params)")
    p.add_argument("--isolate-stateful", action="store_true",
                   help="cpu backend: evaluate stateful workloads (PBT inheritance, ASHA warm "
                   "resume) in a dedicated worker process holding the state store, instead of "
                   "in-parent, so --trial-timeout holds there (a hung trial is reaped as "
                   "status=timeout and the worker respawned; its state store resets)")
    p.add_argument("--max-failure-rate", type=float, default=1.0,
                   help="driver path: abort the sweep (exit 1) once more than this fraction of "
                   "final trial results failed (after 20 evaluations); 1.0 disables")
    p.add_argument("--warm-start", default=None, metavar="PATH",
                   help="feed a PRIOR sweep's ledger into this sweep as observations before "
                   "the search starts (TPE/BOHB build surrogate priors, fused TPE pre-fills "
                   "its on-device ring; random/asha/hyperband/pbt seed one member with the "
                   "prior best). Cross-mode: a fused ledger warm-starts a driver sweep and "
                   "the reverse; the only gate is the space hash. 'auto:DIR' resolves the "
                   "priors through DIR's ledger corpus (corpus/resolve.py): every same-space "
                   "ledger merged, same-workload structurally compatible ones down-weighted "
                   "at budget 0; audit it first with `corpus resolve DIR --workload W`")
    p.add_argument("--checkpoint-dir", default=None,
                   help="verified snapshots written here, at launch (fused) or batch (driver) "
                   "granularity")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="launches (fused) or batches (driver) between snapshots")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest verified snapshot in --checkpoint-dir "
                   "(starts fresh if it holds none)")
    p.add_argument("--min-budget", type=int, default=10)
    p.add_argument("--max-budget", type=int, default=270)
    p.add_argument("--eta", type=int, default=3)
    p.add_argument("--population", type=int, default=32,
                   help="PBT's population; fused TPE's batch (trials a generation); the "
                   "driver path's slot-pool capacity (trials a batch)")
    p.add_argument("--generations", type=int, default=10)
    p.add_argument("--steps-per-generation", type=int, default=200)
    p.add_argument("--truncation", type=float, default=0.25)
    p.add_argument("--fused", action="store_true",
                   help="run the whole sweep as device programs, without the driver loop")
    p.add_argument("--member-chunk", type=int, default=0,
                   help="process members in chunks of this size (activation memory)")
    p.add_argument("--gen-chunk", type=int, default=0,
                   help="generations per launch (the split is bit-identical)")
    p.add_argument("--step-chunk", type=int, default=0,
                   help="training steps per sub-launch within a generation (bit-identical "
                   "in the port; recorded in the snapshot config)")
    p.add_argument("--wave-size", default="0", metavar="N|auto",
                   help="train the cohort in waves of N members a generation/rung, "
                   "staging the others in host memory (copies overlap compute); the "
                   "exploit or rung cut still sees the whole cohort. 'auto' sizes the wave "
                   "from a residency estimate; 0 runs resident. Bit-identical to resident "
                   "on the CPU")
    p.add_argument("--oom-backoff", type=int, default=2, metavar="N",
                   help="wave mode: on a device OOM halve the wave size and re-run the "
                   "generation/rung, up to N times (0 disables); also clamps an explicit "
                   "--wave-size to the measured device budget. A resident or post-budget "
                   "OOM exits 74")
    p.add_argument("--retries", type=int, default=0,
                   help="retry the sweep this many times on a transient I/O failure; "
                   "with --checkpoint-dir each retry resumes at the last snapshot")
    p.add_argument("--heartbeat-file", default=None, metavar="PATH",
                   help="write a monotonic progress beat (atomic JSON rewrite) to this file "
                   "at every launch boundary and, with --step-chunk, every training "
                   "sub-launch: the liveness signal an external watchdog reads")
    p.add_argument("--objectives", default=None, metavar="SPEC",
                   help='fused pbt/asha: multi-objective search, e.g. "accuracy:max,params:min<=2e4": '
                   "comma-separated name:direction terms, each optionally constrained (<= for "
                   "min, >= for max). The exploit or rung cut ranks by Pareto front and "
                   "crowding on the device; the winner is the best feasible member, or the "
                   "least violating one when none is. The ledger journals each member's "
                   "objective vector beside the scalarized primary score")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where the sweep runs (default cuda, or cpu under --backend cpu; "
                   "the port never falls back to the CPU on its own)")
    p.add_argument("--platform", default=None, choices=("cpu", "gpu"),
                   help="the JAX CLI's name for --device: cpu is --device cpu, gpu is "
                   "--device cuda (both given, they must agree)")
    p.add_argument("--local-devices", type=int, default=None,
                   help="the JAX CLI's virtual CPU devices; a port rank owns one device, so "
                   "it is a usage error: launch N ranks instead")
    # multi-process SPMD bring-up: one process a device, each invoking
    # this CLI with its rank (launch.py passes these)
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process SPMD: rank 0's address for the torch.distributed "
                   "process group (tcp://HOST:PORT); give --num-processes and --process-id "
                   "with it on every rank (python -m mpi_opt_tpu_torch.launch does)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-process SPMD: the world size (with --coordinator)")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-process SPMD: this process's rank (with --coordinator)")
    p.add_argument("--multihost", action="store_true",
                   help="bring up the process group from torch's env:// variables "
                   "(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); fails rather than "
                   "silently running one process. Implied by --coordinator")
    p.add_argument("--n-data", type=int, default=1,
                   help="mesh 'data' axis: ranks that split each member's minibatch and "
                   "average its gradients (ranks are split as (world/n_data) x n_data)")
    p.add_argument("--n-pop", type=int, default=0,
                   help="mesh 'pop' axis: ranks that split the members (0 = all remaining)")
    p.add_argument("--no-mesh", action="store_true",
                   help="no ('pop','data') mesh even in a multi-process world")
    p.add_argument("--coord-dir", default=None, metavar="DIR",
                   help="multi-process SPMD: the boundary-agreement directory (per-rank vote "
                   "files, rank-0 decisions); launch.py sets it for every rank")
    p.add_argument("--coord-epoch", type=int, default=0, metavar="N",
                   help="with --coord-dir: this attempt's vote namespace; each coordinated "
                   "restart needs a fresh one (launch.py passes its relaunch counter)")
    p.add_argument("--coord-timeout", type=float, default=300.0, metavar="SECONDS",
                   help="how long a rank waits for its peers at an agreement boundary, and "
                   "at any collective of the process group, before it declares the world "
                   "wedged and exits (the supervisor's coordinated restart recovers)")
    p.add_argument("--rank-kill", default=None, metavar="SPEC",
                   help="chaos drill: 'rank=R,at=K[,n=N][,marker=PATH]' SIGKILLs the rank R "
                   "process at the K-th (1-based) launch/rung/generation boundary; marker "
                   "makes the kill fire once across coordinated restarts")
    # the suggestion service (corpus/serve.py): instead of sweeping,
    # answer suggest/report/lookup traffic for outside sweeps
    p.add_argument("--suggest-serve", default=None, metavar="DIR",
                   help="run as a resident suggestion server over this filesystem spool instead "
                   "of sweeping: answers suggest/report/lookup requests (`suggest-client`) from "
                   "the batched TPE acquisition, on the card unless --device cpu, over "
                   "--workload's space, warm-started by --warm-start (auto:DIR too). Submittable "
                   "to the sweep service unchanged: every served request is a boundary, so "
                   "`serve` time-slices it like a sweep; with --ledger every report journals and "
                   "--resume rebuilds the ring")
    p.add_argument("--suggest-idle-timeout", type=float, default=None, metavar="S",
                   help="with --suggest-serve: exit 0 (done) after S seconds with no requests "
                   "(unset: stay resident until `suggest-client stop` or a drain)")
    # the HTTP front door (service/http.py) in front of the suggestion server
    p.add_argument("--http-port", type=int, default=None, metavar="PORT",
                   help="with --suggest-serve: serve the HTTP front door on this port instead "
                   "of the filesystem request spool (0: an ephemeral port, published atomically "
                   "to DIR/control/http.json). Batched ops share one journal fsync; overload "
                   "sheds with typed 503s; idempotency keys make client retries exactly-once")
    p.add_argument("--http-queue", type=int, default=64, metavar="N",
                   help="with --http-port: the admission queue's bound; requests beyond it shed "
                   "with 503 and Retry-After instead of queueing without bound")
    p.add_argument("--http-state-dir", default=None, metavar="DIR",
                   help="with --http-port: also expose the sweep service's submit/status/cancel "
                   "ops over HTTP against this service state dir (the spool stays the "
                   "durability layer; fencing tokens stay the authority)")
    return p


def _rank_world() -> tuple[int, int]:
    """(rank, world) of this process (0, 1 without a process group)."""
    from mpi_opt_tpu_torch.parallel.mesh import world_info

    info = world_info()
    return info["rank"], info["world"]


def build_mesh(args):
    """The run's ``('pop', 'data')`` mesh, or None for one process.
    Auto-meshes whenever the world has more than one rank (the JAX
    CLI's ``jax.device_count() > 1``: a port rank owns one device);
    explicit ``--n-data``/``--n-pop`` force a shape, ``--no-mesh`` opts
    out."""
    if args.no_mesh:
        if args.n_data > 1 or args.n_pop > 0:
            raise SystemExit("--no-mesh contradicts --n-data/--n-pop")
        return None
    _, world = _rank_world()
    if world > 1 or args.n_data > 1 or args.n_pop > 0:
        from mpi_opt_tpu_torch.parallel.mesh import make_mesh

        return make_mesh(n_pop=args.n_pop or None, n_data=args.n_data)
    return None


def _run_mesh(args, parser, metrics):
    """The run's mesh (``build_mesh``; a shape the world cannot hold is
    a usage error), with the ``launch`` event naming the world's backend
    and device (chosen from counts at bring-up) in a multi-process
    world; per-chip rates then count every device of the mesh."""
    from mpi_opt_tpu_torch.parallel.mesh import world_info

    try:
        mesh = build_mesh(args)
    except ValueError as e:
        parser.error(f"mesh: {e}")
    info = world_info()
    if info["world"] > 1:
        metrics.log("launch", rank=info["rank"], world=info["world"], backend=info["backend"],
                    device=str(info["device"]),
                    mesh=None if mesh is None else dict(mesh.shape))
    if mesh is not None:
        metrics.n_chips = mesh.size
    return mesh


def _install_multiprocess(args, parser):
    """The coord plane's boundary agreements (``--coord-dir``) and the
    ``--rank-kill`` drill, installed for the run; returns the closure
    that uninstalls them (callers pair it in a ``finally``)."""
    from mpi_opt_tpu_torch.parallel import coord as _coord
    from mpi_opt_tpu_torch.parallel.mesh import world_info
    from mpi_opt_tpu_torch.workloads.chaos import inject_rank_kill, parse_rank_kill_spec

    spec = None
    if args.rank_kill:
        try:
            spec = parse_rank_kill_spec(args.rank_kill)
        except ValueError as e:
            parser.error(f"--rank-kill: {e}")
    undo = []
    if args.coord_dir:
        info = world_info()
        plane = _coord.CoordPlane(args.coord_dir, info["rank"], info["world"],
                                  epoch=args.coord_epoch, timeout_s=args.coord_timeout)
        undo.append(_coord.install_hook(plane))
    if spec is not None:
        undo.append(inject_rank_kill(**spec)[1])

    def uninstall():
        for fn in reversed(undo):
            fn()

    return uninstall


def _open_rank_ledger(args, parser, metrics):
    """``--ledger`` opened for this rank: rank 0 writes, every other
    rank reads the shared journal (replay and verification stay
    identical on every rank; N ranks appending one file would corrupt
    it)."""
    from mpi_opt_tpu_torch.ledger import LedgerError, SweepLedger

    rank, _ = _rank_world()
    try:
        ledger = SweepLedger(args.ledger, read_only=rank != 0)
    except LedgerError as e:
        parser.error(f"--ledger: {e}")
    if ledger.read_only:
        metrics.log("ledger_rank_gated", rank=rank)
    return ledger


_TRANSIENT_MARKERS = ("unavailable", "deadline", "connection reset", "timed out")


def _is_transient(e: BaseException) -> bool:
    """Retry-worthy errors: a transport-layer ``OSError`` whose message
    names the failure as transient. A CUDA error is never retried in the
    process: the CUDA context does not survive it."""
    return isinstance(e, OSError) and not resources.is_storage_full(e) and any(
        m in str(e).lower() for m in _TRANSIENT_MARKERS
    )


def _run_with_retries(launch, retries: int, metrics):
    """Run ``launch()``; on a transient failure retry up to ``retries``
    times (with a checkpoint directory each retry is a resume)."""
    attempt = 0
    while True:
        try:
            return launch()
        except Exception as e:
            if attempt >= retries or not _is_transient(e):
                if attempt:
                    metrics.log("retry_exhausted", attempts=attempt,
                                error=f"{type(e).__name__}: {e}"[:1000])
                raise
            attempt += 1
            metrics.log("retry", attempt=attempt, of=retries, error=f"{type(e).__name__}: {e}"[:300])


def _finite_or_null(obj):
    """Non-finite floats become null at the JSON boundary (strict JSON
    has no NaN); the result dicts keep their NaNs."""
    import math

    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _finite_or_null(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite_or_null(v) for v in obj]
    return obj


def _has_snapshot(directory) -> bool:
    """Does a committed sweep snapshot live under ``directory``? A step
    is a numeric directory holding the port's commit marker, so an
    unrelated numeric directory does not count."""
    if not directory or not os.path.isdir(directory):
        return False
    for root, dirs, _files in os.walk(directory):
        for d in dirs:
            if d.isdigit() and os.path.exists(os.path.join(root, d, integrity.COMMIT_MARKER)):
                return True
    return False


def _resolve_warm_start(args, space, parser, metrics=None):
    """``--warm-start`` resolution, shared by both paths: returns
    ``(warm_obs, warm_info)``, the observations to ingest and the event
    payload (``sources`` naming every contributing ledger with its match
    kind, ``skips`` counting the records that could not become
    observations). ``auto:DIR`` resolves through the corpus under DIR
    (``corpus/resolve.py``; degraded entries become ``corpus_skip``
    events on ``metrics``). A bad path, a space hash mismatch, this
    run's own ledger or a malformed ``auto`` spec is ``parser.error``
    (exit 2), before any ledger header commits."""
    from mpi_opt_tpu_torch.ledger import LedgerError
    from mpi_opt_tpu_torch.ledger.warmstart import load_observations

    spec = args.warm_start
    if spec == "auto" or spec.startswith("auto:"):
        corpus_dir = spec[len("auto:"):] if spec.startswith("auto:") else ""
        if not corpus_dir:
            parser.error("--warm-start auto needs a corpus root: --warm-start auto:DIR")
        if not os.path.isdir(corpus_dir):
            parser.error(f"--warm-start auto: {corpus_dir!r} is not a directory")
        from mpi_opt_tpu_torch.corpus.resolve import resolve

        # exclude= is the auto path's self-warm-start guard: this run's
        # own --ledger may live under the corpus root
        res = resolve(space, corpus_dir, workload=args.workload, exclude=args.ledger,
                      metrics=metrics)
        return res.observations, {"sources": res.sources, "skips": res.skips or None}
    # realpath: './sweep.jsonl' against 'sweep.jsonl' (or a symlink) still
    # feeds this run's own journal back into it
    if args.ledger and os.path.realpath(spec) == os.path.realpath(args.ledger):
        parser.error("--warm-start must name a PRIOR sweep's ledger, not this run's --ledger "
                     "(resuming this sweep is --ledger --resume)")
    try:
        obs, skips = load_observations(spec, space)
    except (LedgerError, OSError) as e:
        parser.error(f"--warm-start: {e}")
    return obs, {
        "sources": [{"path": spec, "match": "exact", "records": len(obs)}],
        "skips": skips or None,
    }


def _log_warm_start(metrics, args, warm_info, observations: int) -> None:
    """The ``warm_start`` event: ``observations`` is what informed the
    search (the algorithm's own count on the driver path), ``sources``
    the ledger, ``skipped`` the per-record losses."""
    metrics.log("warm_start", path=args.warm_start, observations=observations,
                sources=(warm_info or {}).get("sources"), skipped=(warm_info or {}).get("skips"))


def run_fused(args, parser, workload) -> int:
    """--fused: the whole sweep on the device (``train.fused_pbt``, or
    ``train.fused_asha.fused_sha`` for asha and random), resident or in
    waves, with the JAX CLI's summary line and exit codes."""
    import time

    from mpi_opt_tpu_torch.ledger import LedgerError
    from mpi_opt_tpu_torch.workloads.base import PopulationWorkload

    if not isinstance(workload, PopulationWorkload):
        parser.error(f"--fused requires a population workload, not {args.workload!r}")
    if args.objective_spec is not None:
        from mpi_opt_tpu_torch.train.common import check_objectives

        try:
            check_objectives(workload, args.objective_spec)
        except ValueError as e:
            parser.error(f"--objectives: {e}")
    # resuming is explicit: a stale checkpoint directory must not
    # silently continue an old sweep
    if args.checkpoint_dir and not args.resume and _has_snapshot(args.checkpoint_dir):
        parser.error(
            f"--checkpoint-dir {args.checkpoint_dir!r} already holds a sweep snapshot; "
            "pass --resume to continue it, or point at a fresh directory"
        )
    rank, world = _rank_world()
    if args.retries and world > 1:
        # one rank restoring a snapshot while its peers sit in a
        # collective would wedge the world: recovery is a job restart
        parser.error(
            "--retries requires a single-process run; under multi-process SPMD recovery is "
            "a coordinated job restart: run under `python -m mpi_opt_tpu_torch.launch "
            "--retries N`, which relaunches ALL ranks with --resume and a fresh --coord-epoch"
        )
    metrics = stdout_logger(path=args.metrics_file, n_chips=1)
    mesh = _run_mesh(args, parser, metrics)
    if mesh is not None and args.algorithm in ("pbt", "tpe"):
        n_pop = int(mesh.shape["pop"])
        # a standing cohort that the pop axis does not divide would be
        # replicated on every rank; SHA-family sweeps round their
        # cohorts to the axis instead
        if args.population % n_pop and args.population > n_pop:
            lo = (args.population // n_pop) * n_pop
            parser.error(
                f"--population {args.population} does not divide the mesh 'pop' axis "
                f"({n_pop}); the population would be replicated on every device instead of "
                f"sharded. Use --population {lo} or {lo + n_pop}, reshape the mesh with "
                "--n-pop/--n-data, or pass --no-mesh."
            )
    _wire_integrity_observer(metrics)
    _wire_resource_observer(metrics)
    if args.trace:  # main restores the entry state on the way out
        _trace.configure(metrics, rank=rank, tenant=os.environ.get(TRACE_TAG_ENV))
    space = workload.default_space()
    # the prior ledger validates BEFORE this run's own header commits: a
    # typo'd --warm-start must not enter a fresh ledger's identity
    warm_obs = None
    if args.warm_start:
        warm_obs, warm_info = _resolve_warm_start(args, space, parser, metrics)
        _log_warm_start(metrics, args, warm_info, len(warm_obs))
    ledger = _open_fused_ledger(args, parser, space, metrics)
    multiprocess_off = _install_multiprocess(args, parser)
    t0 = time.perf_counter()
    fields = dict(workload=args.workload, algorithm=args.algorithm, backend="fused")
    try:
        with resources.oom_funnel(), profile_window(args.profile_dir, launches=args.profile_window,
                                                    device=args.device):
            return _run_fused_dispatch(args, workload, metrics, t0, ledger, warm_obs, mesh)
    except resources.DeviceOOM as e:
        return _resource_exit(e, metrics, "device_oom", **fields)
    except resources.StorageFull as e:
        return _resource_exit(e, metrics, "storage_full", **fields)
    except (NoVerifiedSnapshotError, LedgerError) as e:
        return _data_error_exit(e, metrics, **fields)
    except SweepInterrupted as e:
        # the drained launch's snapshot is flushed: --resume continues
        metrics.count_preempted()
        metrics.summary(final=True)
        print(json.dumps({"preempted": True, "signal": e.signal, "at": e.at, **fields}))
        print(f"graceful shutdown ({e.signal}) at {e.at}: snapshot flushed; "
              f"relaunch with --resume to continue (exit {EX_TEMPFAIL})", file=sys.stderr)
        return EX_TEMPFAIL
    finally:
        multiprocess_off()
        if ledger is not None:
            ledger.close()
        metrics.close()


def run_suggest_serve(args, parser, workload) -> int:
    """--suggest-serve DIR: the suggestion-service tenant
    (``corpus/serve.py``). Instead of sweeping, this process answers
    suggest/report/lookup traffic over DIR (or, with ``--http-port``,
    through the HTTP front door), the acquisition on ``--device``. Its
    lifecycle is a sweep's, so the sweep service can own it: a drain
    (slice budget, SIGTERM, cancel) parks it with exit 75, every acked
    report already fsync-journaled, and ``--ledger --resume`` rebuilds
    the ring on the next slice; the stop flag or the idle timeout
    completes it (exit 0)."""
    from mpi_opt_tpu_torch.corpus.serve import SuggestServer, serve_loop
    from mpi_opt_tpu_torch.ledger import LedgerError, SweepLedger

    space = workload.default_space()
    metrics = stdout_logger(path=args.metrics_file, n_chips=1)
    if args.trace:  # main restores the entry state on the way out
        _trace.configure(metrics, tenant=os.environ.get(TRACE_TAG_ENV))
    server = SuggestServer(space, seed=args.seed, device=args.device)
    # the corpus warm start resolves BEFORE the ledger header commits, as
    # on the sweep paths
    warm_obs = warm_info = None
    if args.warm_start:
        warm_obs, warm_info = _resolve_warm_start(args, space, parser, metrics)
    ledger = None
    if args.ledger:
        try:
            # one process owns its spool directory: the ledger is writable
            ledger = SweepLedger(args.ledger, read_only=False)
        except LedgerError as e:
            parser.error(f"--ledger: {e}")
        if ledger.records and not args.resume:
            ledger.close()
            parser.error(
                f"--ledger {args.ledger!r} already holds {len(ledger.records)} report records; "
                "pass --resume to rebuild the ring from them, or point at a fresh path"
            )
        try:
            ledger.ensure_header(
                {
                    "mode": "suggest",
                    "algorithm": "tpe",
                    "workload": args.workload,
                    "backend": "suggest",
                    "seed": args.seed,
                    "space_hash": space.space_hash(),
                    "warm_start": args.warm_start,
                },
                space_spec=space.spec(),
            )
        except LedgerError as e:
            ledger.close()
            parser.error(f"--ledger: {e}")
        if ledger.n_torn:
            metrics.log("ledger_torn_tail_dropped", path=args.ledger)
        if ledger.records:
            # resume: the server's own journaled reports rebuild the ring
            # and the cache, and the report serial continues past them
            server.seed_from_ledger(ledger.records)
            metrics.log("ledger_replay", completed=len(ledger.records))
    if warm_obs is not None:
        n_warm = server.ingest(warm_obs)
        _log_warm_start(metrics, args, warm_info, n_warm)
    metrics.log("suggest_serve", workload=args.workload, n_obs=server._n_obs)
    try:
        if args.http_port is not None:
            # the HTTP front door: handler threads admit, THIS thread runs
            # the acquisition and the journal (the drain and the heartbeat
            # stay serve_loop's); the spool dir still hosts the stop flag
            # and the endpoint file
            from mpi_opt_tpu_torch.service.http import FrontDoor, serve_http

            spool = None
            if args.http_state_dir:
                from mpi_opt_tpu_torch.service.spool import Spool

                spool = Spool(args.http_state_dir)
            front = FrontDoor(suggest=server, ledger=ledger, spool=spool, metrics=metrics,
                              queue_depth=args.http_queue)
            summary = serve_http(front, args.suggest_serve, metrics, port=args.http_port,
                                 idle_timeout=args.suggest_idle_timeout)
        else:
            summary = serve_loop(server, args.suggest_serve, metrics, ledger=ledger,
                                 idle_timeout=args.suggest_idle_timeout)
    except SweepInterrupted as e:
        # the drain park: every acked report is fsync-journaled already,
        # so the park loses nothing; 75 tells the scheduler "resume me"
        metrics.count_preempted()
        metrics.summary(final=True)
        print(json.dumps({"preempted": True, "signal": e.signal, "at": e.at,
                          "workload": args.workload, "backend": "suggest"}))
        print(f"graceful shutdown ({e.signal}) at {e.at}: reports journaled; "
              f"relaunch with --resume to continue (exit {EX_TEMPFAIL})", file=sys.stderr)
        metrics.close()
        return EX_TEMPFAIL
    finally:
        if ledger is not None:
            ledger.close()
    metrics.summary(final=True)
    print(json.dumps(_finite_or_null({"workload": args.workload, "algorithm": "suggest",
                                      "backend": "suggest", **summary})))
    metrics.close()
    return 0


def _open_fused_ledger(args, parser, space, metrics):
    """Open and identity-check the sweep's ledger (None without
    --ledger), committing the JAX CLI's fused header before the sweep
    starts: a stale journal needs --resume, and a journal of another
    sweep is refused. ``wave_size`` is not the ledger's identity: wave
    mode journals the resident sweep's records."""
    if not args.ledger:
        return None
    from mpi_opt_tpu_torch.ledger import LedgerError

    ledger = _open_rank_ledger(args, parser, metrics)
    if ledger.records and not args.resume:
        ledger.close()
        parser.error(
            f"--ledger {args.ledger!r} already holds {len(ledger.records)} member records; "
            "pass --resume to verify and continue them, or point at a fresh path"
        )
    config = {
        "mode": "fused",
        "granularity": {"pbt": "generation", "tpe": "batch"}.get(args.algorithm, "rung"),
        "algorithm": args.algorithm,
        "workload": args.workload,
        "backend": "fused",
        "seed": args.seed,
        "space_hash": space.space_hash(),
        "warm_start": args.warm_start,
    }
    if args.objective_spec is not None:
        # the objectives shape the selection trajectory: a resume under
        # others is refused by the config gate; a scalar sweep writes no key
        config["objectives"] = args.objectives
    # the knobs that shape each algorithm's boundaries and members
    if args.algorithm == "pbt":
        config.update(population=args.population, generations=args.generations,
                      steps_per_generation=args.steps_per_generation)
    elif args.algorithm == "tpe":
        config.update(trials=args.trials, batch=args.population, budget=args.budget)
    elif args.algorithm == "random":
        config.update(trials=args.trials, budget=args.budget)
    elif args.algorithm in ("hyperband", "bohb"):
        config.update(max_budget=args.max_budget, eta=args.eta)
    else:
        config.update(trials=args.trials, min_budget=args.min_budget,
                      max_budget=args.max_budget, eta=args.eta)
    try:
        ledger.ensure_header(config, space_spec=space.spec(), objective_spec=(
            None if args.objective_spec is None else args.objective_spec.spec()))
    except LedgerError as e:
        ledger.close()
        parser.error(f"--ledger: {e}")
    if ledger.n_torn:
        metrics.log("ledger_torn_tail_dropped", path=args.ledger)
    if ledger.n_torn_boundary:
        metrics.log("ledger_torn_boundary_dropped", path=args.ledger, records=ledger.n_torn_boundary)
    return ledger


def _wave_extras(res: dict) -> dict:
    """The wave fields of the summary line (empty for a resident
    sweep): the JAX CLI's, ``waves_run``, the waves this process
    trained (a resume that re-trains no completed wave shows it),
    ``launch_width``, the members every launch ran, and
    ``launch_shape_changed``, true if an OOM halving ran the rest at
    another launch width (it stays false: the width is fixed for the
    sweep, ``train/engine.py::launch_chunk``)."""
    if not res.get("wave_size"):
        return {}
    return dict(
        wave_size=res["wave_size"],
        n_waves=res["n_waves"],
        staged_bytes=res["staged_bytes"],
        stage_overlap_s=round(res["stage_overlap_s"], 3),
        stage_wait_s=round(res["stage_wait_s"], 3),
        oom_backoffs=res.get("oom_backoffs", 0),
        waves_run=res["waves_run"],
        **({"launch_width": res["launch_width"]} if "launch_width" in res else {}),
        launch_shape_changed=res.get("launch_shape_changed", False),
    )


def _run_fused_dispatch(args, workload, metrics, t0, ledger, warm_obs, mesh=None) -> int:
    """Run the sweep, then print the JAX CLI's fused summary line."""
    import time

    if args.algorithm == "pbt":
        from mpi_opt_tpu_torch.train.fused_pbt import fused_pbt

        res = _run_with_retries(lambda: fused_pbt(
            workload,
            population=args.population,
            generations=args.generations,
            steps_per_gen=args.steps_per_generation,
            seed=args.seed,
            cfg=PBTConfig(truncation_frac=args.truncation),
            member_chunk=args.member_chunk,
            gen_chunk=args.gen_chunk,
            step_chunk=args.step_chunk,
            wave_size=args.wave_size,
            oom_backoff=args.oom_backoff,
            checkpoint_dir=args.checkpoint_dir,
            snapshot_every=args.checkpoint_every,
            ledger=ledger,
            device=args.device,
            objectives=args.objective_spec,
            warm_obs=warm_obs,
            mesh=mesh,
        ), args.retries, metrics)
        n_trials = args.population * args.generations
        extra = {"best_curve": [round(float(v), 4) for v in res["best_curve"]]}
    elif args.algorithm == "tpe":
        from mpi_opt_tpu_torch.train.fused_tpe import fused_tpe

        res = _run_with_retries(lambda: fused_tpe(
            workload,
            n_trials=args.trials,
            batch=args.population,
            budget=args.budget,
            seed=args.seed,
            member_chunk=args.member_chunk,
            wave_size=args.wave_size,
            oom_backoff=args.oom_backoff,
            checkpoint_dir=args.checkpoint_dir,
            ledger=ledger,
            device=args.device,
            warm_obs=warm_obs,
            mesh=mesh,
        ), args.retries, metrics)
        n_trials = res["n_trials"]
        extra = {"best_curve": [round(float(v), 4) for v in res["best_curve"]]}
    elif args.algorithm in ("hyperband", "bohb"):
        from mpi_opt_tpu_torch.train.fused_asha import fused_hyperband
        from mpi_opt_tpu_torch.train.fused_bohb import fused_bohb

        sweep = fused_hyperband if args.algorithm == "hyperband" else fused_bohb
        res = _run_with_retries(lambda: sweep(
            workload,
            max_budget=args.max_budget,
            eta=args.eta,
            seed=args.seed,
            member_chunk=args.member_chunk,
            wave_size=args.wave_size,
            oom_backoff=args.oom_backoff,
            checkpoint_dir=args.checkpoint_dir,
            ledger=ledger,
            device=args.device,
            warm_obs=warm_obs,
            mesh=mesh,
        ), args.retries, metrics)
        n_trials = res["n_trials"]
        extra = {"brackets": res["brackets"]}
    else:
        from mpi_opt_tpu_torch.train.fused_asha import fused_sha

        # random search is the one-rung case of successive halving: one
        # cohort of --trials members trains to --budget, no cuts
        lo, hi = ((args.budget, args.budget) if args.algorithm == "random"
                  else (args.min_budget, args.max_budget))
        mo = {} if args.objective_spec is None else {"objectives": args.objective_spec}
        res = _run_with_retries(lambda: fused_sha(
            workload,
            n_trials=args.trials,
            min_budget=lo,
            max_budget=hi,
            eta=args.eta,
            seed=args.seed,
            member_chunk=args.member_chunk,
            wave_size=args.wave_size,
            oom_backoff=args.oom_backoff,
            checkpoint_dir=args.checkpoint_dir,
            ledger=ledger,
            device=args.device,
            warm_obs=warm_obs,
            mesh=mesh,
            **mo,
        ), args.retries, metrics)
        n_trials = res["n_trials"]
        extra = {"rung_sizes": res["rung_sizes"], "rung_budgets": res["rung_budgets"]}
    extra.update(_wave_extras(res))
    wall = time.perf_counter() - t0
    # per-chip rates divide by the devices the sweep ran on: the mesh's
    # size (every rank counts the same global trials), else 1
    n_chips = 1 if mesh is None else mesh.size
    metrics.count_trials(n_trials)
    member_failures = res["member_failures"]
    summary = {
        "workload": args.workload,
        "algorithm": args.algorithm,
        "backend": "fused",
        "mesh": None if mesh is None else dict(mesh.shape),
        "n_chips": n_chips,
        "n_trials": n_trials,
        "member_failures": member_failures,
        "wall_s": round(wall, 3),
        "trials_per_sec_per_chip": round(n_trials / max(wall, 1e-9) / n_chips, 4),
        "best_score": None if res["best_params"] is None else round(res["best_score"], 6),
        "best_params": res["best_params"],
        **extra,
    }
    if res.get("staged_bytes") is not None:
        metrics.count_staging(res["staged_bytes"], res["stage_overlap_s"])
    if res["journal"] is not None:
        metrics.count_journaled(res["journal"]["written"])
        summary["journal"] = dict(res["journal"])
    if args.objective_spec is not None:
        _report_pareto(res, args.objective_spec, summary, metrics)
    metrics.summary(final=True, member_failures=int(sum(member_failures)))
    print(json.dumps(_finite_or_null(summary)))
    return 0


def _report_pareto(res, objectives, summary, metrics) -> None:
    """A multi-objective sweep's summary fields (``objectives``,
    ``pareto``) and events: ``pareto_front``, and ``objective_degraded``
    when nothing was feasible (the winner is the least violating member,
    or none at all)."""
    names = ",".join(objectives.names)
    pareto = res["pareto"]
    summary["objectives"] = res["objectives"]
    summary["pareto"] = pareto
    if pareto is None:  # a resume that restarted past the last boundary
        return
    metrics.log("pareto_front", front_size=pareto["front_size"],
                hypervolume=pareto["hypervolume"], selection=pareto["selection"], objectives=names)
    if pareto["selection"] != "feasible":
        metrics.log("objective_degraded", selection=pareto["selection"],
                    violation=pareto["violation"], objectives=names)


def make_algorithm(args, space):
    """The host algorithm the driver path runs, from the CLI's arguments."""
    from mpi_opt_tpu_torch.algorithms import get_algorithm

    cls = get_algorithm(args.algorithm)
    if args.algorithm == "random":
        return cls(space, seed=args.seed, max_trials=args.trials, budget=args.budget)
    if args.algorithm == "tpe":
        return cls(space, seed=args.seed, max_trials=args.trials, budget=args.budget,
                   device=args.device)
    if args.algorithm == "asha":
        return cls(space, seed=args.seed, max_trials=args.trials, min_budget=args.min_budget,
                   max_budget=args.max_budget, eta=args.eta)
    if args.algorithm == "hyperband":
        return cls(space, seed=args.seed, max_budget=args.max_budget, eta=args.eta)
    if args.algorithm == "bohb":
        return cls(space, seed=args.seed, max_budget=args.max_budget, eta=args.eta,
                   device=args.device)
    if args.algorithm == "pbt":
        return cls(space, seed=args.seed, population=args.population,
                   generations=args.generations, steps_per_generation=args.steps_per_generation,
                   config=PBTConfig(truncation_frac=args.truncation))
    raise AssertionError(args.algorithm)


def run_driver(args, parser, workload) -> int:
    """The driver path: ``driver.run_search`` over a host algorithm and
    the ``gpu`` slot-pool backend, with the ledger's replay and cache,
    verified batch snapshots, retries and the failure-rate breaker, the
    JAX CLI's summary line and exit codes."""
    from mpi_opt_tpu_torch.backends import get_backend
    from mpi_opt_tpu_torch.driver import FailurePolicy, SweepAborted, run_search
    from mpi_opt_tpu_torch.ledger import LedgerError
    from mpi_opt_tpu_torch.workloads.base import PopulationWorkload

    if args.backend == "gpu" and not isinstance(workload, PopulationWorkload):
        parser.error(f"the gpu backend needs a population workload, not {args.workload!r}")
    if args.checkpoint_dir and not args.resume and _has_snapshot(args.checkpoint_dir):
        parser.error(
            f"--checkpoint-dir {args.checkpoint_dir!r} already holds a snapshot; "
            "pass --resume to continue it, or point at a fresh directory"
        )
    space = workload.default_space()
    algorithm = make_algorithm(args, space)
    rank, _ = _rank_world()
    metrics = stdout_logger(path=args.metrics_file, n_chips=1)
    mesh = _run_mesh(args, parser, metrics)
    if mesh is not None and args.backend != "gpu":
        parser.error("a mesh shards the gpu slot pool over the ranks; --backend cpu is one "
                     "process's host pool")
    # the prior ledger validates before this run's own header commits
    warm_obs = warm_info = None
    if args.warm_start:
        warm_obs, warm_info = _resolve_warm_start(args, space, parser, metrics)
    _wire_integrity_observer(metrics)
    _wire_resource_observer(metrics)
    if args.trace:  # main restores the entry state on the way out
        _trace.configure(metrics, rank=rank, tenant=os.environ.get(TRACE_TAG_ENV))
    fields = dict(workload=args.workload, algorithm=args.algorithm, backend=args.backend)
    if args.backend == "cpu":
        backend_kwargs = {"n_workers": args.workers, "seed": args.seed,
                          "trial_timeout": args.trial_timeout,
                          "isolate_stateful": args.isolate_stateful}
        if args.chaos_kwargs is not None:
            # the workers rebuild the workload from (name, kwargs): without
            # these they would build a fault-free wrapper
            backend_kwargs["workload_kwargs"] = args.chaos_kwargs
    else:
        backend_kwargs = {"population": args.population, "seed": args.seed,
                          "member_chunk": args.member_chunk, "device": args.device, "mesh": mesh}
    with _trace.span("setup", backend=args.backend) as sp:
        _trace.note_device(sp, args.device)
        backend = get_backend(args.backend, workload, **backend_kwargs)
    checkpointer = ledger = step = None
    multiprocess_off = _install_multiprocess(args, parser)
    try:
        with resources.oom_funnel():
            if args.checkpoint_dir:
                from mpi_opt_tpu_torch.utils.checkpoint import SearchCheckpointer

                checkpointer = SearchCheckpointer(args.checkpoint_dir, every=args.checkpoint_every,
                                                  mesh=mesh)
                if args.resume:
                    try:
                        step = checkpointer.restore_into(algorithm, backend)
                    except ValueError as e:  # a fused sweep's directory
                        parser.error(f"--checkpoint-dir: {e}")
                    metrics.log("resume", step=step)
            ledger = _open_driver_ledger(args, parser, space, backend, metrics)
            if warm_obs is not None:
                if step is not None:
                    # the priors were ingested before that snapshot and live
                    # in the restored state: ingesting them again would
                    # count them twice and re-queue consumed seed points
                    metrics.log("warm_start_skipped",
                                reason="checkpoint restored (priors already in state)", step=step)
                else:
                    _log_warm_start(metrics, args, warm_info,
                                    algorithm.ingest_observations(warm_obs))
            policy = FailurePolicy(max_retries=args.trial_retries,
                                   max_failure_rate=args.max_failure_rate, seed=args.seed)
            # under --backend cpu only this process is profiled, not its workers
            with profile_window(args.profile_dir, launches=args.profile_window,
                                device=args.device):
                result = run_search(algorithm, backend, metrics=metrics,
                                    checkpointer=checkpointer, policy=policy, ledger=ledger)
    except resources.DeviceOOM as e:
        return _resource_exit(e, metrics, "device_oom", **fields)
    except resources.StorageFull as e:
        return _resource_exit(e, metrics, "storage_full", **fields)
    except (NoVerifiedSnapshotError, LedgerError) as e:
        return _data_error_exit(e, metrics, **fields)
    except SweepAborted as e:
        # the breaker tripping is an operator outcome, not a crash
        metrics.summary(final=True, aborted=True)
        print(json.dumps({"aborted": str(e)}))
        print(str(e), file=sys.stderr)
        return 1
    except SweepInterrupted as e:
        # drained at a batch boundary: every completed trial is journaled
        # and an off-cadence snapshot was forced
        metrics.count_preempted()
        metrics.summary(final=True)
        print(json.dumps({"preempted": True, "signal": e.signal, "at": e.at,
                          "trials_done": metrics.trials_done}))
        print(f"graceful shutdown ({e.signal}) at {e.at}: checkpoint + ledger flushed; "
              f"relaunch with --resume to continue (exit {EX_TEMPFAIL})", file=sys.stderr)
        return EX_TEMPFAIL
    finally:
        multiprocess_off()
        backend.close()
        if checkpointer is not None:
            checkpointer.close()
        if ledger is not None:
            ledger.close()
    best = result.best
    summary = {
        "workload": args.workload,
        "algorithm": args.algorithm,
        "backend": args.backend,
        "n_trials": result.n_trials,
        "wall_s": round(result.wall_s, 3),
        "trials_per_sec_per_chip": round(result.trials_per_sec_per_chip, 4),
        "trials_failed": metrics.trials_failed,
        "trials_retried": metrics.trials_retried,
        "trials_timeout": metrics.trials_timeout,
        "cache_hits": metrics.cache_hits,
        "replayed": metrics.replayed,
        "best_score": None if best is None else round(best.score, 6),
        "best_params": None if best is None
        else {k: v for k, v in best.params.items() if not k.startswith("__")},
    }
    metrics.summary(final=True)
    print(json.dumps(_finite_or_null(summary)))
    return 0


def _open_driver_ledger(args, parser, space, backend, metrics):
    """Open the driver path's ledger (None without --ledger) and commit
    the JAX CLI's driver header: the sweep's identity is everything that
    shapes the suggestion stream the replay relies on. A stale journal
    needs --resume; a journal of another sweep is refused."""
    if not args.ledger:
        return None
    from mpi_opt_tpu_torch.ledger import LedgerError

    ledger = _open_rank_ledger(args, parser, metrics)
    if ledger.records and not args.resume:
        ledger.close()
        parser.error(f"--ledger {args.ledger!r} already holds {len(ledger.records)} trial "
                     "records; pass --resume to replay them, or point at a fresh path")
    try:
        ledger.ensure_header(
            {
                "algorithm": args.algorithm,
                "workload": args.workload,
                "backend": args.backend,
                "seed": args.seed,
                "space_hash": space.space_hash(),
                "capacity": backend.capacity,
                "trials": args.trials,
                "budget": args.budget,
                "chaos": args.chaos,
                "warm_start": args.warm_start,
            },
            space_spec=space.spec(),
        )
    except LedgerError as e:
        ledger.close()
        parser.error(f"--ledger: {e}")
    if ledger.n_torn:
        metrics.log("ledger_torn_tail_dropped", path=args.ledger)
    return ledger


def _expandable_segments(device) -> bool:
    """Let the CUDA caching allocator grow its segments in place
    (``expandable_segments``) unless ``PYTORCH_CUDA_ALLOC_CONF`` is set;
    returns whether it did. With fixed segments, reserved memory runs
    ahead of allocated memory, and near the card's limit a cuDNN
    workspace fails to allocate: PyTorch then runs the convolution with
    a plan that needs less workspace and computes other bits, so a run
    with little headroom, such as one that backed off a device OOM, would
    not reproduce the unfaulted run. Set at run time, since a launcher
    may have initialised CUDA already."""
    import torch

    if device == "cpu" or os.environ.get("PYTORCH_CUDA_ALLOC_CONF") or not torch.cuda.is_available():
        return False
    setter = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    if setter is None:  # older PyTorch
        setter = torch.cuda.memory._set_allocator_settings
    setter("expandable_segments:True")
    return True


def _make_workload(args, parser, workload=None):
    """The sweep's workload: ``workload`` when the sweep service injects
    its cached instance (``service/programs.py``), else a new one from
    the registry; under ``--chaos`` wrapped in the seeded fault injector
    (built fresh by name, so one tenant's fault schedule never reaches
    another), whose kwargs ride ``args.chaos_kwargs`` to the cpu
    backend's workers."""
    args.chaos_kwargs = None
    if args.chaos is None:
        return workload if workload is not None else get_workload(args.workload)
    if args.fused or args.backend != "cpu":
        parser.error("--chaos exercises the host driver's trial-level failure policy through "
                     "the cpu backend; fused/gpu sweeps have no per-trial injection point "
                     "(their divergence masking is always on)")
    from mpi_opt_tpu_torch.workloads.chaos import parse_chaos_spec

    try:
        args.chaos_kwargs = {"inner": args.workload, **parse_chaos_spec(args.chaos)}
        return get_workload("chaos", **args.chaos_kwargs)
    except ValueError as e:
        parser.error(f"--chaos: {e}")


def main(argv=None, *, _workload=None) -> int:
    """The CLI entry point. ``_workload`` is the sweep service's seam
    (``service/programs.py``): a resident server passes its cached
    workload instance, so shape-matching tenants share the trainer and
    the on-card data. None, as every other caller passes, builds the
    workload from the registry."""
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "trace":
        from mpi_opt_tpu_torch.obs.report import trace_main

        return trace_main(argv[1:])
    # `report` renders/validates ledgers, `fsck` audits (and repairs) a
    # sweep's snapshot directory; neither touches the device
    if argv and argv[0] == "report":
        from mpi_opt_tpu_torch.ledger.report import report_main

        return report_main(argv[1:])
    if argv and argv[0] == "fsck":
        from mpi_opt_tpu_torch.utils.integrity import fsck_main

        return fsck_main(argv[1:])
    # the resident multi-tenant sweep service: `serve` owns the device,
    # `submit`/`status`/`cancel`/`drain` are its filesystem-spool clients
    if argv and argv[0] in SERVICE_SUBCOMMANDS:
        return service_main(argv)
    # `corpus index|resolve` keeps and audits the ledger corpus that
    # `--warm-start auto:DIR` reads
    if argv and argv[0] == "corpus":
        from mpi_opt_tpu_torch.corpus.cli import corpus_main

        return corpus_main(argv[1:])
    # `suggest-client` drives a --suggest-serve server over its spool or
    # its HTTP front door; torch-free, like every service client
    if argv and argv[0] == "suggest-client":
        from mpi_opt_tpu_torch.corpus.client import client_main

        return client_main(argv[1:])
    # `lint [PATHS]` machine-checks the engine's invariants (analysis/,
    # the sweeplint suite); imports neither torch nor jax
    if argv and argv[0] == "lint":
        from mpi_opt_tpu_torch.analysis.cli import lint_main

        return lint_main(argv[1:])
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.resume and not (args.checkpoint_dir or args.ledger):
        parser.error("--resume requires --checkpoint-dir or --ledger")
    if args.trace and not args.metrics_file:
        parser.error("--trace needs --metrics-file: the spans go to that stream")
    # --profile-launches: parsed and validated as a usage error, the
    # window carried on args for the profile_window call sites
    args.profile_window = None
    if args.profile_launches is not None:
        if not args.profile_dir:
            parser.error("--profile-launches requires --profile-dir")
        try:
            args.profile_window = parse_launch_window(args.profile_launches)
        except ValueError as e:
            parser.error(f"--profile-launches: {e}")
    if args.backend not in ("gpu", "cpu"):
        parser.error(f"--backend {args.backend} is not a backend of the port: its device "
                     "slot pool is --backend gpu (the default), its host pool --backend cpu")
    if args.local_devices is not None:
        parser.error("--local-devices makes the JAX package's virtual CPU devices; a port rank "
                     "owns one device, so launch N ranks instead: python -m "
                     "mpi_opt_tpu_torch.launch --n-proc N -- ... --device cpu")
    if args.platform is not None:
        # the JAX CLI's name for the device: cpu, or gpu for the card
        asked = {"cpu": "cpu", "gpu": "cuda"}[args.platform]
        if args.device is not None and args.device != asked:
            parser.error(f"--platform {args.platform} contradicts --device {args.device}")
        args.device = asked
    if args.backend == "cpu" and args.device is None:
        args.device = "cpu"  # --backend cpu asks for the CPU
    explicit = (args.coordinator, args.num_processes, args.process_id)
    if any(v is not None for v in explicit) and not all(v is not None for v in explicit):
        parser.error("--coordinator, --num-processes and --process-id must be given together "
                     "(or use --multihost alone with torch's env:// variables)")
    if args.coord_timeout <= 0:
        parser.error(f"--coord-timeout must be > 0, got {args.coord_timeout}")
    if args.n_data < 1:
        parser.error(f"--n-data must be >= 1, got {args.n_data}")
    if args.n_pop < 0:
        parser.error(f"--n-pop must be >= 0, got {args.n_pop}")
    if args.workers < 0:
        parser.error(f"--workers must be >= 0, got {args.workers}")
    if args.trial_timeout is not None and args.trial_timeout <= 0:
        parser.error(f"--trial-timeout must be > 0, got {args.trial_timeout}")
    if args.isolate_stateful and (args.fused or args.backend != "cpu"):
        parser.error("--isolate-stateful moves the cpu backend's in-parent stateful path into a "
                     "worker process; fused/gpu sweeps have no such path")
    # the suggestion service's flags, with the JAX CLI's usage errors
    if args.suggest_serve:
        if args.fused:
            parser.error("--suggest-serve answers suggestion traffic instead of sweeping; it "
                         "cannot combine with --fused")
        if args.chaos is not None:
            parser.error("--chaos injects faults into trial evaluation; a --suggest-serve server "
                         "evaluates nothing")
    if args.suggest_idle_timeout is not None:
        if not args.suggest_serve:
            parser.error("--suggest-idle-timeout requires --suggest-serve")
        if args.suggest_idle_timeout <= 0:
            parser.error(f"--suggest-idle-timeout must be > 0, got {args.suggest_idle_timeout}")
    if args.http_port is not None:
        if not args.suggest_serve:
            parser.error("--http-port requires --suggest-serve DIR")
        if not 0 <= args.http_port <= 65535:
            parser.error(f"--http-port must be in [0, 65535], got {args.http_port}")
        if args.http_queue < 1:
            parser.error(f"--http-queue must be >= 1, got {args.http_queue}")
    elif args.http_state_dir is not None:
        parser.error("--http-state-dir requires --http-port")
    if args.trial_retries < 0:
        parser.error(f"--trial-retries must be >= 0, got {args.trial_retries}")
    if not 0.0 < args.max_failure_rate <= 1.0:
        parser.error(f"--max-failure-rate must be in (0, 1], got {args.max_failure_rate}")
    # --wave-size: an integer or 'auto', checked here as a usage error
    if args.wave_size != "auto":
        try:
            args.wave_size = int(args.wave_size)
        except ValueError:
            parser.error(f"--wave-size must be an integer or 'auto', got {args.wave_size!r}")
        if args.wave_size < 0:
            parser.error(f"--wave-size must be >= 0, got {args.wave_size}")
    if args.oom_backoff < 0:
        parser.error(f"--oom-backoff must be >= 0, got {args.oom_backoff}")
    if args.wave_size and not args.fused:
        parser.error("--wave-size schedules a fused cohort through host-staged waves; it "
                     "requires --fused")
    if args.wave_size and (args.gen_chunk > 1 or args.step_chunk > 0):
        parser.error("--wave-size schedules whole generations as resident waves; combining "
                     "it with --gen-chunk/--step-chunk launch splitting is ambiguous")
    # --objectives: parsed and cross-checked here, as a usage error
    args.objective_spec = None
    if args.objectives:
        if not args.fused or args.algorithm not in ("pbt", "asha"):
            parser.error("--objectives runs multi-objective selection inside the fused boundary "
                         "ops; it requires --fused --algorithm pbt|asha")
        if args.wave_size:
            parser.error("--objectives is not supported with --wave-size yet; run resident "
                         "(--wave-size 0)")
        if args.step_chunk > 0:
            parser.error("--objectives is not supported with --step-chunk (the sub-segment "
                         "boundary program is scalar); use --gen-chunk")
        from mpi_opt_tpu_torch.objectives import ObjectiveSpec

        try:
            args.objective_spec = ObjectiveSpec.parse(args.objectives)
        except ValueError as e:
            parser.error(f"--objectives: {e}")
    # SIGTERM/SIGINT set a drain flag; the next launch boundary flushes
    # the snapshot and the run exits EX_TEMPFAIL. The heartbeat, like
    # the handlers, is dropped on the way out, and the span sink restored
    trace_entry = _trace.save()
    _expandable_segments(args.device)
    multiprocess = args.multihost or args.coordinator is not None
    if multiprocess:
        # the process group, with each rank's device set first; its
        # collectives time out with the agreement barrier's timeout
        from mpi_opt_tpu_torch.parallel.mesh import initialize_multihost

        try:
            initialize_multihost(args.coordinator, args.num_processes, args.process_id,
                                 require=True, device=args.device, timeout_s=args.coord_timeout)
        except (ValueError, RuntimeError) as e:
            parser.error(f"multi-process bring-up failed: {e}")
    try:
        with _shutdown.ShutdownGuard():
            if args.heartbeat_file:
                _heartbeat.configure(args.heartbeat_file)
            run = (run_suggest_serve if args.suggest_serve
                   else run_fused if args.fused else run_driver)
            return run(args, parser, _make_workload(args, parser, _workload))
    finally:
        _heartbeat.deconfigure()
        integrity.clear_observer()
        resources.clear_observer()
        _trace.deconfigure(trace_entry)
        if multiprocess:
            from mpi_opt_tpu_torch.parallel.mesh import shutdown_multihost

            shutdown_multihost()


if __name__ == "__main__":
    sys.exit(main())

"""The fused wave engine (port of ``mpi_opt_tpu/train/engine.py``): the
wave/stage/drain/OOM skeleton every fused algorithm runs its intervals
through.

A population (PBT), a rung cohort (SHA) or a generation's cohort (TPE)
that exceeds the card's residency trains as WAVES of W members, staged
through host pools (``train/staging.py``). The algorithm supplies only
its shapes and its boundary op (PBT's exploit, SHA's rung cut, TPE's
ring update); this module owns:

- ``WaveRunner.run_interval``: one interval (a PBT generation, an SHA
  rung) as waves: the wave loop, a heartbeat a wave, stage-out, the
  between-waves drain points (``launch_boundary``, with an optional
  mid-interval snapshot), the interval-ending drain barrier, and the
  device-OOM retry that halves the wave cap and re-runs the interval;
- ``run_wave``: stage in, train, eval one wave.
  ``resources.launch_fault("wave")`` is its first line, the seam the
  OOM drills inject through;
- ``resolve_wave_size``: ``auto`` estimation, the pre-clamp of an
  explicit cap against the measured budget, and under multi-process
  SPMD the min-agreement of the cap through the coord plane
  (``parallel/coord.py``);
- ``boundary_span``: traces a boundary op as a ``boundary`` span and
  beats the heartbeat from inside it.

Spans (``obs/trace.py``): each interval is one ``train`` span over its
waves and the drain that ends it (with ``flops`` once the drain
completed); each wave's stage-in is a ``stage_in`` span inside it.

Bit identity. The JAX package has two wave programs, one mapping the
unit matrix to hyperparameters inside the program (PBT, TPE) and one
taking them mapped eagerly (SHA), because XLA's fused and eager ops
round differently. The port's resident paths all map eagerly, so ONE
wave function serves every driver: it takes the interval's eagerly
mapped ``OptHParams`` over the whole cohort and trains the wave's rows
(``PopulationTrainer.train_segment_window``). One ``torch.Generator``
threads every draw: each wave starts from the generator state saved at
the interval's start and makes the whole cohort's draws, so after the
last wave the generator stands where the resident segment leaves it.
An OOM re-run restarts its waves from that same state.

Under a mesh (``parallel/mesh.py``) a wave splits over the ranks' ``pop``
axis: each rank stages in and trains its rows of the wave, and the
wave's state and scores are gathered before the stage-out, on the main
thread (collectives keep one order on every rank), so every rank's host
pools hold every member, as every JAX process holds the full host copy.
An OOM halving is the world's: a rank whose attempt ran out of memory
checks in with its flag (``parallel/mesh.py::check_in``), which its
peers meet at the start of their next collective (or at their attempt's
end) and leave with ``PeerOOM``; then every rank votes the attempt
through the coord plane, and all halve together or none does.
"""

from __future__ import annotations

import contextlib
import gc

import torch

from mpi_opt_tpu_torch.obs import memory, trace
from mpi_opt_tpu_torch.train.common import launch_boundary
from mpi_opt_tpu_torch.train.population import PopState
from mpi_opt_tpu_torch.utils import profiling, resources


def balanced_split(total: int, chunk: int) -> list[int]:
    """Split ``total`` into ceil(total/chunk) near-equal parts (G=7,
    chunk=3 -> [3, 2, 2]); total=0 gives [0], one empty part. Shared by
    the wave layout and PBT's gen_chunk / step_chunk launch splits."""
    if total <= 0:
        return [0]
    n = -(-total // chunk)
    base, extra = divmod(total, n)
    return [base + 1] * extra + [base] * (n - extra)


def whole_chunks(wave_size: int, member_chunk: int, population: int) -> int:
    """A wave cap that holds whole member chunks: rounded down to a
    multiple of ``member_chunk``, and never below one chunk (a padded
    launch below the chunk saves no memory). Unchanged without a member
    chunk or at or above ``population`` (resident)."""
    if member_chunk <= 0 or not 0 < wave_size < population:
        return wave_size
    return max(member_chunk, wave_size // member_chunk * member_chunk)


def launch_chunk(population: int, wave_size: int, member_chunk: int = 0,
                 oom_backoff: int = 0) -> int:
    """The members every launch of a wave sweep runs, fixed for the
    sweep (0: a launch is the whole wave). With a member chunk, the
    chunk. Without one, a wave sweep (``0 < wave_size < population``)
    whose OOM budget is k > 0 launches ``max(1, wave_size >> k)``
    members, the smallest cap its halvings can reach, so a halving never
    changes the launch shape. With k = 0 nothing halves, and a launch
    stays the whole wave."""
    if member_chunk > 0:
        return member_chunk
    if oom_backoff > 0 and 0 < wave_size < population:
        return max(1, wave_size >> oom_backoff)
    return 0


def wave_layout(population: int, wave_size: int, member_chunk: int = 0):
    """(wave_lens, offs, n_waves) for a wave cap. Without a member chunk
    the JAX package's near-equal split. With one, waves hold whole
    chunks: the cohort's chunks are split near-equally into waves of at
    most ``wave_size // member_chunk`` (at least one), so every member
    keeps the chunk and the place in it it has resident, and only the
    cohort's last chunk is short (padded at launch)."""
    if member_chunk > 0 and population > 0:
        per = balanced_split(-(-population // member_chunk), max(1, wave_size // member_chunk))
        ends = [min(population, member_chunk * sum(per[:i + 1])) for i in range(len(per))]
        wave_lens = [e - s for s, e in zip([0] + ends[:-1], ends)]
    else:
        wave_lens = balanced_split(population, wave_size)
    offs = [0]
    for w in wave_lens[:-1]:
        offs.append(offs[-1] + w)
    return wave_lens, offs, len(wave_lens)


def engine_rollover(old):
    """A fresh ``StagingEngine`` carrying the old one's accounting (the
    results report run totals): after a device OOM the old engine may
    hold a latched transfer error that would refuse every later
    ``stage_out``."""
    from mpi_opt_tpu_torch.train.staging import StagingEngine

    old.close()
    new = StagingEngine(old.device)
    new.staged_bytes = old.staged_bytes
    new.transfers = old.transfers
    new.transfer_s = old.transfer_s
    new.wait_s = old.wait_s
    return new


@contextlib.contextmanager
def boundary_span(op: str, **attrs):
    """Trace a boundary op (exploit, rung_cut) as a ``boundary`` span and
    beat the heartbeat from inside it: the beat's ``phase`` reads
    ``boundary:<op>``, so a stall inside the op is attributed to it."""
    from mpi_opt_tpu_torch.health import heartbeat

    with trace.span("boundary", op=op, **attrs) as sp:
        heartbeat.beat(stage=f"boundary {op}")
        yield sp


def resolve_wave_size(trainer, population: int, *, wave_size, oom_backoff: int = 0,
                      mesh=None) -> int:
    """The requested wave cap (``'auto'`` or an int) resolved for a
    ``population``-member sweep; 0 (or a cap >= population) means
    resident. ``auto`` is ``estimate_wave_size``; with ``oom_backoff``
    on and a measured device budget, an explicit cap above the estimate
    is clamped to it before the first launch. With a member chunk the
    cap holds whole chunks (``whole_chunks``), never less than one.
    Every change is notified as a ``wave_resized`` event.

    Under multi-process SPMD (an active coord plane) every rank sizes
    against its own card, then the cap is min-agreed: all ranks must run
    the same wave schedule, and the most constrained one binds."""
    if not wave_size:
        return 0
    from mpi_opt_tpu_torch.train.staging import estimate_wave_size

    was_auto = wave_size == "auto"
    if was_auto:
        wave_size = estimate_wave_size(trainer, population, mesh=mesh)
        if wave_size < population:
            resources.notify("wave_resized", requested="auto", wave_size=int(wave_size),
                             population=population)
    wave_size = int(wave_size)
    if wave_size < 0:
        raise ValueError(f"wave_size must be >= 0, got {wave_size}")
    if oom_backoff and not was_auto and 0 < wave_size < population:
        from mpi_opt_tpu_torch.obs import memory

        if memory.measured_budget(trainer.device) is not None:
            est = estimate_wave_size(trainer, population, mesh=mesh)
            if est < wave_size:
                resources.notify("wave_resized", requested=wave_size, wave_size=est,
                                 population=population)
                wave_size = est
    whole = whole_chunks(wave_size, trainer.member_chunk, population)
    if whole != wave_size:
        resources.notify("wave_resized", requested=wave_size, wave_size=whole,
                         population=population, member_chunk=trainer.member_chunk)
        wave_size = whole
    from mpi_opt_tpu_torch.parallel import coord

    plane = coord.active_plane()
    if plane is not None and 0 < wave_size:
        # every rank votes its settled cap (clamped to resident); the
        # most constrained rank's answer binds them all
        agreed = plane.agree_cap("wave_cap", min(wave_size, population))
        if agreed and agreed != wave_size:
            resources.notify("wave_resized", requested=wave_size, wave_size=agreed,
                             population=population, agreed=True)
            wave_size = agreed
    return wave_size


def run_wave(trainer, pool, rows, offset: int, hp, train_x, train_y, val_x, val_y,
             generator: torch.Generator, rng_start, steps: int, engine, launch_width: int = 0,
             mesh=None, keep_state: bool = True):
    """Stage in, train and eval ONE wave: members [offset, offset+W) of
    the interval's cohort. ``rows`` are the pool rows to stage in (the
    previous boundary's map applied: staging in IS the winners' or
    survivors' gather); ``hp`` the interval's hyperparameters over the
    whole cohort; ``rng_start`` the generator state at the interval's
    start; ``launch_width`` the runner's ``chunk`` (0: the trainer's own
    member chunk). Returns (the wave's state, its scores), both on the
    card.

    Under ``mesh`` this rank stages in and trains its rows of the wave
    (all of them when ``pop`` does not divide it); the returned scores
    are the whole wave's, gathered, and so is the state unless
    ``keep_state`` is False (a scores-only stage-out: TPE's)."""
    from mpi_opt_tpu_torch.train.staging import tree_bytes

    resources.launch_fault("wave")
    if launch_width and launch_width != trainer.member_chunk:
        trainer = trainer.launching(launch_width)
    w = len(rows)
    a, b = (0, w) if mesh is None else mesh.rows(w)
    with trace.span("stage_in", members=b - a) as sp:
        dev = engine.stage_in(pool, rows[a:b])
        sp["bytes"] = tree_bytes(dev)
        memory.note(sp, engine.device)
    st = PopState(params=dev["params"], momentum=dev["momentum"], step=dev["step"],
                  cohort=0 if mesh is None else w)
    generator.set_state(rng_start)
    trainer.train_segment_window(st, hp, train_x, train_y, generator, steps, offset + a)
    scores = trainer.eval_population(st, val_x, val_y)
    if mesh is not None and st.cohort and keep_state:
        full = trainer.gather_state(st)
        st = PopState(full["params"], full["momentum"], full["step"])
    return st, scores


class WaveRunner:
    """The wave executor: owns the ``StagingEngine``, the execution cap
    (the resolved request, or a snapshot's ``wave_size_run``: a resume
    adopts the OOM-settled cap instead of paying the OOM again; halved
    by absorbed OOMs) and the backoff budget. After
    ``run_interval`` returns, ``wave_size`` / ``wave_lens`` / ``offs`` /
    ``n_waves`` are the layout the interval ran under.

    ``chunk`` is the sweep's launch width (``launch_chunk``, from the
    requested cap: a resume that adopts a halved ``wave_size`` keeps the
    width): the member chunk, or without one the smallest cap the OOM
    budget can reach. Waves hold whole chunks (``wave_layout``), a
    halving never goes below one chunk, and the drivers pass ``chunk``
    to ``run_wave``, so every launch has one shape and an OOM-backed-off
    sweep ends in the unfaulted sweep's bits. Only with no member chunk
    and no OOM budget is a launch the whole wave (nothing halves). The
    ``oom_backoff`` event and ``result_extras`` report the width before
    and after a halving (``launch_shape_changed`` stays false)."""

    def __init__(self, population: int, wave_size: int, *, member_chunk: int = 0,
                 oom_backoff: int = 0, device=None, requested: int | None = None):
        from mpi_opt_tpu_torch.train.staging import StagingEngine

        self.population = int(population)
        self.wave_size = int(wave_size)
        self.chunk = launch_chunk(self.population, self.wave_size if requested is None else int(requested),
                                  max(0, int(member_chunk)), max(0, int(oom_backoff)))
        self.launch_width_before = self.launch_width
        self.oom_budget = max(0, int(oom_backoff))
        self.oom_backoffs = 0
        self.waves_run = 0  # every wave dispatched, re-runs included
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.engine = StagingEngine(self.device)
        self.wave_lens, self.offs, self.n_waves = wave_layout(
            self.population, self.wave_size, self.chunk)

    @property
    def launch_width(self) -> int:
        """Members a launch runs: the chunk, else the wave cap."""
        return self.chunk or self.wave_size

    def close(self) -> None:
        self.engine.close()

    def run_interval(  # sweeplint: barrier(wave interval loop: stages pools, gathers wave scores, drains at the algorithm boundary)
        self,
        *,
        n: int,
        run_wave_fn,
        dst_fn,
        scores_host: torch.Tensor,
        stage_label,
        boundary_kwargs=None,
        midpoint_snapshot=None,
        start_wave: int = 0,
        notify_fields=(),
        span_attrs=None,
        flops=None,
    ):
        """Run ONE interval of ``n`` cohort members as waves; returns the
        waves' score tensors on the card, in wave order.

        - ``run_wave_fn(w, off, wl, engine) -> (state, scores)`` dispatches
          wave ``w``;
        - ``dst_fn(off, wl)`` is the host destination of a wave's
          ``{"state": {"params", "momentum", "step"}, "scores"}``: pool
          rows and ``scores_host[off:off+wl]``, which a mid-interval
          resume and an OOM re-run read and reset. A destination without
          ``"state"`` stages out the scores alone (TPE carries no state
          between generations);
        - ``stage_label(w, n_waves)`` / ``boundary_kwargs(w, n_waves)`` /
          ``midpoint_snapshot(w, n_waves)`` shape the heartbeat, the
          between-waves ``launch_boundary`` progress fields and its
          drain snapshot (None: no mid-interval snapshot);
        - ``span_attrs(n_waves)`` are the interval's ``train`` span attrs
          and ``flops`` its FLOPs, attached once the drain completed (an
          interval cut short reports its partial wall without them).

        ``start_wave`` skips completed waves (a mid-interval resume),
        taking their scores from ``scores_host``. On a ``DeviceOOM``
        with budget left, the interval re-runs from wave 0 under half
        the cap: the pools are only read, and each wave restarts the
        generator from the interval's start, so the re-run reproduces
        the interval exactly. An ``oom_backoff`` event carries
        ``notify_fields`` and the launch width before and after. With no
        budget left, or at a cap of one member chunk (1 without a chunk),
        the ``DeviceOOM`` propagates.

        Across processes every attempt ends in a check-in
        (``mesh.check_in``) that tells each rank whether any rank ran out
        of memory, then, under an active coord plane, in one ``oom``
        agreement (the halved cap from every rank that knows of the OOM,
        0 from none), so the whole world halves together."""
        from mpi_opt_tpu_torch.health import heartbeat
        from mpi_opt_tpu_torch.parallel import coord
        from mpi_opt_tpu_torch.parallel import mesh as mesh_mod

        while True:  # one pass per OOM-backoff attempt
            wave_lens, offs, n_waves = wave_layout(n, self.wave_size, self.chunk)
            self.wave_lens, self.offs, self.n_waves = wave_lens, offs, n_waves
            wave_scores: list = [None] * n_waves
            for w in range(start_wave):
                off, wl = offs[w], wave_lens[w]
                wave_scores[w] = scores_host[off:off + wl].to(self.device)
            # an interval attempt is a launch (a backoff re-run is another)
            profiling.launch_tick()
            try:
                with resources.oom_funnel(self.wave_size), trace.span(
                        "train", **({"waves": n_waves} if span_attrs is None else span_attrs(n_waves))
                ) as sp:
                    for w in range(start_wave, n_waves):
                        off, wl = offs[w], wave_lens[w]
                        st, sc = run_wave_fn(w, off, wl, self.engine)
                        wave_scores[w] = sc
                        self.waves_run += 1
                        heartbeat.beat(stage=f"{stage_label(w, n_waves)} dispatched")
                        # the copy out runs behind the wave's compute
                        # while this loop dispatches the next wave; no
                        # name here may outlive the call, or the wave's
                        # tensors stay on the card through the next one
                        dst = dst_fn(off, wl)
                        self.engine.stage_out(
                            {**({"state": {"params": st.params, "momentum": st.momentum,
                                           "step": st.step}} if "state" in dst else {}),
                             "scores": sc}, dst)
                        del st, sc
                        if w + 1 < n_waves:
                            launch_boundary(
                                stage_label(w, n_waves),
                                final=False,
                                snapshot=None if midpoint_snapshot is None else midpoint_snapshot(w, n_waves),
                                **({} if boundary_kwargs is None else boundary_kwargs(w, n_waves)),
                            )
                    # the interval's only hard barrier: the boundary op
                    # needs every score and a settled pool
                    self.engine.drain()
                    if flops:
                        sp["flops"] = flops
                    memory.note(sp, self.device)
                error = None
            except resources.DeviceOOM as e:
                error = e
            # the world learns of an OOM: a rank that failed, or finished,
            # checks in; a peer that left through PeerOOM already did
            if not isinstance(error, mesh_mod.PeerOOM) and mesh_mod.check_in(error is not None) and error is None:
                error = mesh_mod.PeerOOM("a peer rank ran out of device memory in this attempt")
            if error is not None and (self.oom_budget <= 0 or self.wave_size <= max(1, self.chunk)):
                raise error
            error = None if error is None else str(error)[:300]
            # the OOM agreement: one barrier an attempt on every rank, so
            # a halving is the world's or nobody's (without a plane the
            # local proposal stands)
            proposed = 0 if error is None else whole_chunks(max(1, self.wave_size // 2), self.chunk, n)
            plane = coord.active_plane()
            agreed = plane.agree_cap("oom", proposed) if plane is not None else proposed
            if not agreed:
                return wave_scores
            # the failed attempt's tensors die with its frames; settle
            # what the engine holds, then give the memory back
            wave_scores = None
            gc.collect()
            try:
                self.engine.drain()
            # sweeplint: disable=drain-swallow -- settling transfers of the attempt that hit the OOM this handler absorbs; the engine is rolled over below
            except Exception:
                pass
            self.engine = engine_rollover(self.engine)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()
            self.oom_budget -= 1
            self.oom_backoffs += 1
            width = self.launch_width
            self.wave_size = agreed
            scores_host.fill_(float("nan"))
            start_wave = 0
            resources.notify("oom_backoff", **dict(notify_fields), wave_size=self.wave_size,
                             remaining=self.oom_budget, error=error, launch_width_before=width,
                             launch_width_after=self.launch_width,
                             launch_shape_changed=self.launch_width != width)

    def result_extras(self) -> dict:
        """The wave fields every wave-scheduled result reports: the
        settled split (the last interval's), absorbed OOM halvings,
        waves dispatched, bytes moved, how much of the transfer time
        compute hid, and the launch width."""
        return {
            "wave_size": self.wave_size,
            "wave_lens": list(self.wave_lens),
            "n_waves": self.n_waves,
            "waves_run": self.waves_run,
            "oom_backoffs": self.oom_backoffs,
            "staged_bytes": int(self.engine.staged_bytes),
            "stage_transfer_s": float(self.engine.transfer_s),
            "stage_wait_s": float(self.engine.wait_s),
            "stage_overlap_s": float(self.engine.overlap_s),
            "launch_width": self.launch_width,
            "launch_width_before": self.launch_width_before,
            "launch_width_after": self.launch_width,
            "launch_shape_changed": self.launch_width != self.launch_width_before,
        }


"""Host-staged member waves: a population larger than the card holds
(port of ``mpi_opt_tpu/train/staging.py``).

A population whose carried state does not fit the card lives in host
memory, and the card trains it a WAVE of W members at a time
(``train/engine.py`` runs the waves). This module moves the members:

- the pools: the population's carried state (``PopState``'s
  ``params``/``momentum``/``step``, each leaf ``[P, ...]``) in host
  memory, pinned when the sweep runs on CUDA, so copies to and from
  the card are asynchronous DMA (``non_blocking=True`` into pageable
  memory is a synchronous copy). Two pools ping-pong per boundary: the
  next interval reads the previous one's pool through the boundary's
  row map (PBT's exploit sources, SHA's survivors) while writing its
  own, so the winners' gather is an indexed read at stage-in;
- ``StagingEngine``: ``stage_in`` gathers a wave's rows into one pinned
  staging slice and copies them to the card on a stage-in stream;
  ``stage_out`` copies a trained wave into its pool rows on a stage-out
  stream, behind an event recorded after the wave's eval, while the
  main thread dispatches the next wave. A worker thread waits for each
  copy, lands it (``on_done``), beats the heartbeat and does the
  accounting. ``drain()`` is the interval's only hard barrier;
- ``estimate_wave_size``: the ``--wave-size auto`` residency estimate;
  ``measured_train_peak``/``envelope_report`` hold it against the
  watermark of an earlier traced run.

The CUDA rules the design follows:

- the compute stream waits on the stage-in copy's event before it
  touches the wave, and the stage-out stream waits on the event
  recorded after the wave's eval;
- a wave's tensors are allocated on the stage-in stream and
  ``record_stream``'d on the compute and stage-out streams, so the
  caching allocator reuses their memory only after the last copy out
  of them has run (the next wave's compute would otherwise overwrite a
  wave mid-copy);
- the staging slice is refilled only after the copy out of it ended.

Memory contract (the JAX package's): the card holds at most two waves
(one computing, one being copied out); the host holds two full pools
plus one wave-sized staging slice. On the CPU the same engine runs with
plain copies: the worker thread does the stage-out copy itself.

Spans (``obs/trace.py``): each copy out is a ``stage_out`` span on the
worker (its wait on the copy's event, and the landing), and the time
``drain()`` blocks on transfers after the last wave's compute is a
``stage_wait`` span; both carry the engine's cumulative ``wait_s`` and
``overlap_s``, which ``obs/bubbles.py`` reads.

Accounting (``WaveRunner.result_extras``): ``staged_bytes`` both ways;
``transfer_s`` the copies' own time (CUDA events on the copy streams,
plus the landing callbacks); ``wait_s`` the main thread's time blocked
in ``drain()`` on transfers once the last wave's compute has ended;
``overlap_s = max(0, transfer_s - wait_s)``, the part compute hid.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, Optional

import torch

from mpi_opt_tpu_torch.obs import memory, trace


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_bytes(tree) -> int:
    """Total bytes of a tree's tensors."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def population_pool(trainer, population: int) -> dict:
    """A zeroed host pool for ``population`` members' carried state,
    shaped by the trainer's meta template (nothing is allocated on the
    card): ``{"params", "momentum", "step"}``, the ``PopState`` fields.
    Pinned when the trainer runs on CUDA."""
    pin = trainer.device.type == "cuda"
    mk = lambda shape, dtype: torch.zeros((population,) + tuple(shape), dtype=dtype, pin_memory=pin)
    named = [(k, v.shape[1:], v.dtype) for k, v in trainer.template.named_parameters()]
    return {
        "params": {k: mk(s, dt) for k, s, dt in named},
        "momentum": {k: mk(s, trainer.momentum_dtype or dt) for k, s, dt in named},
        "step": mk((), torch.int32),
    }


def pool_copy(trainer, tree: dict) -> dict:
    """A staging pool (pinned on CUDA) holding a host tree of
    ``{"params", "momentum", "step"}`` rows: a restored snapshot's
    population made a pool."""
    pool = population_pool(trainer, int(tree["step"].shape[0]))
    tree_map(lambda d, s: d.copy_(s), pool, tree)
    return pool


def nan_scores(n: int, device) -> torch.Tensor:
    """A NaN score accumulator for ``n`` members (pinned on CUDA)."""
    return torch.full((n,), float("nan"), dtype=torch.float32,
                      pin_memory=torch.device(device).type == "cuda")


def stage_in(pool: dict, rows) -> dict:
    """A host gather of ``pool``'s ``rows`` (an index array: passing
    ``perm[lo:hi]`` stages in the rows a boundary's map names; under a
    mesh ``engine.run_wave`` passes this rank's rows of the wave). The
    engine's ``stage_in`` adds the copy to the card."""
    idx = torch.as_tensor(rows, dtype=torch.long)
    return tree_map(lambda leaf: leaf.index_select(0, idx), pool)


def write_rows(pool: dict, lo: int, host: dict) -> None:
    """Write a wave's host tree into pool rows [lo, lo+W)."""
    tree_map(lambda dst, src: dst[lo:lo + src.shape[0]].copy_(src), pool, host)


def pool_rows(pool: dict, lo: int, w: int) -> dict:
    """Views of pool rows [lo, lo+w): a stage-out destination."""
    return tree_map(lambda leaf: leaf[lo:lo + w], pool)


class StagingEngine:
    """Copies waves between the host pools and the card, with one
    worker thread landing the copies in FIFO order.

    ``stage_out(tree, dst, on_done=None)`` copies ``tree`` (device
    tensors) into ``dst`` (host tensors of the same structure, usually
    pool rows) and then calls ``on_done()`` on the worker. ``drain()``
    blocks until every queued transfer has landed and re-raises the
    first error the worker met; ``stage_out`` refuses to queue onto a
    failed engine."""

    def __init__(self, device=None):
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._in_stream = torch.cuda.Stream(self.device)
            self._out_stream = torch.cuda.Stream(self.device)
        self._slice = None  # the pinned staging slice, a tree of [W, ...]
        self._slice_free = None  # event: the last copy out of the slice ended
        self._last_ready = None  # event: the last staged-out wave's compute ended
        self._in_events: list = []  # (start, end) of stage-in copies not yet timed
        self._q: "queue.Queue" = queue.Queue()
        self._errors: list = []
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._pending = 0
        self.staged_bytes = 0
        self.transfers = 0
        self.transfer_s = 0.0
        self.wait_s = 0.0
        self._closed = False
        self._thread = threading.Thread(target=self._loop, name="mpi-opt-staging", daemon=True)
        self._thread.start()

    # -- worker ------------------------------------------------------------

    def _loop(self):  # sweeplint: barrier(the transfer thread waits on each wave's copy events, never the main loop)
        from mpi_opt_tpu_torch.health import heartbeat

        while True:
            job = self._q.get()
            if job is None:
                return
            src, dst, on_done, events, n_bytes = job
            t0 = time.perf_counter()
            copy_s = 0.0
            try:
                with trace.span("stage_out") as sp:
                    if events is None:  # the CPU: the copy is this thread's
                        tree_map(lambda d, s: d.copy_(s), dst, src)
                    else:
                        start, end = events
                        end.synchronize()
                        copy_s = start.elapsed_time(end) / 1e3
                    t1 = time.perf_counter()
                    if on_done is not None:
                        on_done()
                    sp["bytes"] = n_bytes
                    memory.note(sp, self.device)
                    with self._lock:
                        self.staged_bytes += n_bytes
                        self.transfers += 1
                        self.transfer_s += copy_s + (time.perf_counter() - (t1 if events else t0))
                        n = self.transfers
                        # the engine's cumulative accounting on every
                        # transfer span, so a run killed mid-interval
                        # still carries its overlap evidence
                        sp["wait_s"] = round(self.wait_s, 6)
                        sp["overlap_s"] = round(self.overlap_s, 6)
                    # per-transfer liveness while the main thread waits in
                    # drain(), beaten inside the span so its phase reads
                    # stage_out
                    heartbeat.beat(stage="staging transfer", transfers=n)
            # sweeplint: disable=drain-swallow -- transfer-thread containment: the error is stored and re-raised to the main thread by drain()
            except BaseException as e:
                with self._lock:
                    self._errors.append(e)
            finally:
                del src, dst, job
                with self._lock:
                    self._pending -= 1
                    if self._pending == 0:
                        self._idle.notify_all()

    # -- main-thread API -----------------------------------------------------

    def stage_in(self, pool: dict, rows) -> dict:
        """The wave ``rows`` of ``pool`` on the engine's device. On CUDA
        the rows are gathered into the pinned staging slice and copied
        on the stage-in stream; the current stream waits for the copy."""
        if not self._cuda:
            dev = stage_in(pool, rows)
            self.note_bytes(tree_bytes(dev))
            return dev
        w = len(rows)
        idx = torch.as_tensor(rows, dtype=torch.long)
        if self._slice_free is not None:
            # sweeplint: barrier(the pinned slice is reused: the main thread waits for the previous wave's copy to leave it)
            self._slice_free.synchronize()
        if self._slice is None or tree_leaves(self._slice)[0].shape[0] < w:
            self._slice = tree_map(
                lambda leaf: torch.empty((w,) + tuple(leaf.shape[1:]), dtype=leaf.dtype, pin_memory=True),
                pool)
        host = tree_map(lambda leaf, s: torch.index_select(leaf, 0, idx, out=s[:w]), pool, self._slice)
        compute = torch.cuda.current_stream(self.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._in_stream):
            # allocated on the stage-in stream, which writes them first
            dev = tree_map(lambda h: torch.empty_like(h, device=self.device), host)
            start.record()
            tree_map(lambda d, h: d.copy_(h, non_blocking=True), dev, host)
            end.record()
        for d in tree_leaves(dev):
            d.record_stream(compute)
        compute.wait_event(end)
        self._slice_free = end
        self._in_events.append((start, end))
        self.note_bytes(tree_bytes(host))
        return dev

    def stage_out(self, tree: dict, dst: dict, on_done: Optional[Callable[[], None]] = None) -> None:
        """Queue the copy of ``tree`` into ``dst``; on CUDA it runs on
        the stage-out stream after everything the current stream has
        queued (the wave's training and eval)."""
        if self._closed:
            raise RuntimeError("StagingEngine is closed")
        with self._lock:
            if self._errors:  # fail fast instead of queueing onto a wreck
                raise self._errors[0]
            self._pending += 1
        events = None
        if self._cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(self._out_stream):
                self._out_stream.wait_event(ready)
                start.record()
                for s, d in zip(tree_leaves(tree), tree_leaves(dst)):
                    d.copy_(s, non_blocking=True)
                    s.record_stream(self._out_stream)
                end.record()
            self._last_ready = ready
            events = (start, end)
            tree = None  # the allocator holds the memory until the copy ran
        self._q.put((tree, dst, on_done, events, tree_bytes(dst)))

    def note_bytes(self, n: int) -> None:
        """Account stage-in bytes (main thread)."""
        with self._lock:
            self.staged_bytes += int(n)

    def drain(self) -> None:  # sweeplint: barrier(the interval's completion barrier: waits for every staged-out wave)
        """Block until every queued transfer has landed; re-raise the
        first worker error. Time spent waiting for the last wave's
        compute is not staging cost; what follows it is ``wait_s``."""
        if self._last_ready is not None:
            self._last_ready.synchronize()
        t0 = time.perf_counter()
        with trace.span("stage_wait") as sp, self._idle:
            while self._pending:
                self._idle.wait(timeout=0.5)
            self.wait_s += time.perf_counter() - t0
            for start, end in self._in_events:
                end.synchronize()
                self.transfer_s += start.elapsed_time(end) / 1e3
            self._in_events.clear()
            sp["wait_s"] = round(self.wait_s, 6)
            sp["overlap_s"] = round(self.overlap_s, 6)
            if self._errors:
                raise self._errors[0]

    @property
    def overlap_s(self) -> float:
        return max(0.0, self.transfer_s - self.wait_s)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=60)


def measured_train_peak(metrics_path: str) -> Optional[int]:
    """The largest ``mem_peak_bytes`` over the device-occupying spans
    (train, stage_in, stage_out) of an earlier traced run's metrics
    stream; None when the stream has none (untraced, missing, or a CPU
    run). Torn or foreign lines are skipped: a stream may end mid-line
    after a kill."""
    import json

    peak = None
    try:
        with open(metrics_path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(rec, dict) or rec.get("event") != "span":
                    continue
                if rec.get("span") not in ("train", "stage_in", "stage_out"):
                    continue
                v = rec.get("mem_peak_bytes")
                if isinstance(v, (int, float)):
                    peak = max(peak or 0, int(v))
    except OSError:
        return None
    return peak


def envelope_report(trainer, population: int, metrics_path: str) -> dict:
    """The static per-member envelope against a measured watermark:
    ``metrics_path`` is an earlier traced run of the same (workload,
    population), whose span ``mem_peak_bytes`` is what the population
    cost the card (the allocator's peak, which includes activations and
    the data). Returns ``per_member_bytes`` (``member_bytes``: parameters
    and momentum), ``static_pop_bytes``, ``measured_peak_bytes`` and
    ``measured_over_static`` (None fields without a watermark). A ratio
    far above the headroom ``estimate_wave_size`` assumes means ``auto``
    waves would not fit: pass the measurement back as its
    ``measured_peak``."""
    per_member = trainer.member_bytes()
    static_pop = per_member * int(population)
    peak = measured_train_peak(metrics_path)
    return {
        "per_member_bytes": int(per_member),
        "static_pop_bytes": int(static_pop),
        "measured_peak_bytes": None if peak is None else int(peak),
        "measured_over_static": (
            None if peak is None or static_pop <= 0 else round(peak / static_pop, 4)
        ),
    }


def estimate_wave_size(trainer, population: int, budget_bytes: Optional[int] = None,
                       measured_peak: Optional[tuple] = None, mesh=None) -> int:
    """The ``--wave-size auto`` residency estimate: the largest wave
    whose carried state (``PopulationTrainer.member_bytes`` a member,
    from the meta template) fits 35% of the device budget (the wave loop
    holds up to two waves, and training needs activation headroom on
    top). Budget order: ``budget_bytes``, then ``MPI_OPT_TPU_DEVICE_BYTES``
    (the operator's override), then the card's measured memory
    (``obs.memory.measured_budget``; none on the CPU), then 8 GiB.

    ``measured_peak`` = ``(peak_bytes, resident_members)`` of an earlier
    run sizes a second estimate at 85% of the budget from the measured
    all-in cost a member, and the smaller estimate wins. Returns a value
    in [1, population]; ``population`` means everything fits. With a
    member chunk the estimate holds whole chunks, at least one
    (``engine.whole_chunks``).

    With a mesh a wave splits over the ``pop`` axis, so the budget
    scales by that axis and the estimate is rounded DOWN to a multiple
    of it (a wave that does not divide would run replicated). The
    budget is this rank's card; ``resolve_wave_size`` min-agrees the
    ranks' caps through the coord plane."""
    from mpi_opt_tpu_torch.train.engine import whole_chunks

    per_member = trainer.member_bytes()
    if budget_bytes is None:
        env = os.environ.get("MPI_OPT_TPU_DEVICE_BYTES")
        if env:
            budget_bytes = int(env)
    if budget_bytes is None:
        from mpi_opt_tpu_torch.obs import memory

        budget_bytes = memory.measured_budget(trainer.device)
    if budget_bytes is None:
        budget_bytes = 8 << 30
    n_pop = int(mesh.shape["pop"]) if mesh is not None else 1
    w = int(budget_bytes * 0.35 * n_pop // max(1, per_member))
    if measured_peak:
        peak_bytes, members = measured_peak
        if peak_bytes and members:
            measured_member = max(1, int(peak_bytes) // max(1, int(members)))
            w = min(w, max(1, int(budget_bytes * 0.85 * n_pop // measured_member)))
    if mesh is not None and w > n_pop:
        w -= w % n_pop
    return whole_chunks(max(1, min(population, w)), trainer.member_chunk, population)

"""The ``('pop', 'data')`` mesh on ``torch.distributed`` (port of
``mpi_opt_tpu/parallel/mesh.py``).

The JAX package shards global arrays over a device mesh and lets XLA's
SPMD partitioner insert the collectives. The port follows PyTorch's
idiom instead: one process per device (a rank), each holding ITS rows
of the population, and explicit collectives where XLA inserted them:

- ``pop`` splits the members. Rank ``r`` holds the contiguous rows
  ``[pop_index * n/n_pop, (pop_index + 1) * n/n_pop)`` of an
  ``n``-member cohort; a cohort that ``n_pop`` does not divide is
  replicated on every rank, with the JAX package's warning. Scores come
  back through ``gather`` (an all_gather over the ranks that share a
  ``data_index``, concatenated in pop order), and an exploit or rung
  cut moves only the rows it copies, as send/recv pairs (``exchange``).
- ``data`` splits each member's minibatch; the gradients are averaged
  over the ranks that share a ``pop_index`` (``data_mean_``, the psum
  XLA inserts for a batch sharded over ``data``). The data axis is
  innermost (``data_index = rank % n_data``), as in the JAX mesh.

Every rank holds the full host copy of what the host decides (unit
matrices, scores, exploit maps), derived by identical code from
identical draws, as SPMD ranks do in the JAX package.

Backend. ``initialize_multihost`` chooses it once, from counts: ``nccl``
when every rank on the host has a card of its own, ``gloo`` when ranks
share a card or run on the CPU (NCCL refuses two ranks on one device).
Under gloo every collective of this module takes host tensors: a CUDA
tensor is copied to the host before the collective and back after it,
here and nowhere else (``_to_wire``/``_from_wire``).

Device OOM on one rank. Every collective of this module, and the end
of each of the wave engine's interval attempts, opens with one check-in
(``check_in``): a 1-element all_reduce over the world. A rank whose
attempt ran out of device memory stops where it was and checks in with
its flag from the engine's handler; its peers' next check-in is that
same one, wherever in the attempt they are, so every rank learns of the
OOM there (a peer raises ``PeerOOM``) and the world halves its wave cap
together instead of waiting in mismatched collectives.

With a world of one there is no process group: a 1 x 1 mesh's
collectives are identities.
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import Optional

import numpy as np
import torch

from mpi_opt_tpu_torch.utils.resources import DeviceOOM

#: the process group's backend and this rank's device, set by
#: ``initialize_multihost`` (None before it, or in a world of one)
_WORLD: dict = {"backend": None, "device": None}


class PeerOOM(DeviceOOM):
    """Another rank ran out of device memory in this attempt: raised by
    the check-in that carried its flag, on each rank that did not."""


def check_in(failed: bool = False) -> bool:
    """The fault check-in: one all_reduce (max) of ``failed`` over the
    world; True when any rank failed. Every rank calls it the same
    number of times: at the start of each collective of ``Mesh`` (and
    with ``failed`` from the wave engine's OOM handler, or at the end of
    a clean attempt). Without a process group it is ``failed``."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return failed
    dev = "cpu" if _WORLD["backend"] != "nccl" else _WORLD["device"]
    flag = torch.tensor([int(failed)], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def _check_in() -> None:
    """A collective's check-in: raises ``PeerOOM`` when a peer failed."""
    if check_in():
        raise PeerOOM("a peer rank ran out of device memory in this attempt")


def _warn_replicated(n: int, n_pop: int) -> None:
    """One runtime signal for the replication fallback (the JAX
    package's text): replication turns an intended N-rank sweep into an
    effectively one-rank one, which a user should learn from a warning."""
    lo, hi = (n // n_pop) * n_pop, -(-n // n_pop) * n_pop
    hint = f"e.g. {hi}" if lo == 0 else f"e.g. {lo} or {hi}"
    warnings.warn(
        f"population axis of size {n} does not divide the mesh 'pop' axis "
        f"({n_pop}); the array is replicated on every device instead of "
        f"sharded — correct, but not member-parallel. Use a population "
        f"that is a multiple of {n_pop} ({hint}).",
        RuntimeWarning,
        stacklevel=3,
    )


def mesh_shape(world: int, n_pop: Optional[int] = None, n_data: int = 1) -> tuple[int, int]:
    """``(n_pop, n_data)`` over ``world`` ranks, with the JAX
    ``make_mesh``'s errors. ``n_pop`` defaults to ``world // n_data``.
    Unlike a JAX mesh, which may leave devices out, every rank must be
    in the mesh: a rank outside it would have no rows to run."""
    if n_pop is None:
        if world % n_data:
            raise ValueError(f"{world} devices not divisible by n_data={n_data}")
        n_pop = world // n_data
    need = n_pop * n_data
    if need > world:
        raise ValueError(f"mesh {n_pop}x{n_data} needs {need} devices, have {world}")
    if need < world:
        raise ValueError(
            f"mesh {n_pop}x{n_data} uses {need} of {world} ranks; every rank of the world "
            "must be in the mesh (one process per device)"
        )
    return n_pop, n_data


def choose_backend(device_type: str, local_ranks: int, device_count: int) -> str:
    """The process group's backend, from counts, once: ``nccl`` when
    every one of the host's ``local_ranks`` has a card of its own,
    ``gloo`` when ranks share a card or run on the CPU. Never "try
    NCCL, then gloo"."""
    if device_type == "cuda" and 0 < local_ranks <= device_count:
        return "nccl"
    return "gloo"


class Mesh:
    """This rank's view of the ``('pop', 'data')`` mesh: ``shape`` (so
    ``mesh.shape["pop"]`` reads as in the JAX package), ``rank``,
    ``world``, ``device``, ``backend``, ``pop_index``, ``data_index``,
    and the two process groups (None where the axis is 1): ``pop_group``
    (the ranks that share this ``data_index``: they split the members)
    and ``data_group`` (the ranks that share this ``pop_index``: they
    split the batch)."""

    def __init__(self, n_pop: int, n_data: int = 1, *, rank: int = 0, world: int = 1,
                 device=None, backend: Optional[str] = None):
        self.shape = {"pop": int(n_pop), "data": int(n_data)}
        self.rank, self.world = int(rank), int(world)
        self.size = self.shape["pop"] * self.shape["data"]
        self.pop_index, self.data_index = divmod(self.rank, self.shape["data"])
        self.device = torch.device("cpu" if device is None else device)
        self.backend = backend
        #: the global ranks of this rank's pop group, in pop order
        self.pop_ranks = [p * n_data + self.data_index for p in range(n_pop)]
        self.pop_group = self.data_group = None

    def __repr__(self) -> str:
        return (f"Mesh(pop={self.shape['pop']}, data={self.shape['data']}, rank={self.rank}, "
                f"backend={self.backend}, device={self.device})")

    # -- rows -----------------------------------------------------------------

    def shards(self, n: int) -> bool:
        """Does an ``n``-member cohort split over ``pop`` (else every
        rank holds all of it)?"""
        return self.shape["pop"] > 1 and n % self.shape["pop"] == 0

    def rows(self, n: int, warn: bool = True) -> tuple[int, int]:
        """This rank's rows ``[a, b)`` of an ``n``-member cohort: its
        contiguous slice, or all ``n`` (with the replication warning)
        when ``n_pop`` does not divide ``n``."""
        if self.shards(n):
            k = n // self.shape["pop"]
            return self.pop_index * k, (self.pop_index + 1) * k
        if warn and self.shape["pop"] > 1:
            _warn_replicated(n, self.shape["pop"])
        return 0, n

    def _rows_of(self, pop_index: int, n: int) -> tuple[int, int]:
        """The rows ``[a, b)`` pop index ``pop_index`` holds of ``n``."""
        if not self.shards(n):
            return 0, n
        k = n // self.shape["pop"]
        return pop_index * k, (pop_index + 1) * k

    def owner(self, i: int, n: int) -> int:
        """The pop index holding row ``i`` of an ``n``-member cohort
        (this rank's own when the cohort is replicated)."""
        return i // (n // self.shape["pop"]) if self.shards(n) else self.pop_index

    def batch_rows(self, batch: int) -> tuple[int, int]:
        """This rank's rows of a ``batch``-sample minibatch over ``data``."""
        n_data = self.shape["data"]
        if batch % n_data:
            raise ValueError(f"batch_size {batch} not divisible by the mesh 'data' axis ({n_data})")
        k = batch // n_data
        return self.data_index * k, (self.data_index + 1) * k

    # -- collectives ------------------------------------------------------------

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor a collective takes: gloo moves host memory, so a
        CUDA tensor goes through the host (the one place that does it)."""
        t = t.contiguous()
        return t.cpu() if self.backend == "gloo" and t.is_cuda else t

    @staticmethod
    def _from_wire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return t.to(like.device, non_blocking=False) if t.device != like.device else t

    def gather(self, x: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
        """The global ``n``-row tensor from this rank's rows of ``x``
        (an all_gather over ``pop``, in pop order). A replicated cohort
        (``x`` already holds ``n`` rows, or ``n_pop`` does not divide
        it) is read locally."""
        if n is None:
            n = x.shape[0] * self.shape["pop"]
        if not self.shards(n) or x.shape[0] == n:
            return x
        import torch.distributed as dist

        _check_in()
        w = self._to_wire(x)
        parts = [torch.empty_like(w) for _ in range(self.shape["pop"])]
        dist.all_gather(parts, w, group=self.pop_group)
        return self._from_wire(torch.cat(parts), x)

    def gather_tree(self, tree: dict, n: int, root: Optional[int] = None):
        """``gather`` of every leaf of a (nested) dict of ``[rows, ...]``
        tensors, as ONE flattened collective in the same order on every
        rank (the batched form: a ResNet population is dozens of
        leaves). With ``root`` (a global rank: a snapshot's writer) only
        that rank gets the whole tree, in the wire's memory (the host
        under gloo), and the others get None; ranks outside root's
        ``pop`` group hold copies of its rows and take no part."""
        leaves, rebuild = _flatten(tree)
        outside = root is not None and self.rank != root and root not in self.pop_ranks
        if not self.shards(n):
            return tree if root is None or self.rank == root else None
        if not leaves or leaves[0].shape[0] == n:
            return None if outside else tree
        import torch.distributed as dist

        _check_in()  # on every rank, those outside root's group too
        if outside:
            return None
        buf = self._to_wire(_pack(leaves))
        if root is None:
            parts = [torch.empty_like(buf) for _ in range(self.shape["pop"])]
            dist.all_gather(parts, buf, group=self.pop_group)
            parts = [p.to(leaves[0].device) for p in parts]
        else:
            parts = [torch.empty_like(buf) for _ in range(self.shape["pop"])] if self.rank == root else None
            dist.gather(buf, parts, dst=root, group=self.pop_group)
            if self.rank != root:
                return None
        per_rank = [_unpack(p, leaves) for p in parts]
        return rebuild([torch.cat([pr[j] for pr in per_rank]) for j in range(len(leaves))])

    def data_mean_(self, tensors: list) -> None:
        """Average ``tensors`` (f32) in place over ``data``: one
        all_reduce of their flattened concatenation. Every rank of the
        data group ends with the same bits."""
        if self.shape["data"] == 1 or not tensors:
            return
        import torch.distributed as dist

        _check_in()
        flat = torch.cat([t.reshape(-1) for t in tensors])
        w = self._to_wire(flat)
        dist.all_reduce(w, op=dist.ReduceOp.SUM, group=self.data_group)
        flat = self._from_wire(w, flat).div_(self.shape["data"])
        o = 0
        for t in tensors:
            t.copy_(flat[o:o + t.numel()].view_as(t))
            o += t.numel()

    def exchange(self, tree: dict, src_idx, n_old: int, base: Optional[dict] = None) -> dict:
        """The rows this rank holds after a gather by ``src_idx``: new
        row ``j`` (of ``len(src_idx)``) continues from old row
        ``src_idx[j]`` of an ``n_old``-member cohort. Rows another rank
        owns arrive as ONE send/recv message per (source, destination)
        pair, packed in destination-row order (derived from
        ``src_idx``, which every rank holds, so both ends agree); rows
        already here are a local ``index_select``. Nothing else moves:
        a PBT exploit copies a quarter of the population, not all of it.
        ``tree`` is a (nested) dict of ``[local rows, ...]`` tensors.

        With ``base`` (this rank's rows of a ``len(src_idx)``-member
        cohort of the same structure) a negative ``src_idx[j]`` keeps
        ``base``'s row ``j``: a scatter into a slot pool."""
        src = [int(v) for v in np.asarray(torch.as_tensor(src_idx).cpu())]
        n_new = len(src)
        a_new, b_new = self.rows(n_new, warn=False)
        a_old, _ = self.rows(n_old, warn=False)
        leaves, rebuild = _flatten(tree)
        base_leaves = None if base is None else _flatten(base)[0]
        dev = leaves[0].device
        if not self.shards(n_old):
            if base_leaves is None:
                idx = torch.as_tensor(src[a_new:b_new], dtype=torch.long, device=dev)
                return rebuild([leaf.index_select(0, idx) for leaf in leaves])
            out = []
            for leaf, bl in zip(leaves, base_leaves):
                rows = [leaf[s:s + 1] if s >= 0 else bl[j - a_new:j - a_new + 1]
                        for j, s in zip(range(a_new, b_new), src[a_new:b_new])]
                out.append(torch.cat(rows) if rows else bl[:0].clone())
            return rebuild(out)
        import torch.distributed as dist

        _check_in()
        me = self.pop_index
        # what this rank sends: to each destination, the rows it owns
        # that the destination's new rows read, in destination-row order
        sends: dict = {}
        for q in range(self.shape["pop"]):
            if q == me:
                continue
            qa, qb = self._rows_of(q, n_new)
            rows = [src[j] - a_old for j in range(qa, qb)
                    if src[j] >= 0 and self.owner(src[j], n_old) == me]
            if rows:
                sends[q] = rows
        # what this rank receives, per source, in its new-row order
        recvs: dict = {}
        for j in range(a_new, b_new):
            if src[j] < 0:
                continue
            p = self.owner(src[j], n_old)
            if p != me:
                recvs.setdefault(p, []).append(j)
        ops, bufs = [], {}
        for q, rows in sorted(sends.items()):
            idx = torch.as_tensor(rows, dtype=torch.long, device=dev)
            buf = self._to_wire(_pack([leaf.index_select(0, idx) for leaf in leaves]))
            ops.append(dist.isend(buf, dst=self.pop_ranks[q]))
            bufs[("s", q)] = buf
        shapes = {p: [torch.empty((len(js),) + tuple(leaf.shape[1:]), dtype=leaf.dtype,
                                  device="meta") for leaf in leaves]
                  for p, js in recvs.items()}
        for p in sorted(recvs):
            buf = torch.empty(_packed_bytes(shapes[p]), dtype=torch.uint8,
                              device="cpu" if self.backend == "gloo" else dev)
            ops.append(dist.irecv(buf, src=self.pop_ranks[p]))
            bufs[("r", p)] = buf
        for op in ops:
            op.wait()
        received = {p: _unpack(bufs[("r", p)].to(dev), shapes[p]) for p in recvs}
        slot = {j: (p, i) for p, js in recvs.items() for i, j in enumerate(js)}
        out = []
        for li, leaf in enumerate(leaves):
            rows = []
            for j in range(a_new, b_new):
                if j in slot:
                    p, i = slot[j]
                    rows.append(received[p][li][i:i + 1])
                elif src[j] < 0:
                    rows.append(base_leaves[li][j - a_new:j - a_new + 1])
                else:
                    rows.append(leaf[src[j] - a_old:src[j] - a_old + 1])
            out.append(torch.cat(rows) if rows else leaf[:0].clone())
        return rebuild(out)


def _flatten(tree):
    """(leaves, rebuild) of a nested dict of tensors, in sorted-key
    order (identical on every rank)."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    keys = sorted(tree)
    subs = [_flatten(tree[k]) for k in keys]
    sizes = [len(s[0]) for s in subs]

    def rebuild(leaves):
        out, o = {}, 0
        for k, (_, rb), n in zip(keys, subs, sizes):
            out[k] = rb(leaves[o:o + n])
            o += n
        return out

    return [leaf for s in subs for leaf in s[0]], rebuild


def _packed_bytes(leaves) -> int:
    return sum(t.numel() * t.element_size() for t in leaves)


def _pack(leaves) -> torch.Tensor:
    """Leaves of mixed dtypes as one uint8 buffer (their raw bytes)."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in leaves])


def _unpack(buf: torch.Tensor, like) -> list:
    """``_pack``'s inverse: tensors shaped and typed as ``like`` (each
    leaf's row count taken from its ``like``)."""
    out, o = [], 0
    for t in like:
        nb = t.numel() * t.element_size()
        # copied before the view: a slice after an odd count of 2-byte
        # values is not aligned for a 4-byte type
        out.append(buf[o:o + nb].clone().view(t.dtype).reshape(t.shape))
        o += nb
    return out


def make_mesh(n_pop: Optional[int] = None, n_data: int = 1) -> Mesh:
    """This rank's ``('pop', 'data')`` mesh over the world
    ``initialize_multihost`` brought up (a world of one without it).
    Every rank builds every group in the same order, as
    ``torch.distributed.new_group`` requires."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    rank = dist.get_rank() if up else 0
    n_pop, n_data = mesh_shape(world, n_pop, n_data)
    mesh = Mesh(n_pop, n_data, rank=rank, world=world, device=_WORLD["device"],
                backend=_WORLD["backend"] if up else None)
    if world > 1:
        if n_pop > 1:
            for d in range(n_data):
                g = dist.new_group([p * n_data + d for p in range(n_pop)])
                if d == mesh.data_index:
                    mesh.pop_group = g
        if n_data > 1:
            for p in range(n_pop):
                g = dist.new_group([p * n_data + d for d in range(n_data)])
                if p == mesh.pop_index:
                    mesh.data_group = g
    return mesh


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    require: bool = False,
    *,
    device=None,
    timeout_s: float = 300.0,
) -> int:
    """Bring up the process group (the role of ``mpirun`` +
    ``MPI_Init``); returns this process's rank.

    With ``coordinator_address`` ("HOST:PORT") the group starts at
    ``tcp://HOST:PORT`` with ``num_processes`` ranks, this one
    ``process_id``. Without it torch's ``env://`` variables
    (``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``) stand in
    for the JAX package's pod auto-detection; with none set the world is
    one process, unless ``require`` asks for more (then it raises). A
    world of one starts no group.

    ``device`` ("cpu", or None/"cuda": the card) fixes the rank's device
    BEFORE the group starts: ``cuda:{local_rank % device_count}``, where
    ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` default to the rank and the
    world (one host). The backend is ``choose_backend``'s, made once.
    A CUDA rank without CUDA raises: no rank falls back to the CPU.
    ``timeout_s`` bounds every collective, so a dead peer ends in an
    error instead of torch's default wait."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    explicit = coordinator_address is not None
    if explicit:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and --process-id")
        world, rank = int(num_processes), int(process_id)
        init_method = f"tcp://{coordinator_address}"
    elif os.environ.get("WORLD_SIZE"):
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ.get("RANK", "0"))
        init_method = "env://"
    else:
        if require or num_processes not in (None, 1):
            raise RuntimeError(
                "multi-process bring-up requested but no world was given: pass "
                "--coordinator/--num-processes/--process-id, or set torch's env:// "
                "variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)"
            )
        return 0
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside a world of {world}")
    if world == 1:
        return 0
    dev_type = torch.device("cuda" if device is None else device).type
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu to run the ranks on the CPU")
        count = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
    else:
        count, dev = 0, torch.device("cpu")
    backend = choose_backend(dev.type, local_world, count)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=float(timeout_s)))
    _WORLD.update(backend=backend, device=dev)
    return rank


def world_info() -> dict:
    """``{"backend", "device", "rank", "world"}`` of this process."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    return {"backend": _WORLD["backend"] if up else None, "device": _WORLD["device"],
            "rank": dist.get_rank() if up else 0, "world": dist.get_world_size() if up else 1}


def shutdown_multihost() -> None:
    """Tear the process group down (the end of a CLI run)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _WORLD.update(backend=None, device=None)

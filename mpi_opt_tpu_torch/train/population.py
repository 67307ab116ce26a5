"""The population trainer (port of ``mpi_opt_tpu/train/population.py``).

One shared minibatch per step, per-member augmentation (per-sample flip,
per-member circular shift), and a per-member SGD + momentum + coupled
weight decay update, with the hyperparameters as ``[P]`` tensors. The
JAX package ``vmap``s one member's step; here the model runs all
members at once in population form (``models/resnet.py``), and the loss
is the sum of the members' mean losses, so autograd gives each member
its own gradient.

Every random draw takes an explicit ``torch.Generator`` and is split
into a draw and an apply (``draw_batch``, ``draw_augment`` /
``apply_augment``), so tests can feed the JAX package's draws to the
apply.

A wave of a larger population (``train/engine.py``) trains through
``train_segment_window`` and is initialised by ``init_population_into``;
both make the draws of the whole population, so a wave's members get
the numbers they would get resident. The driver path's slot pool
(``backends/gpu.py``) trains a batch of mixed budgets in one chain
through ``train_segment_masked`` and overwrites its fresh members with
``select_members``.

One launch width. cuDNN on the card and oneDNN on the CPU choose a
grouped convolution's algorithm by its group count, so a member's
numbers depend on how many members share its launch. With
``member_chunk`` = k every launch (training step or eval chunk) runs
exactly k members: a short chunk is padded with copies of its last real
member, whose losses, gradients and scores are dropped before anything
reads them. A resident sweep, its waves, an OOM-backed-off re-run and
an SHA rung of any size then launch the same shape, and each member
gives the same bits. Without a member chunk a launch is the whole
cohort (or wave) the trainer is handed, except in a wave sweep that
may halve its cap: the wave engine then gives every launch one fixed
width (``train/engine.py::launch_chunk``, through ``launching``).

Under a ``('pop', 'data')`` mesh (``on_mesh``, ``parallel/mesh.py``) a
``PopState`` holds THIS rank's rows of a ``cohort``-member population
(its contiguous slice over ``pop``, or all of them when ``pop`` does not
divide the cohort), while hyperparameters, scores and exploit maps stay
global, as every rank's host holds them. Every rank makes the whole
cohort's draws (init, batch, augmentation) and keeps its slice, so a
pop-sharded run equals a one-process run launched at the same width
(``member_chunk = P / n_pop``). ``eval_population`` returns the global
scores (an all_gather over ``pop``), ``gather_members`` moves only the
rows another rank owns, and over ``data`` a rank trains on its share of
each minibatch and averages gradients and losses with its data peers
before the update.

Each step is traced in phases (``obs/trace.py``): a ``batch`` span
draws the batch and the augmentation and gathers the rows, and each
member chunk runs a ``forward`` (parameter views, inputs, logits, loss),
a ``backward`` (the gradients, averaged over ``data`` under a mesh) and
an ``update`` (the per-leaf optimiser step); each ``eval_population``
call is an ``eval`` span. Untraced, a span is a frame pushed and popped.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch.func import functional_call

from mpi_opt_tpu_torch.device import resolve_device
from mpi_opt_tpu_torch.models.resnet import fold_members, init_layers
from mpi_opt_tpu_torch.obs import trace


@dataclasses.dataclass
class OptHParams:
    """Per-member hyperparameters; every field is a float32 [P] tensor."""

    lr: torch.Tensor
    momentum: torch.Tensor
    weight_decay: torch.Tensor
    flip_prob: torch.Tensor  # per-sample horizontal flip probability
    shift: torch.Tensor  # max augmentation shift in pixels (continuous)

    @staticmethod
    def defaults(n: int, lr: float = 0.1, device=None) -> "OptHParams":
        f = lambda v: torch.full((n,), v, dtype=torch.float32, device=device)
        return OptHParams(f(lr), f(0.9), f(1e-4), f(0.5), f(3.0))

    def rows(self, a: int, b: int) -> "OptHParams":
        """Members [a, b) (slicing is exact)."""
        return OptHParams(*(getattr(self, f.name)[a:b] for f in dataclasses.fields(self)))


@dataclasses.dataclass
class PopState:
    """Population training state; every tensor's leading axis is the
    member. Under a mesh the rows are this rank's of a ``cohort``-member
    population (0: the state is the whole population)."""

    params: dict
    momentum: dict
    step: torch.Tensor  # int32[P]
    cohort: int = 0


def draw_batch(generator: torch.Generator, n_data: int, batch_size: int) -> torch.Tensor:
    """Minibatch indices, int64[batch_size] in [0, n_data)."""
    return torch.randint(0, n_data, (batch_size,), generator=generator, device=generator.device)


def draw_augment(generator: torch.Generator, flip_prob, shift, batch: int):
    """(do_flip bool[P, B], dy int64[P], dx int64[P]): a per-sample flip
    with each member's probability, and per-member shifts rounded (half
    to even, as ``jnp.round``) from uniform draws on [-shift, shift]."""
    p = flip_prob.shape[0]
    dev = generator.device
    do_flip = torch.rand((p, batch), generator=generator, device=dev) < flip_prob[:, None]
    max_s = torch.clamp(shift, min=0.0)
    u = torch.rand((2, p), generator=generator, device=dev)
    dy, dx = torch.round(-max_s + 2.0 * max_s * u).long()
    return do_flip, dy, dx


def apply_augment(x: torch.Tensor, do_flip, dy, dx) -> torch.Tensor:
    """Shared ``[B, H, W, C]`` batch -> per-member ``[B, H, W, P, C]``:
    flip the flagged samples along W, then roll each member's images by
    (dy, dx) with wrap-around (``jnp.roll``), as one gather."""
    b, h, w, _ = x.shape
    p = dy.shape[0]
    dev = x.device
    rows = (torch.arange(h, device=dev)[None, :] - dy[:, None]) % h  # [P, H]
    cols = (torch.arange(w, device=dev)[None, :] - dx[:, None]) % w  # [P, W]
    cols = torch.where(do_flip[:, :, None], w - 1 - cols[:, None, :], cols[:, None, :])  # [P,B,W]
    bi = torch.arange(b, device=dev).view(b, 1, 1, 1)
    return x[bi, rows.t().reshape(1, h, 1, p), cols.permute(1, 2, 0).reshape(b, 1, w, p)]


def _rows(t: torch.Tensor, a: int, b: int, width: int) -> torch.Tensor:
    """Rows [a, b) of ``t``, padded to ``width`` rows with copies of row
    b-1 (a view when no padding is needed)."""
    if b - a == width:
        return t[a:b]
    idx = torch.arange(a, a + width, device=t.device).clamp_(max=b - 1)
    return t.index_select(0, idx)


def _member_loss(logits: torch.Tensor, by: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy per member, in f32: logits [P, B, K] -> [P]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    idx = by[None, :, None].expand(logp.shape[0], -1, 1)
    return -logp.gather(2, idx).squeeze(2).mean(dim=1)


class PopulationTrainer:
    """Trains and scores a population of one model.

    Args:
        model_fn: ``model_fn(population, device) -> nn.Module`` in
            population form (input ``[B, P*C, H, W]``, logits ``[P, B, K]``).
        batch_size: per-step minibatch size (shared across members).
        augment: whether image augmentation applies.
        member_chunk: if >0, every launch runs exactly this many members
            (activation-memory relief; params/momentum stay resident); a
            short slice is padded with stand-ins whose results are dropped.
        device: where the population lives.
        momentum_dtype: the momentum's storage dtype (None: f32, as the
            parameters); the update runs in f32 whatever it is.
    """

    def __init__(self, model_fn, batch_size: int = 256, augment: bool = True,
                 member_chunk: int = 0, device=None, momentum_dtype: torch.dtype | None = None):
        self.model_fn = model_fn
        self.batch_size = batch_size
        self.augment = augment
        self.member_chunk = member_chunk
        self.device = resolve_device(device)
        self.momentum_dtype = momentum_dtype
        self.mesh = None
        # parameters are always passed in (functional_call), so the
        # module itself holds none: built on the meta device
        self.template = model_fn(1, "meta")

    def on_mesh(self, mesh) -> "PopulationTrainer":
        """This trainer over a ``('pop', 'data')`` mesh (a shallow copy;
        None gives the one-process trainer). A batch the ``data`` axis
        does not divide raises ``ValueError``."""
        if mesh is not None:
            mesh.batch_rows(self.batch_size)
        trainer = copy.copy(self)
        trainer.mesh = mesh
        return trainer

    def _mesh_rows(self, n: int):
        """(a, b) of this rank's rows of an ``n``-member cohort."""
        return (0, n) if self.mesh is None else self.mesh.rows(n)

    def init_population(self, generator: torch.Generator, n: int) -> PopState:
        """Fresh states for ``n`` members (this rank's rows of them under
        a mesh: each layer is drawn for all ``n``, its rows kept)."""
        a, b = self._mesh_rows(n)
        if b - a < n:
            params = self._init_rows(generator, n, a, b)
        else:
            model = self.model_fn(n, self.device)
            model.init_params(generator)
            params = {k: v.detach() for k, v in model.named_parameters()}
        momentum = {k: torch.zeros_like(v, dtype=self.momentum_dtype) for k, v in params.items()}
        return PopState(params, momentum, torch.zeros(b - a, dtype=torch.int32, device=self.device),
                        cohort=0 if self.mesh is None else n)

    @torch.no_grad()
    def _init_rows(self, generator: torch.Generator, n: int, a: int, b: int) -> dict:
        """Rows [a, b) of ``init_population``'s parameters, one layer at
        a time (``init_population_into``'s draws: bit-identical), so the
        device holds at most one full-population layer."""
        model = self.model_fn(n, "meta")
        params = {}
        for prefix, layer in init_layers(model):
            layer.to_empty(device=self.device)
            layer.init_params(generator)
            for name, p in layer.named_parameters():
                params[f"{prefix}.{name}" if prefix else name] = p[a:b].clone()
            layer.to_empty(device="meta")
        return {k: params[k] for k, _ in model.named_parameters()}

    def place(self, host: PopState) -> PopState:
        """A whole population held on the host (a restored snapshot) on
        this trainer's device: this rank's rows of it under a mesh."""
        n = host.step.shape[0]
        a, b = self._mesh_rows(n)
        take = lambda d: {k: v[a:b].to(self.device) for k, v in d.items()}
        return PopState(take(host.params), take(host.momentum), host.step[a:b].to(self.device),
                        cohort=0 if self.mesh is None else n)

    def gather_state(self, state: PopState, root=None):
        """``{"params", "momentum", "step"}`` of the WHOLE population
        (a collective under a mesh: every rank must call it; with
        ``root``, a global rank, only that rank gets it, the others
        None)."""
        tree = {"params": state.params, "momentum": state.momentum, "step": state.step}
        if self.mesh is None or not state.cohort:
            return tree
        return self.mesh.gather_tree(tree, state.cohort, root=root)

    def gather_rows(self, x: torch.Tensor, state: PopState) -> torch.Tensor:
        """A per-member value of this rank's rows made global."""
        if self.mesh is None or not state.cohort:
            return x
        return self.mesh.gather(x, state.cohort)

    @torch.no_grad()
    def init_population_into(self, generator: torch.Generator, params: dict) -> None:
        """``init_population``'s parameters written into host tensors
        ``params`` (name -> ``[n, ...]``, a staging pool's), one layer at
        a time: each layer of all n members is drawn on the trainer's
        device, copied out and freed, so the device holds at most one
        full-population layer. The draws and their order are
        ``init_population``'s, so the values are bit-identical."""
        n = next(iter(params.values())).shape[0]
        model = self.model_fn(n, "meta")
        for prefix, layer in init_layers(model):
            layer.to_empty(device=self.device)
            layer.init_params(generator)
            for name, p in layer.named_parameters():
                params[f"{prefix}.{name}" if prefix else name].copy_(p)
            layer.to_empty(device="meta")

    def launching(self, member_chunk: int) -> "PopulationTrainer":
        """This trainer with every launch running ``member_chunk`` members
        (a shallow copy: the template, device and dtypes are shared)."""
        trainer = copy.copy(self)
        trainer.member_chunk = member_chunk
        return trainer

    def member_bytes(self) -> int:
        """Bytes of one member's carried state: parameters at their
        dtypes plus momentum at its storage dtype, from the meta
        template (nothing is allocated)."""
        return sum(p.numel() * (p.dtype.itemsize + (self.momentum_dtype or p.dtype).itemsize)
                   for p in self.template.parameters())

    def _chunks(self, n: int):
        """(a, b, width) of each launch over members [0, n): rows [a, b)
        are real, the rest of ``width`` (the member chunk, or the whole
        cohort without one) are stand-ins."""
        w = self.member_chunk if self.member_chunk > 0 else n
        return [(a, min(a + w, n), w) for a in range(0, n, w)]

    def logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Population forward: folded input -> logits [P, B, K]."""
        return functional_call(self.template, params, (x,))

    def _inputs(self, bx, aug, a: int, b: int, width: int):
        """Folded ``[B, width*C, H, W]`` input of members [a, b), padded
        to ``width`` members."""
        if aug is None:
            xp = bx[:, :, :, None, :].expand(-1, -1, -1, width, -1).contiguous()
        else:
            xp = apply_augment(bx, *(_rows(t, a, b, width) for t in aug))
        return fold_members(xp)

    def _pop_update(self, state: PopState, hp: OptHParams, aug, bx, by, active=None) -> torch.Tensor:
        """One step for the whole population on a shared batch; returns
        the members' losses [P]. Updates ``state`` IN PLACE: each member
        slice's params and momentum are rewritten as soon as its
        gradient exists, so no second copy of the population is held.

        ``active`` (bool [P], optional) freezes the members it clears:
        they compute the step like the others, but their update is the
        identity (lr 0, momentum 1, no decay, gradient 0: ``m*1 + 0 +
        0*p`` is m and ``p - 0*m`` is p, exactly, for finite state; a
        non-finite member scores NaN and is evicted either way) and
        their step count stays, so one launch trains a cohort of mixed
        budgets."""
        losses = []
        for a, b, w in self._chunks(state.step.shape[0]):
            # sweeplint: disable=event-registry -- port-only span, registered in obs/events.py::PORT_SPANS
            with trace.span("forward"):
                params = {k: _rows(v, a, b, w).detach().requires_grad_() for k, v in state.params.items()}
                loss = _member_loss(self.logits(params, self._inputs(bx, aug, a, b, w)), by)
            # sweeplint: disable=event-registry -- port-only span, registered in obs/events.py::PORT_SPANS
            with trace.span("backward"):
                grads = torch.autograd.grad(loss.sum(), list(params.values()))
                if self.mesh is not None and self.mesh.shape["data"] > 1:
                    # the batch is split over ``data``: the full batch's mean
                    # loss and gradient are the data peers' average
                    loss = loss.detach().clone()
                    self.mesh.data_mean_([*grads, loss])
            # sweeplint: disable=event-registry -- port-only span, registered in obs/events.py::PORT_SPANS
            with trace.span("update"), torch.no_grad():
                lr, mu, wd = hp.lr[a:b], hp.momentum[a:b], hp.weight_decay[a:b]
                frozen = None
                if active is not None:
                    frozen = ~active[a:b]
                    lr, mu, wd = lr.masked_fill(frozen, 0.0), mu.masked_fill(frozen, 1.0), wd.masked_fill(frozen, 0.0)
                for k, g in zip(params, grads):
                    # the stand-ins' gradients are dropped here
                    g = g[:b - a]
                    p, m = state.params[k][a:b], state.momentum[k][a:b]
                    shape = (-1,) + (1,) * (p.dim() - 1)
                    if frozen is not None:
                        g.masked_fill_(frozen.view(shape), 0.0)
                    # m32 = mu*m + g + wd*p; p -= lr*m32 (f32, coupled
                    # decay); then m = m32 in its storage dtype. An f32
                    # m is its own .float(), so it updates in place
                    m32 = m.float().mul_(mu.view(shape)).add_(g).add_(wd.view(shape) * p)
                    p.sub_(lr.view(shape) * m32)
                    if m32 is not m:
                        m.copy_(m32)
                losses.append(loss.detach()[:b - a])
        state.step += 1 if active is None else active.to(state.step.dtype)
        return torch.cat(losses)

    def train_segment(self, state: PopState, hp: OptHParams, train_x, train_y,
                      generator: torch.Generator, steps: int):
        """``steps`` shared-batch steps; returns (state, mean losses [steps]).
        Under a mesh ``hp`` covers the whole cohort and ``state`` this
        rank's rows of it."""
        a, _ = self._mesh_rows(hp.lr.shape[0])
        return self.train_segment_window(state, hp, train_x, train_y, generator, steps, a)

    def train_segment_window(self, state: PopState, hp_full: OptHParams, train_x, train_y,
                             generator: torch.Generator, steps: int, offset: int, rem=None):
        """``train_segment`` for a wave: ``state`` holds members
        [offset, offset+W) of the population that ``hp_full`` describes
        (``hp_full`` has a row for every member). Each step draws the
        shared batch and the augmentation of the WHOLE population, as
        the resident segment does, and trains the wave's rows with the
        wave's rows of hp: from the same generator state, a wave's
        members see the draws they see resident, and the generator ends
        where the resident segment leaves it. ``rem`` (int [W], optional)
        is ``train_segment_masked``'s. Returns (state, the wave's mean
        losses [steps])."""
        w = state.step.shape[0]
        hp = hp_full.rows(offset, offset + w)
        # over ``data`` this rank trains on its share of each batch
        c, d = (0, self.batch_size) if self.mesh is None else self.mesh.batch_rows(self.batch_size)
        losses = []
        for t in range(steps):
            # sweeplint: disable=event-registry -- port-only span, registered in obs/events.py::PORT_SPANS
            with trace.span("batch"):
                idx = draw_batch(generator, train_x.shape[0], self.batch_size)
                bx, by = train_x[idx[c:d]], train_y[idx[c:d]]
                aug = None
                if self.augment and bx.dim() == 4:
                    aug = draw_augment(generator, hp_full.flip_prob, hp_full.shift, self.batch_size)
                    aug = (aug[0][offset:offset + w, c:d], aug[1][offset:offset + w],
                           aug[2][offset:offset + w])
            if rem is None:
                losses.append(self._pop_update(state, hp, aug, bx, by).mean())
            else:
                active = t < rem
                loss = self._pop_update(state, hp, aug, bx, by, active=active)
                losses.append(torch.where(active, loss, 0.0).mean())
        # zero steps (an eval-only generation) is an empty curve, as the
        # JAX package's empty scan gives
        return state, torch.stack(losses) if losses else torch.zeros(0, device=train_x.device)

    def train_segment_masked(self, state: PopState, hp: OptHParams, train_x, train_y,
                             generator: torch.Generator, steps: int, rem):
        """``train_segment`` with a budget a member: member m's update
        applies only while the step index is < ``rem[m]`` (int [P] on the
        population's device), so one launch trains a mixed-budget cohort
        (an ASHA batch spanning rungs) to each member's own budget.
        ``steps`` should be ``max(rem)``. Frozen members still compute
        each step, but their update is the identity; their step count
        does not advance. A step's loss is the mean over all members with the
        frozen ones counted as 0, as in the JAX package. Under a mesh
        ``hp`` and ``rem`` cover the whole cohort. Returns (state,
        losses [steps])."""
        a, b = self._mesh_rows(hp.lr.shape[0])
        return self.train_segment_window(state, hp, train_x, train_y, generator, steps, a,
                                         rem=rem[a:b])

    @torch.no_grad()
    def eval_population(self, state: PopState, val_x, val_y, eval_chunk: int = 1024):
        """Validation accuracy per member: float32[P] (the whole
        cohort's under a mesh: each rank scores its rows, then an
        all_gather).

        The val set runs in fixed chunks of ``eval_chunk`` (members in
        ``member_chunk`` slices); the tail chunk is padded and masked,
        not dropped, so every chunk has one shape.
        """
        # sweeplint: disable=event-registry -- port-only span, registered in obs/events.py::PORT_SPANS
        with trace.span("eval"):
            return self.gather_rows(self._eval_rows(state, val_x, val_y, eval_chunk), state)

    def _eval_rows(self, state: PopState, val_x, val_y, eval_chunk: int):
        n_val = val_x.shape[0]
        n_chunks = -(-n_val // eval_chunk)
        pad = n_chunks * eval_chunk - n_val
        vx = torch.cat([val_x, val_x.new_zeros((pad,) + tuple(val_x.shape[1:]))])
        vy = torch.cat([val_y, val_y.new_full((pad,), -1)])
        n = state.step.shape[0]
        correct = torch.zeros(n, dtype=torch.int64, device=val_x.device)
        for i in range(n_chunks):
            cx, cy = vx[i * eval_chunk:(i + 1) * eval_chunk], vy[i * eval_chunk:(i + 1) * eval_chunk]
            for a, b, w in self._chunks(n):
                params = {k: _rows(v, a, b, w) for k, v in state.params.items()}
                pred = self.logits(params, self._inputs(cx, None, a, b, w)).argmax(dim=-1)
                correct[a:b] += ((pred[:b - a] == cy) & (cy >= 0)).sum(dim=1)
        return correct.float() / n_val

    @staticmethod
    @torch.no_grad()
    def member_effective_params(state: PopState, threshold: float = 1e-3) -> torch.Tensor:
        """Effective parameter count per member, float32[P]: the weights
        with ``|w| > threshold``, over every parameter tensor (the
        model-size objective of a multi-objective sweep). It moves with
        each member's weight-decay trajectory, so accuracy against
        params is a real trade-off. A member with any non-finite weight
        gets NaN, which marks it diverged in every objective consumer.
        Layout does not change a count, and ``state`` holds the real
        members only: a launch's padded stand-ins never reach it."""
        n = state.step.shape[0]
        count = torch.zeros(n, dtype=torch.float32, device=state.step.device)
        bad = torch.zeros(n, dtype=torch.bool, device=state.step.device)
        for leaf in state.params.values():
            flat = leaf.reshape(n, -1)
            count += (flat.abs() > threshold).sum(dim=1, dtype=torch.float32)
            bad |= ~torch.isfinite(flat).all(dim=1)
        return torch.where(bad, torch.nan, count)

    @staticmethod
    def member_latency_proxy(state: PopState) -> torch.Tensor:
        """Step-time latency proxy per member, float32[P], pseudo-ms:
        ``2 * MACs / 1e6`` over the weights a structured-sparse kernel
        could not skip (a coarser threshold than the params metric,
        1e-2), computed on the device with no wall-clock measurement."""
        return 2e-6 * PopulationTrainer.member_effective_params(state, threshold=1e-2)

    def member_flops(self, image_shape: tuple, eval_chunk: int = 1024) -> tuple[int, int]:
        """(FLOPs of one member's training step, of one member's eval of
        one ``eval_chunk``-image chunk) on ``image_shape`` images, counted
        by ``FlopCounterMode`` on the meta device: shapes only, nothing is
        computed or allocated. The one member runs unchunked: a member
        chunk's stand-ins do no useful work."""
        from torch.utils.flop_counter import FlopCounterMode

        one = copy.copy(self)
        one.member_chunk = 0
        one.mesh = None

        meta = torch.device("meta")

        def count(fn) -> int:
            with FlopCounterMode(display=False) as counter:
                fn()
            return counter.get_total_flops()

        params = {k: torch.zeros_like(v) for k, v in self.template.named_parameters()}
        state = PopState(params, {k: torch.zeros_like(v) for k, v in params.items()},
                         torch.zeros(1, dtype=torch.int32, device=meta))
        image, b = tuple(image_shape), self.batch_size
        bx = torch.empty((b,) + image, device=meta)
        by = torch.zeros(b, dtype=torch.long, device=meta)
        aug = None
        if self.augment and bx.dim() == 4:
            aug = (torch.zeros((1, b), dtype=torch.bool, device=meta),
                   torch.zeros(1, dtype=torch.long, device=meta),
                   torch.zeros(1, dtype=torch.long, device=meta))
        f_step = count(lambda: one._pop_update(state, OptHParams.defaults(1, device=meta), aug, bx, by))
        vx = torch.empty((eval_chunk,) + image, device=meta)
        vy = torch.zeros(eval_chunk, dtype=torch.long, device=meta)
        f_eval = count(lambda: one.eval_population(state, vx, vy, eval_chunk))
        return f_step, f_eval

    @torch.no_grad()
    def select_members(self, fresh_mask: torch.Tensor, fresh: PopState, existing: PopState) -> PopState:
        """Per-member choice between a fresh init (where ``fresh_mask``,
        bool [P] over the whole cohort, is set) and existing state."""
        if existing.cohort and fresh_mask.shape[0] != existing.step.shape[0]:
            a, b = self._mesh_rows(existing.cohort)
            fresh_mask = fresh_mask[a:b]

        def pick(a, b):
            return torch.where(fresh_mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)

        def tree(fa, fb):
            return {k: pick(fa[k], fb[k]) for k in fa}

        return PopState(tree(fresh.params, existing.params), tree(fresh.momentum, existing.momentum),
                        pick(fresh.step, existing.step), cohort=existing.cohort)

    def gather_members(self, state: PopState, src_idx: torch.Tensor) -> PopState:
        """Exploit: member i continues from member src_idx[i]'s state.
        Under a mesh ``src_idx`` is global and only the rows another
        rank owns move (``Mesh.exchange``)."""
        if self.mesh is not None and state.cohort:
            got = self.mesh.exchange(
                {"params": state.params, "momentum": state.momentum, "step": state.step},
                src_idx, state.cohort)
            return PopState(got["params"], got["momentum"], got["step"], cohort=int(src_idx.shape[0]))
        take = lambda d: {k: v.index_select(0, src_idx) for k, v in d.items()}
        return PopState(take(state.params), take(state.momentum), state.step.index_select(0, src_idx))

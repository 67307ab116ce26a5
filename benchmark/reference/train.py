"""Plain training, evaluation and PBT decision of the reference.

One member at a time, in float32 (or the control's rounding): the
shared minibatch with the member's own augmentation (flip the flagged
images along W, then roll them by the member's (dy, dx) with
wrap-around), the mean cross-entropy, and SGD with momentum and coupled
weight decay: ``m = mu*m + g + wd*p``, ``p = p - lr*m``. Evaluation is
accuracy over the whole validation set, without augmentation. The PBT
decision ranks the scores best first (ties in index order, NaN last),
lets the bottom ``n_cut`` copy a member drawn from the top ``n_cut``,
and perturbs the copied unit rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.models import forward


def augment(x: torch.Tensor, do_flip: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """NHWC images of one member: flagged images flipped along W, then
    every image rolled by (dy, dx)."""
    x = torch.where(do_flip[:, None, None, None], x.flip(2), x)
    return torch.roll(x, shifts=(dy, dx), dims=(1, 2))


def trajectory(cfg: dict, replay_steps, init: dict, hp: dict, member: int, data: dict, q,
               record_after=(1, 3), start=None) -> dict:
    """Train ``member`` (its hyperparameters in ``hp`` and its row of
    each step's augmentation) over the given steps' draws, from its rows
    of ``init`` (the population's initial parameters) with no momentum,
    or from ``start``, a ``(params, momentum)`` pair that a generation
    before left. Returns ``{k: (params, momentum)}`` after each step
    count k in ``record_after`` (float32 copies, name -> tensor)."""
    if start is None:
        p = {k: v[member].detach().clone().float() for k, v in init.items()}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
    else:
        p = {k: v.detach().clone().float() for k, v in start[0].items()}
        m = {k: v.detach().clone().float() for k, v in start[1].items()}
    lr, mu, wd = (float(hp[k][member]) for k in ("lr", "momentum", "weight_decay"))
    out = {}
    for t, (idx, aug) in enumerate(replay_steps, start=1):
        x, y = data["train_x"][idx], data["train_y"][idx].long()
        if aug is not None:
            do_flip, dy, dx = aug
            x = augment(x, do_flip[member], int(dy[member]), int(dx[member]))
        leaves = {k: v.requires_grad_() for k, v in p.items()}
        loss = F.cross_entropy(forward(cfg, leaves, x, q), y)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            for (k, v), g in zip(leaves.items(), grads):
                m[k] = mu * m[k] + g.float() + wd * v
                p[k] = (v - lr * m[k]).detach()
        if t in record_after:
            out[t] = ({k: v.clone() for k, v in p.items()}, {k: v.clone() for k, v in m.items()})
    return out


@torch.no_grad()
def accuracy(cfg: dict, params: dict, data: dict, q, chunk: int = 512) -> float:
    vx, vy = data["val_x"], data["val_y"].long()
    right = 0
    for a in range(0, vx.shape[0], chunk):
        pred = forward(cfg, params, vx[a:a + chunk], q).argmax(dim=-1)
        right += int((pred == vy[a:a + chunk]).sum())
    return right / vx.shape[0]


def exploit(unit: torch.Tensor, scores: torch.Tensor, n_cut: int, pbt: dict, draws):
    """(new unit rows, source of each member) of one PBT decision."""
    src_pick, noise, resample_u, fresh = draws
    n = unit.shape[0]
    key = torch.where(torch.isnan(scores), torch.full_like(scores, -float("inf")), scores)
    order = torch.argsort(-key, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=order.device)
    bottom = rank >= n - n_cut
    src = torch.where(bottom, order[src_pick], torch.arange(n, device=unit.device))
    copied = unit[src]
    perturbed = torch.clamp(copied + noise * pbt["perturb_scale"], 0.0, 1.0)
    # every dimension of the configurations' spaces is continuous; a
    # discrete one would resample from ``fresh`` with ``resample_u``
    del resample_u, fresh
    new = torch.where(bottom[:, None], perturbed, unit)
    return new, src

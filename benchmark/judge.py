"""The comparison that decides ``correct`` for a population trained by PBT.

What set-up's sweeps produced (``paths/<path>.py::check``: one
generation of 1, 3 and, where the eval is judged, 20 steps, and two
generations of ``two_generation_steps``) is held against the reference
(``reference/``), which makes the initial population, every draw and
every step again from the seed and the benchmark's arrays, in float32
with TF32 off:

- ``m1_gap``: after one step, each sampled member's momentum, which is
  the first gradient (plus the coupled decay) as the optimizer got it.
  Per leaf, the gap between the program's norm and the reference's,
  over the reference's norm of that leaf or of the member's median leaf,
  whichever is larger; a member reads its median leaf's gap, and the
  number is the mean over the sampled members. (The worst leaf and the
  worst member are no steady numbers: GroupNorm scales and shifts and
  conv biases, small leaves whose gradients are sums that cancel, read
  2-5% under bf16 after one step, and a member at a learning rate near
  1 takes its leaves apart within three.);
- ``m1_gn_gap``: the same over the GroupNorm scales and shifts alone (a
  member reads the median of those leaves' gaps), so that the GroupNorm
  backward kernel's own outputs are held, which are a minority of the
  small CNN's leaves and so never its median leaf;
- ``dw3_gap``: after three steps, each sampled member's change of its
  parameters, read as ``m1_gap`` reads the momentum. Leaves whose first
  gradient in the reference is under a thousandth of the median leaf's
  are left out of the change (their step is round-off);
- ``gen2_dw_gap``: after the sweep of two generations, each sampled
  member's change from its lineage's initial row: the second
  generation's training of the row that the first exploit copied into
  its source (staged in from the host, in waves), under the explored
  hyperparameters, read as ``dw3_gap``;
- ``eval_decorrelation``: after the eval sweep (20 steps), where the
  cell has one, 1 minus
  the correlation, over every member, between the journal's score of
  the member's source and the reference's accuracy of the parameters the
  member holds after the exploit (its source's). Scores near chance
  swing by tens of images under bf16 for a member whose classes nearly
  tie, so a member's own gap is no steady number; a score given to the
  wrong member breaks the correlation. After three steps the members'
  accuracies hardly differ (ResNet-18's all lie within a few images of
  chance), so the eval is judged where they do;
- ``unit_gap``: the largest gap, over the sweeps, between the program's
  unit matrix after its last exploit and the reference's decisions on
  the program's scores (in the sweep of two generations, both
  decisions, the second from the first);
- ``rows_wrong``: members, over the sweeps, whose state after the last
  exploit is not the state of the source the reference's decision gives
  them.

A sampled member that the exploit replaced is compared with its source's
trajectory. ``rounding`` puts the reference in the program's place, at
that precision: the control (``float8``) then gives readings of its own.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from benchmark.reference import train
from benchmark.reference.precision import ROUNDINGS, exact, float32_math
from benchmark.reference.replay import Replay, from_unit, n_cut

NUMBERS = ("m1_gap", "m1_gn_gap", "dw3_gap", "gen2_dw_gap", "eval_decorrelation", "unit_gap",
           "rows_wrong")


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's |norm(prog) - norm(ref)| over max(norm(ref leaf),
    norm(median ref leaf))."""
    ref_n = {k: float(v.double().norm()) for k, v in ref.items()}
    med = statistics.median(ref_n.values())
    return {k: abs(float(prog[k].double().norm()) - ref_n[k]) / max(ref_n[k], med)
            for k in ref if keep is None or k in keep}


def median_leaf(gaps: dict, gn_only: bool = False) -> float:
    """A member's number from its per-leaf gaps: the median leaf's, or
    the median of its GroupNorm scales' and shifts'."""
    return statistics.median(v for k, v in gaps.items() if not gn_only or is_gn_leaf(k))


def is_gn_leaf(name: str) -> bool:
    return name.endswith((".gamma", ".beta"))


def change_gaps(w: dict, ref_w: dict, init: dict, ref_m1: dict, wd: float) -> dict:
    """Per-leaf gaps of the change ``w - init`` against ``ref_w - init``,
    over the leaves whose first gradient in the reference (``ref_m1``,
    the momentum after one step, less the coupled decay) is at least a
    thousandth of the median leaf's."""
    g1 = {k: float((ref_m1[k] - wd * init[k]).norm()) for k in init}
    med = statistics.median(g1.values())
    keep = {k for k, v in g1.items() if v >= 1e-3 * med}
    return leaf_gaps({k: w[k] - init[k] for k in init}, {k: ref_w[k] - init[k] for k in init}, keep)


def decorrelation(a, b) -> float:
    """1 - Pearson correlation of two score vectors (two constant vectors
    read 0 when equal, 1 otherwise)."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return float("inf")
    if a.std() == 0 or b.std() == 0:
        return 0.0 if np.array_equal(a, b) else 1.0
    return float(1.0 - np.corrcoef(a, b)[0, 1])


def _to(tree: dict, device) -> dict:
    return {k: v.to(device) for k, v in tree.items()}


def judge(ctx, observed: dict, rounding: str | None = None, detail: bool = False) -> dict:
    """The numbers of NUMBERS from ``observed`` (``{k steps: what the
    sweep produced}``, and ``"gen2"``: the sweep of two generations).
    With ``rounding``, the readings of the reference at that rounding put
    in the program's place: its training numbers, and its eval of the
    program's parameters. ``detail`` adds, under ``members``, each
    sampled member's source, hyperparameters and per-leaf gaps, and
    under ``evals`` every member's two accuracies."""
    cfg, dev, sample = ctx.cfg, ctx.device, [int(i) for i in ctx.sample]
    k1, k3 = ctx.check_steps[:2]
    ke = ctx.check_steps[2] if len(ctx.check_steps) > 2 else None
    k2 = ctx.two_generation_steps
    q = exact if rounding is None else ROUNDINGS[rounding]
    scores_of = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    with float32_math():
        replay = Replay(cfg, ctx.population, ctx.seed, dev)
        wd = lambda s: float(replay.hp["weight_decay"][s])
        steps, exploit_draws = [], {}
        for t in range(1, max(ctx.check_steps) + 1):
            steps.append(replay.step_draws())
            if t in ctx.check_steps:
                exploit_draws[t] = replay.exploit_draws(replay.fork())
        cut = n_cut(ctx.population, cfg["pbt"])
        decisions = {}
        for k in ctx.check_steps:
            decisions[k] = train.exploit(replay.unit0, scores_of(observed[k]["scores"]), cut,
                                         cfg["pbt"], exploit_draws[k])
        # the sweep of two generations, drawn anew from the seed: the
        # second generation trains under the explored rows' augmentation
        two = observed["gen2"]
        replay.restart()
        steps1 = [replay.step_draws() for _ in range(k2)]
        unit1, src1 = train.exploit(replay.unit0, scores_of(two["scores_before"][0]), cut, cfg["pbt"],
                                    replay.exploit_draws())
        hp1 = from_unit(cfg["space"], unit1)
        steps2 = [replay.step_draws(hp1) for _ in range(k2)]
        decisions["gen2"] = train.exploit(unit1, scores_of(two["scores"]), cut, cfg["pbt"],
                                          replay.exploit_draws())
        src2 = decisions["gen2"][1]
        # sampled member -> (its source in the second generation, that
        # row's source in the first)
        lineage = {i: (int(src2[i]), int(src1[int(src2[i])])) for i in sample}

        def trajectories(qq):
            one = {s: train.trajectory(cfg, steps[:k3], replay.init, replay.hp, s, ctx.data, qq,
                                       record_after=(k1, k3))
                   for s in sorted({int(decisions[k][1][i]) for k in (k1, k3) for i in sample})}
            first = {r: train.trajectory(cfg, steps1, replay.init, replay.hp, r, ctx.data, qq,
                                         record_after=(1, k2))
                     for r in sorted({r for _, r in lineage.values()})}
            second = {(j, r): train.trajectory(cfg, steps2, None, hp1, j, ctx.data, qq,
                                               record_after=(k2,), start=first[r][k2])[k2]
                      for j, r in sorted(set(lineage.values()))}
            return one, first, second

        ref, ref_first, ref_second = trajectories(exact)
        ctl = None if rounding is None else trajectories(q)
        out = {}
        members, m1_all, gn_all, dw_all, dw2_all = [], [], [], [], []
        for i in sample:
            s1, s3 = int(decisions[k1][1][i]), int(decisions[k3][1][i])
            init = {k: v[s3] for k, v in replay.init.items()}
            m1 = ctl[0][s1][k1][1] if ctl else _to(observed[k1]["rows"][i][1], dev)
            m1_gaps = leaf_gaps(m1, ref[s1][k1][1])
            w3 = ctl[0][s3][k3][0] if ctl else _to(observed[k3]["rows"][i][0], dev)
            dw_gaps = change_gaps(w3, ref[s3][k3][0], init, ref[s3][k1][1], wd(s3))
            j, r = lineage[i]
            root = {k: v[r] for k, v in replay.init.items()}
            w2 = ctl[2][(j, r)][0] if ctl else _to(two["rows"][i][0], dev)
            dw2_gaps = change_gaps(w2, ref_second[(j, r)][0], root, ref_first[r][1][1], wd(r))
            m1_all.append(median_leaf(m1_gaps))
            gn_all.append(median_leaf(m1_gaps, gn_only=True))
            dw_all.append(median_leaf(dw_gaps))
            dw2_all.append(median_leaf(dw2_gaps))
            if detail:
                members.append({"member": i, "source": s3, "lineage": [j, r],
                                "hp": {k: float(v[s3]) for k, v in replay.hp.items()},
                                "m1": m1_gaps, "dw3": dw_gaps, "gen2_dw": dw2_gaps})
        out["m1_gap"], out["m1_gn_gap"] = float(np.mean(m1_all)), float(np.mean(gn_all))
        out["dw3_gap"], out["gen2_dw_gap"] = float(np.mean(dw_all)), float(np.mean(dw2_all))
        # every member's score against the reference's eval of the
        # parameters the program ended with (after the exploit a row
        # holds its source's parameters, scored under the source)
        evals = []
        if ke is not None:
            src = decisions[ke][1]
            params, scores = observed[ke]["params"], observed[ke]["scores"]
            for i in range(ctx.population):
                row = {k: v[i].to(dev) for k, v in params.items()}
                acc_ref = train.accuracy(cfg, row, ctx.data, exact)
                acc = train.accuracy(cfg, row, ctx.data, q) if ctl else float(scores[int(src[i])])
                evals.append([acc, acc_ref])
            out["eval_decorrelation"] = decorrelation(*zip(*evals))
        if ctl is None:
            unit_gap, wrong = 0.0, 0
            for k, (new_unit, src) in decisions.items():
                unit_gap = max(unit_gap, float(np.abs(observed[k]["unit"] - new_unit.cpu().numpy()).max()))
                dg = observed[k]["digest"]
                wrong += int((dg != dg[src.cpu().numpy()]).sum())
            out["unit_gap"], out["rows_wrong"] = unit_gap, wrong
        if detail:
            out["members"], out["evals"] = members, evals
    return out

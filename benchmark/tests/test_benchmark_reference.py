"""The reference against the port at tiny sizes on the CPU, and the check
that decides ``correct`` against its control and planted faults.

The port computes in bf16; here it is also built in float32, where the
two must agree to rounding. The draws the reference makes again from a
seed must be the port's, bit for bit."""

from __future__ import annotations

import copy
import json
import os
import shutil
import tempfile

import pytest
import torch
from torch.func import functional_call

from benchmark import calibrate
from benchmark import run as harness
from benchmark.data import make_images
from benchmark.judge import judge
from benchmark.reference import models, train
from benchmark.reference.precision import exact
from benchmark.reference.replay import Replay

ROOT = harness.ROOT


def _config(name: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prior = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(prior)


def tiny_cnn() -> dict:
    cfg = _config("cifar10_cnn")
    cfg.update(batch_size=8, n_train=64, n_val=32, population=4)
    return cfg


def test_draws_are_the_ports():
    from mpi_opt_tpu_torch.models import SmallCNN
    from mpi_opt_tpu_torch.ops.pbt import PBTConfig, draw_exploit_explore
    from mpi_opt_tpu_torch.train.population import draw_augment, draw_batch
    from mpi_opt_tpu_torch.workloads import get_workload

    cfg, p, seed = tiny_cnn(), 4, 2**31 + 17
    wl = get_workload("cifar10_cnn")
    space = wl.default_space()
    g = torch.Generator()
    g.manual_seed(seed)
    unit = space.sample_unit(g, p)
    model = SmallCNN(n_classes=10, width=32, population=p, device="cpu")
    model.init_params(g)
    hp = wl.make_hparams(space.from_unit(unit))
    idx = draw_batch(g, cfg["n_train"], cfg["batch_size"])
    aug = draw_augment(g, hp.flip_prob, hp.shift, cfg["batch_size"])
    ex = draw_exploit_explore(g, p, unit.shape[1], PBTConfig(**cfg["pbt"]))

    r = Replay(cfg, p, seed, "cpu")
    assert torch.equal(r.unit0, unit)
    for name, t in model.named_parameters():
        assert torch.equal(r.init[name], t.detach()), name
    for k in ("lr", "momentum", "weight_decay", "flip_prob", "shift"):
        assert torch.equal(r.hp[k], getattr(hp, k)), k
    ridx, raug = r.step_draws()
    assert torch.equal(ridx, idx) and all(torch.equal(a, b) for a, b in zip(raug, aug))
    assert all(torch.equal(a, b) for a, b in zip(r.exploit_draws(), ex))


def _port_logits(cfg, params, x, p):
    from mpi_opt_tpu_torch.models import ResNet, SmallCNN
    from mpi_opt_tpu_torch.models.resnet import fold_members

    if cfg["model"] == "smallcnn":
        model = SmallCNN(n_classes=cfg["n_classes"], width=cfg["width"], dtype=torch.float32,
                         population=p, device="meta")
    else:
        model = ResNet(n_classes=cfg["n_classes"], stage_sizes=cfg["stage_sizes"],
                       width=cfg["width"], dtype=torch.float32, population=p, device="meta")
    xp = x[:, :, :, None, :].expand(-1, -1, -1, p, -1).contiguous()
    return functional_call(model, params, (fold_members(xp),))


@pytest.mark.parametrize("model", ["smallcnn", "resnet18"])
def test_forward_agrees_with_the_port_in_float32(model):
    if model == "smallcnn":
        cfg = tiny_cnn()
    else:
        cfg = _config("cifar100_resnet18")
        cfg.update(width=8, stage_sizes=[1, 1], batch_size=4, n_train=16, n_val=8, n_classes=10)
    p = 2
    r = Replay(cfg, p, 5, "cpu")
    # non-trivial GroupNorm parameters
    g = torch.Generator().manual_seed(1)
    params = {k: v + 0.1 * torch.randn(v.shape, generator=g) for k, v in r.init.items()}
    x = torch.randn((4, cfg["image_size"], cfg["image_size"], 3), generator=g)
    port = _port_logits(cfg, params, x, p)
    for m in range(p):
        ref = models.forward(cfg, {k: v[m] for k, v in params.items()}, x, exact)
        torch.testing.assert_close(port[m], ref, rtol=1e-4, atol=1e-4)


def test_a_training_step_agrees_with_the_port_in_float32():
    from mpi_opt_tpu_torch.models import SmallCNN
    from mpi_opt_tpu_torch.train.population import OptHParams, PopState, PopulationTrainer

    cfg, p = tiny_cnn(), 4
    data = make_images(cfg, 9, "cpu")
    r = Replay(cfg, p, 11, "cpu")
    trainer = PopulationTrainer(
        lambda n, dev: SmallCNN(n_classes=10, width=32, dtype=torch.float32, population=n, device=dev),
        batch_size=cfg["batch_size"], device="cpu")
    params = {k: v.clone() for k, v in r.init.items()}
    state = PopState(params, {k: torch.zeros_like(v) for k, v in params.items()},
                     torch.zeros(p, dtype=torch.int32))
    hp = OptHParams(*(r.hp[k] for k in ("lr", "momentum", "weight_decay", "flip_prob", "shift")))
    steps = [r.step_draws() for _ in range(2)]
    for idx, aug in steps:
        trainer._pop_update(state, hp, aug, data["train_x"][idx], data["train_y"][idx].long())
    for m in range(p):
        ref = train.trajectory(cfg, steps, r.init, r.hp, m, data, exact, record_after=(2,))[2]
        for k in params:
            torch.testing.assert_close(state.params[k][m], ref[0][k], rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(state.momentum[k][m], ref[1][k], rtol=1e-4, atol=1e-5)


def _tiny_run(cell_name: str, seed: int):
    # minibatches of 32: at 8 images the gradient's bf16 error is large
    # against the step, and sound readings reach the cells' limits
    cfg = tiny_cnn()
    cfg.update(batch_size=32, n_train=256, n_val=128)
    with open(os.path.join(ROOT, "benchmark", "cells", cell_name + ".json")) as f:
        cell = json.load(f)
    cell = copy.deepcopy(cell)
    cell.update(member_chunk=2, steps_per_gen=2, check_members=3, check_steps=[1, 3, 6])
    if cell.get("wave_size"):
        cell["wave_size"] = 2
    r = harness.Run(cell_name, seed, 1, False, cfg, cell, torch.device("cpu"), tempfile.mkdtemp())
    r.data = make_images(cfg, seed, r.device)
    path = harness.load_module(os.path.join(harness.HERE, "paths", cell["path"] + ".py"))
    return r, path


def _correct(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= v for k, v in limits.items())


@pytest.mark.parametrize("cell", ["cnn_pbt_resident", "cnn_pbt_waves"])
def test_sound_runs_pass_and_the_control_and_each_fault_fail(cell):
    """At a tiny size on the CPU, with the cell's limits: the program's
    set-up sweeps are correct, the float8 control is not, and each
    fault planted under the sweeps makes ``correct`` false."""
    r, path = _tiny_run(cell, 2**31 + 5)
    limits = r.cell["limits"]
    observed = path.check(r, path.prepare(r))
    assert _correct(judge(r, observed), limits)
    control = judge(r, observed, rounding="float8")
    assert not _correct(control, {k: v for k, v in limits.items() if k in control})
    for fault in calibrate.FAULTS:
        with calibrate.fault(fault):
            numbers = judge(r, path.check(r, path.prepare(r)))
        assert not _correct(numbers, limits), (fault, numbers)
    shutil.rmtree(r.tmp)

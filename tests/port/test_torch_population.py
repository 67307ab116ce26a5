"""The port's population trainer against the JAX package's.

The JAX side draws (augmentation keys, batch) and the port's apply
functions take those draws, so one step compares like with like. Tiny
f32 ResNet (width 8, stages (1, 1), 8x8 images) with the Pallas GN in
interpret mode. Tolerances: params atol 1e-5 and momentum atol 1e-3
after one step (momentum holds the raw gradient, which carries the GN
gradient bound of 1e-3; params move by lr times it), losses atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_opt_tpu.ops.pallas_gn as pg
from mpi_opt_tpu.models.resnet import ResNet as FlaxResNet
from mpi_opt_tpu.train.population import OptHParams as JaxOptHParams
from mpi_opt_tpu.train.population import PopState as JaxPopState
from mpi_opt_tpu.train.population import PopulationTrainer as JaxTrainer
from mpi_opt_tpu.train.population import _augment as jax_augment
from mpi_opt_tpu_torch.models.convert import flax_to_torch
from mpi_opt_tpu_torch.models.resnet import ResNet
from mpi_opt_tpu_torch.train.population import (
    OptHParams,
    PopState,
    PopulationTrainer,
    apply_augment,
    draw_augment,
)

KW = dict(n_classes=10, stage_sizes=(1, 1), width=8)
P, B = 2, 4
HP = dict(lr=[0.1, 0.05], momentum=[0.9, 0.5], weight_decay=[1e-4, 1e-3],
          flip_prob=[0.5, 0.3], shift=[2.0, 3.0])


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pg, "_INTERPRET", True)


def _jax_aug_draws(key, flip_prob, shift, b):
    """The draws of mpi_opt_tpu/train/population.py::_augment, one member."""
    k_flip, k_dy, k_dx = jax.random.split(key, 3)
    do_flip = jax.random.bernoulli(k_flip, flip_prob, (b, 1, 1, 1)).reshape(b)
    max_s = jnp.maximum(shift, 0.0)
    dy = jnp.round(jax.random.uniform(k_dy, (), minval=-max_s, maxval=max_s)).astype(jnp.int32)
    dx = jnp.round(jax.random.uniform(k_dx, (), minval=-max_s, maxval=max_s)).astype(jnp.int32)
    return np.asarray(do_flip), int(dy), int(dx)


def _port_aug(keys, hp, b):
    draws = [_jax_aug_draws(k, hp["flip_prob"][m], hp["shift"][m], b) for m, k in enumerate(keys)]
    return (
        torch.tensor(np.stack([d[0] for d in draws])),
        torch.tensor([d[1] for d in draws]),
        torch.tensor([d[2] for d in draws]),
    )


def _port_trainer(member_chunk=0, batch_size=B):
    return PopulationTrainer(
        lambda p, dev: ResNet(**KW, dtype=torch.float32, population=p, device=dev),
        batch_size=batch_size, member_chunk=member_chunk, device="cpu",
    )


def test_augment_equals_jax_given_its_draws():
    x = np.random.default_rng(0).standard_normal((6, 8, 8, 3)).astype(np.float32)
    hp = dict(flip_prob=[0.5, 0.9, 0.0], shift=[4.0, 2.0, -1.0])
    keys = jax.random.split(jax.random.key(3), 3)
    got = apply_augment(torch.from_numpy(x), *_port_aug(keys, hp, 6))  # [B, H, W, P, C]
    for m in range(3):
        want = jax_augment(keys[m], jnp.asarray(x), hp["flip_prob"][m], hp["shift"][m])
        np.testing.assert_array_equal(got[:, :, :, m].numpy(), np.asarray(want))


def test_draw_augment_shapes_and_ranges():
    g = torch.Generator().manual_seed(0)
    do_flip, dy, dx = draw_augment(g, torch.tensor([0.0, 1.0]), torch.tensor([2.0, -1.0]), 64)
    assert do_flip.shape == (2, 64) and not bool(do_flip[0].any()) and bool(do_flip[1].all())
    assert abs(int(dy[0])) <= 2 and int(dy[1]) == 0 and int(dx[1]) == 0


def pop_update_case():
    """One population step of the JAX trainer (Pallas GN in interpret
    mode: call under ``interpret_mode``) on seeded inputs: the port's
    inputs (its layout, JAX's augmentation draws) and JAX's result
    (params and momentum in the port's layout, the losses)."""
    model = FlaxResNet(**KW, dtype=jnp.float32, pallas_gn=True)
    jt = JaxTrainer(
        apply_fn=lambda p, x: model.apply({"params": p}, x),
        init_fn=lambda r, x: model.init(r, x)["params"],
        batch_size=B,
    )
    st = jt.init_population(jax.random.key(0), jnp.zeros((1, 8, 8, 3)), P)
    rng = np.random.default_rng(1)
    mom = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.01, st.params)
    st = JaxPopState(params=st.params, momentum=jax.tree.map(jnp.asarray, mom), step=st.step)
    hp = {k: np.asarray(v, np.float32) for k, v in HP.items()}
    bx = rng.standard_normal((B, 8, 8, 3)).astype(np.float32)
    by = rng.integers(0, 10, B).astype(np.int32)
    keys = jax.random.split(jax.random.key(2), P)
    want, want_loss = jax.jit(jt._pop_update)(
        st, JaxOptHParams(**{k: jnp.asarray(v) for k, v in hp.items()}), keys, jnp.asarray(bx), jnp.asarray(by)
    )
    port = {
        "params": flax_to_torch(jax.tree.map(np.asarray, st.params), stacked=True),
        "momentum": flax_to_torch(mom, stacked=True),
        "hp": {k: torch.from_numpy(v) for k, v in hp.items()},
        "aug": _port_aug(keys, hp, B),
        "bx": torch.from_numpy(bx),
        "by": torch.from_numpy(by).long(),
    }
    return port, {
        "params": flax_to_torch(jax.tree.map(np.asarray, want.params), stacked=True),
        "momentum": flax_to_torch(jax.tree.map(np.asarray, want.momentum), stacked=True),
        "loss": np.asarray(want_loss),
    }


#: ``pop_update_case``'s tolerances: params, momentum, losses
PARAMS_ATOL, MOMENTUM_ATOL, LOSS_ATOL = 1e-5, 1e-3, 1e-5


def test_one_pop_update_matches_jax():
    port, want = pop_update_case()
    port_state = PopState(port["params"], port["momentum"], torch.zeros(P, dtype=torch.int32))
    loss = _port_trainer()._pop_update(
        port_state, OptHParams(**port["hp"]), port["aug"], port["bx"], port["by"],
    )
    np.testing.assert_allclose(loss.numpy(), want["loss"], atol=LOSS_ATOL)
    assert port_state.step.tolist() == [1] * P
    for name, atol in (("params", PARAMS_ATOL), ("momentum", MOMENTUM_ATOL)):
        ref, got = want[name], getattr(port_state, name)
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=atol, err_msg=f"{name} {k}")


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, 8, 8, 3)).astype(np.float32))
    return x, torch.from_numpy(rng.integers(0, 10, n)).long()


def test_member_chunk_equals_full_population():
    x, y = _data()
    full, chunked = _port_trainer(batch_size=8), _port_trainer(member_chunk=2, batch_size=8)
    hp = OptHParams.defaults(4, lr=0.05)
    states = []
    for tr in (full, chunked):
        st = tr.init_population(torch.Generator().manual_seed(0), 4)
        tr.train_segment(st, hp, x, y, torch.Generator().manual_seed(1), 3)
        states.append(st)
    for k in states[0].params:
        torch.testing.assert_close(states[1].params[k], states[0].params[k], rtol=1e-5, atol=1e-6)
    acc = [tr.eval_population(st, x, y) for tr, st in zip((full, chunked), states)]
    assert torch.equal(acc[0], acc[1])


def test_eval_population_masks_the_tail_chunk():
    x, y = _data(n=50, seed=2)
    tr = _port_trainer()
    st = tr.init_population(torch.Generator().manual_seed(3), 3)
    whole = tr.eval_population(st, x, y, eval_chunk=64)
    tailed = tr.eval_population(st, x, y, eval_chunk=16)  # 4 chunks, last one 2 real rows
    assert torch.equal(whole, tailed)
    with torch.no_grad():
        x_fold = x[:, :, :, None, :].expand(-1, -1, -1, 3, -1).reshape(50, 8, 8, 9).permute(0, 3, 1, 2)
        pred = tr.logits(st.params, x_fold).argmax(-1)
    torch.testing.assert_close(whole, (pred == y).float().mean(dim=1), rtol=0, atol=0)


def test_gather_members_copies_state():
    tr = _port_trainer()
    st = tr.init_population(torch.Generator().manual_seed(5), 4)
    g = tr.gather_members(st, torch.tensor([3, 3, 2, 3]))
    k = "stem.weight"
    assert torch.equal(g.params[k][0], st.params[k][3])
    assert torch.equal(g.params[k][2], st.params[k][2])
    assert torch.equal(g.momentum[k][1], st.momentum[k][3])


def test_init_distribution_matches_flax_lecun_normal():
    """Same distribution as flax's initialisers (the bits cannot match):
    conv std 1/sqrt(fan_in), truncated at 2 of its pre-scale sigmas;
    GN ones/zeros; zero head bias."""
    st = _port_trainer().init_population(torch.Generator().manual_seed(0), 64)
    w = st.params["stage1_block0.conv2.weight"]  # fan_in 16 * 9
    std = 1.0 / np.sqrt(16 * 9)
    assert abs(float(w.std()) - std) < 0.05 * std
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert torch.equal(st.params["gn_stem.gamma"], torch.ones(64, 8))
    assert torch.equal(st.params["head.bias"], torch.zeros(64, 10))

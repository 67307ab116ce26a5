"""The port's population SmallCNN against flax's, with weights carried across.

Small on the JAX side: width 16, batch 2, 16x16 images. Tolerances: f32
logits atol 1e-4, f32 gradients atol 1e-3 (the GN kernel's gradient
bound); bf16 logits within 5e-2 of their scale, where oneDNN and XLA
round bf16 convs differently, and flax normalises as
``(x - mean) * (rstd * scale) + bias`` where the kernel computes
``((x - mean) * rstd) * gamma + beta``. The max-pool's gradient goes to
one element a window, the first maximum in row-major order, as XLA's
select-and-scatter sends it; the tests plant ties to check it.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.func import functional_call

from mpi_opt_tpu.models.cnn import SmallCNN as FlaxSmallCNN
from mpi_opt_tpu.train.population import OptHParams as JaxOptHParams
from mpi_opt_tpu.train.population import PopState as JaxPopState
from mpi_opt_tpu.train.population import PopulationTrainer as JaxTrainer
from mpi_opt_tpu.workloads.base import resolve_momentum_dtype as jax_resolve_momentum_dtype
from mpi_opt_tpu_torch.models import SmallCNN
from mpi_opt_tpu_torch.models.convert import flax_to_torch
from mpi_opt_tpu_torch.models.resnet import flatten_members, fold_members
from mpi_opt_tpu_torch.train.population import OptHParams, PopState, PopulationTrainer
from mpi_opt_tpu_torch.workloads import base as wl_base
from mpi_opt_tpu_torch.workloads import get_workload

W, HW, B = 16, 16, 2


def _images(n_members, b=B, seed=0, ties=True):
    x = np.random.default_rng(seed).standard_normal((n_members, b, HW, HW, 3)).astype(np.float32)
    if ties:
        # constant 4x4 patches: equal conv outputs inside them, so the
        # pools' windows there hold ties in every implementation
        x[:, :, 4:8, 4:8, :] = 0.5
        x[:, :, 8:12, 0:4, :] = -1.0
    return x


def _flax(dtype, n_members):
    model = FlaxSmallCNN(n_classes=10, width=W, dtype=dtype)
    x0 = jnp.zeros((1, HW, HW, 3))
    trees = [jax.tree.map(np.asarray, model.init(jax.random.key(m), x0)["params"]) for m in range(n_members)]
    return model, trees


def _stack(trees):
    conv = [flax_to_torch(t) for t in trees]
    return {k: torch.cat([c[k] for c in conv]) for k in conv[0]}


def _port_logits(trees, images, dtype, requires_grad=False):
    params = _stack(trees)
    if requires_grad:
        params = {k: v.requires_grad_() for k, v in params.items()}
    model = SmallCNN(n_classes=10, width=W, dtype=dtype, population=len(trees), image_size=HW, device="meta")
    x = fold_members(torch.from_numpy(np.ascontiguousarray(images.transpose(1, 2, 3, 0, 4))))
    return functional_call(model, params, (x,)), params


def test_logits_and_grads_match_flax_f32():
    model, (tree,) = _flax(jnp.float32, 1)
    images = _images(1)
    cot = np.random.default_rng(1).standard_normal((B, 10)).astype(np.float32)
    want = model.apply({"params": tree}, images[0])
    want_g = jax.grad(lambda p: jnp.sum(model.apply({"params": p}, images[0]) * cot))(tree)
    logits, params = _port_logits([tree], images, torch.float32, requires_grad=True)
    np.testing.assert_allclose(logits[0].detach().numpy(), np.asarray(want), atol=1e-4)
    (logits[0] * torch.from_numpy(cot)).sum().backward()
    want_g = flax_to_torch(jax.tree.map(np.asarray, want_g))
    assert want_g.keys() == params.keys()
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), atol=1e-3, err_msg=k)


def test_two_members_folded_match_single_member_runs():
    model, trees = _flax(jnp.float32, 2)
    images = _images(2, seed=4)
    logits, _ = _port_logits(trees, images, torch.float32)
    for m in range(2):
        want = model.apply({"params": trees[m]}, images[m])
        np.testing.assert_allclose(logits[m].detach().numpy(), np.asarray(want), atol=1e-4)


def test_bf16_logits_match_flax_loosely():
    model, (tree,) = _flax(jnp.bfloat16, 1)
    images = _images(1, seed=5)
    want = np.asarray(model.apply({"params": tree}, images[0]))
    logits, _ = _port_logits([tree], images, torch.bfloat16)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits[0].numpy(), want, atol=5e-2 * max(1.0, np.abs(want).max()))


def test_param_names_and_count_match_flax_at_full_width():
    shapes = jax.eval_shape(
        lambda: FlaxSmallCNN(n_classes=10).init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    )
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    port = dict(SmallCNN(n_classes=10, population=1, device="meta").named_parameters())
    conv = flax_to_torch(tree)
    assert conv.keys() == port.keys()
    for k, v in conv.items():
        assert v.shape == port[k].shape, k
    assert sum(v[0].numel() for v in conv.values()) == 591_658


def test_flatten_is_flax_nhwc_order_so_fc1_needs_no_permutation():
    acts = np.random.default_rng(6).standard_normal((3, 2, 4, 4, 5)).astype(np.float32)  # [P,B,H,W,C]
    folded = fold_members(torch.from_numpy(np.ascontiguousarray(acts.transpose(1, 2, 3, 0, 4))))
    flat = flatten_members(folded, 3)
    for m in range(3):
        np.testing.assert_array_equal(flat[m].numpy(), acts[m].reshape(2, -1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_max_pool_ties_route_as_jax(dtype):
    # [B, H, W, C] windows: all four equal, two equal maxima off the
    # first position ([[0, 2], [2, 1]]), and distinct values
    x = np.random.default_rng(7).integers(-3, 4, (2, 8, 8, 6)).astype(np.float32)
    x[:, 0:2, 0:2, :] = 1.0
    x[:, 2:4, 2:4, :] = np.array([[0.0, 2.0], [2.0, 1.0]])[None, :, :, None]
    cot = np.random.default_rng(8).standard_normal((2, 4, 4, 6)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax.grad(lambda a: jnp.sum(nn.max_pool(a, (2, 2), strides=(2, 2)).astype(jnp.float32) * cot))(
        jnp.asarray(x, jdt))
    xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2).requires_grad_()  # channels_last
    y = F.max_pool2d(xt, 2, 2)
    (y.float() * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    got = xt.grad.permute(0, 2, 3, 1).float().numpy()
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    assert got[0, 0, 0, 0] != 0 and not got[0, 0:2, 0:2, 0].ravel()[1:].any()  # the first of four ties
    assert got[0, 2, 3, 0] != 0 and got[0, 3, 2, 0] == 0  # the first of [[0, 2], [2, 1]]


# -- the trainer on SmallCNN: momentum storage dtype ----------------------

HP = dict(lr=[0.1, 0.05], momentum=[0.9, 0.5], weight_decay=[1e-4, 1e-3],
          flip_prob=[0.5, 0.3], shift=[2.0, 3.0])


def _jax_aug_draws(key, flip_prob, shift, b):
    """The draws of mpi_opt_tpu/train/population.py::_augment, one member."""
    k_flip, k_dy, k_dx = jax.random.split(key, 3)
    do_flip = jax.random.bernoulli(k_flip, flip_prob, (b, 1, 1, 1)).reshape(b)
    max_s = jnp.maximum(shift, 0.0)
    dy = jnp.round(jax.random.uniform(k_dy, (), minval=-max_s, maxval=max_s)).astype(jnp.int32)
    dx = jnp.round(jax.random.uniform(k_dx, (), minval=-max_s, maxval=max_s)).astype(jnp.int32)
    return np.asarray(do_flip), int(dy), int(dx)


def test_one_pop_update_with_bf16_momentum_matches_jax():
    """One step with momentum stored in bf16: the update runs in f32 and
    only the stored momentum is cast. Params atol 1e-5; the stored
    momentum atol 1e-3 (the gradient bound) plus one bf16 step (2^-8
    relative), since the two f32 values may round to neighbours."""
    p_count, b = 2, 4
    model = FlaxSmallCNN(n_classes=10, width=W, dtype=jnp.float32)
    jt = JaxTrainer(
        apply_fn=lambda p, x: model.apply({"params": p}, x),
        init_fn=lambda r, x: model.init(r, x)["params"],
        batch_size=b, momentum_dtype=jnp.bfloat16,
    )
    st = jt.init_population(jax.random.key(0), jnp.zeros((1, HW, HW, 3)), p_count)
    assert all(m.dtype == jnp.bfloat16 for m in jax.tree.leaves(st.momentum))
    rng = np.random.default_rng(1)
    mom = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape) * 0.01, jnp.bfloat16), st.params)
    st = JaxPopState(params=st.params, momentum=mom, step=st.step)
    hp = {k: np.asarray(v, np.float32) for k, v in HP.items()}
    bx = rng.standard_normal((b, HW, HW, 3)).astype(np.float32)
    by = rng.integers(0, 10, b).astype(np.int32)
    keys = jax.random.split(jax.random.key(2), p_count)
    want, want_loss = jax.jit(jt._pop_update)(
        st, JaxOptHParams(**{k: jnp.asarray(v) for k, v in hp.items()}), keys, jnp.asarray(bx), jnp.asarray(by)
    )

    to_port = lambda tree: flax_to_torch(jax.tree.map(lambda a: np.asarray(a, np.float32), tree), stacked=True)
    port_state = PopState(to_port(st.params), {k: v.bfloat16() for k, v in to_port(mom).items()},
                          torch.zeros(p_count, dtype=torch.int32))
    draws = [_jax_aug_draws(k, hp["flip_prob"][m], hp["shift"][m], b) for m, k in enumerate(keys)]
    aug = (torch.tensor(np.stack([d[0] for d in draws])), torch.tensor([d[1] for d in draws]),
           torch.tensor([d[2] for d in draws]))
    trainer = PopulationTrainer(
        lambda p, dev: SmallCNN(n_classes=10, width=W, dtype=torch.float32, population=p,
                                image_size=HW, device=dev),
        batch_size=b, device="cpu", momentum_dtype=torch.bfloat16,
    )
    loss = trainer._pop_update(port_state, OptHParams(**{k: torch.from_numpy(v) for k, v in hp.items()}),
                               aug, torch.from_numpy(bx), torch.from_numpy(by).long())
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), atol=1e-5)
    ref_p, ref_m = to_port(want.params), to_port(want.momentum)
    for k in ref_p:
        assert port_state.momentum[k].dtype == torch.bfloat16, k
        np.testing.assert_allclose(port_state.params[k].numpy(), ref_p[k].numpy(), atol=1e-5, err_msg=k)
        np.testing.assert_allclose(port_state.momentum[k].float().numpy(), ref_m[k].numpy(),
                                   atol=1e-3, rtol=2**-8, err_msg=k)


@pytest.mark.parametrize("spelling", sorted(wl_base._DTYPE_NAMES))
def test_momentum_dtype_spellings_match_jax(monkeypatch, spelling):
    monkeypatch.setenv("MPI_OPT_TPU_MOMENTUM_DTYPE", spelling)
    assert wl_base.resolve_momentum_dtype() == jax_resolve_momentum_dtype()


def test_momentum_dtype_env_reaches_the_trainer(monkeypatch):
    wl = get_workload("cifar10_cnn", n_train=64, n_val=16)
    monkeypatch.delenv("MPI_OPT_TPU_MOMENTUM_DTYPE", raising=False)
    assert wl_base.resolve_momentum_dtype() is None
    st = wl.make_trainer(device="cpu").init_population(torch.Generator().manual_seed(0), 2)
    assert {v.dtype for v in st.momentum.values()} == {torch.float32}
    monkeypatch.setenv("MPI_OPT_TPU_MOMENTUM_DTYPE", "bfloat16")
    st = wl.make_trainer(device="cpu").init_population(torch.Generator().manual_seed(0), 2)
    assert {v.dtype for v in st.momentum.values()} == {torch.bfloat16}
    assert {v.dtype for v in st.params.values()} == {torch.float32}
    monkeypatch.setenv("MPI_OPT_TPU_MOMENTUM_DTYPE", "fp8")
    with pytest.raises(ValueError, match="MPI_OPT_TPU_MOMENTUM_DTYPE='fp8'"):
        wl.make_trainer(device="cpu")

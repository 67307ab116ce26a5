"""The port's population MLP against flax's, with weights carried across.

Small on the JAX side: hidden 16, batch 2, 28x28x1 images. Tolerances as
for the other models: f32 logits atol 1e-4 and gradients atol 1e-3;
bf16 logits within 5e-2 of their scale (bf16 matmuls round differently
in oneDNN and XLA).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.func import functional_call

from mpi_opt_tpu.models.mlp import MLP as FlaxMLP
from mpi_opt_tpu_torch.models import MLP
from mpi_opt_tpu_torch.models.convert import flax_to_torch
from mpi_opt_tpu_torch.models.resnet import fold_members

HIDDEN, B = 16, 2


def _images(n_members, seed=0):
    return np.random.default_rng(seed).standard_normal((n_members, B, 28, 28, 1)).astype(np.float32)


def _flax(dtype, n_members, hidden=HIDDEN):
    model = FlaxMLP(hidden=hidden, n_classes=10, dtype=dtype)
    trees = [jax.tree.map(np.asarray, model.init(jax.random.key(m), jnp.zeros((1, 28, 28, 1)))["params"])
             for m in range(n_members)]
    return model, trees


def _port_logits(trees, images, dtype, requires_grad=False):
    conv = [flax_to_torch(t) for t in trees]
    params = {k: torch.cat([c[k] for c in conv]) for k in conv[0]}
    if requires_grad:
        params = {k: v.requires_grad_() for k, v in params.items()}
    model = MLP(784, hidden=HIDDEN, n_classes=10, dtype=dtype, population=len(trees), device="meta")
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
    assert want_g.keys() == params.keys() == {"fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"}
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), atol=1e-3, err_msg=k)


def test_two_members_folded_match_single_member_runs():
    model, trees = _flax(jnp.float32, 2)
    images = _images(2, seed=2)
    logits, _ = _port_logits(trees, images, torch.float32)
    for m in range(2):
        want = model.apply({"params": trees[m]}, images[m])
        np.testing.assert_allclose(logits[m].detach().numpy(), np.asarray(want), atol=1e-4)


def test_bf16_logits_match_flax_loosely():
    model, (tree,) = _flax(jnp.bfloat16, 1)
    images = _images(1, seed=3)
    want = np.asarray(model.apply({"params": tree}, images[0]))
    logits, _ = _port_logits([tree], images, torch.bfloat16)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits[0].numpy(), want, atol=5e-2 * max(1.0, np.abs(want).max()))


def test_param_count_matches_flax_at_full_width():
    shapes = jax.eval_shape(lambda: FlaxMLP().init(jax.random.key(0), jnp.zeros((1, 28, 28, 1)))["params"])
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    port = dict(MLP(784, population=1, device="meta").named_parameters())
    conv = flax_to_torch(tree)
    assert {k: v.shape for k, v in conv.items()} == {k: v.shape for k, v in port.items()}
    assert sum(v[0].numel() for v in conv.values()) == 101_770


def test_init_matches_flax_distribution():
    """flax's initialisers (the bits cannot match): lecun_normal kernels,
    zero biases."""
    model = MLP(784, hidden=128, population=8, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    w = model.fc1.weight.detach()
    std = 1.0 / np.sqrt(784)
    assert abs(float(w.std()) - std) < 0.05 * std
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert torch.equal(model.fc2.bias.detach(), torch.zeros(8, 10))

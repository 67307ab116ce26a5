"""The port's population ResNet against flax's, with weights carried across.

Tiny on the JAX side (width 8, stage_sizes (1, 1), 8x8 images) so the
Pallas interpret-mode compiles stay small. Stage 1's first block has a
stride-2 3x3 conv, where flax's SAME padding is (0, 1) and torch's
padding=1 would be (1, 1). Tolerances: f32 logits atol 1e-4, f32
gradients atol 1e-3 (the GN kernel's gradient bound); bf16 logits
within 5e-2, where cuDNN/oneDNN and XLA round bf16 convs differently.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

import mpi_opt_tpu.ops.pallas_gn as pg
from mpi_opt_tpu.models.resnet import ResNet as FlaxResNet
from mpi_opt_tpu_torch.models.convert import flax_to_torch
from mpi_opt_tpu_torch.models.resnet import Conv, ResNet, fold_members, same_padding

KW = dict(n_classes=10, stage_sizes=(1, 1), width=8)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pg, "_INTERPRET", True)


def _images(n_members, b=2, hw=8, seed=0):
    return np.random.default_rng(seed).standard_normal((n_members, b, hw, hw, 3)).astype(np.float32)


def _flax_params(dtype, n_members):
    model = FlaxResNet(**KW, dtype=dtype, pallas_gn=True)
    x0 = jnp.zeros((1, 8, 8, 3))
    trees = [model.init(jax.random.key(m), x0)["params"] for m in range(n_members)]
    return model, trees


def _port_logits(trees, images, dtype, requires_grad=False):
    params = {k: torch.stack([flax_to_torch(jax.tree.map(np.asarray, t))[k][0] for t in trees])
              for k in flax_to_torch(jax.tree.map(np.asarray, trees[0]))}
    if requires_grad:
        params = {k: v.requires_grad_() for k, v in params.items()}
    model = ResNet(**KW, dtype=dtype, population=len(trees), device="meta")
    x = fold_members(torch.from_numpy(np.ascontiguousarray(images.transpose(1, 2, 3, 0, 4))))
    return functional_call(model, params, (x,)), params


def test_same_padding_matches_flax():
    assert same_padding(32, 3, 2) == (0, 1)
    assert same_padding(32, 3, 1) == (1, 1)
    assert same_padding(32, 1, 2) == (0, 0)
    assert same_padding(8, 3, 2) == (0, 1)


def test_stride2_conv_matches_flax_same_padding():
    x = np.random.default_rng(3).standard_normal((2, 32, 32, 4)).astype(np.float32)
    conv = nn.Conv(6, (3, 3), strides=(2, 2), padding="SAME", use_bias=False)
    p = conv.init(jax.random.key(0), x)["params"]
    want = np.asarray(conv.apply({"params": p}, x))
    port = Conv(4, 6, 3, stride=2, dtype=torch.float32, device="meta")
    w = torch.from_numpy(np.asarray(p["kernel"]).transpose(3, 2, 0, 1)[None].copy())
    got = functional_call(port, {"weight": w}, (torch.from_numpy(x).permute(0, 3, 1, 2),))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)


def test_logits_and_grads_match_flax_f32():
    model, (tree,) = _flax_params(jnp.float32, 1)
    images = _images(1)
    cot = np.random.default_rng(1).standard_normal((2, 10)).astype(np.float32)
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
    model, trees = _flax_params(jnp.float32, 2)
    images = _images(2, seed=4)
    logits, _ = _port_logits(trees, images, torch.float32)
    for m in range(2):
        want = model.apply({"params": trees[m]}, images[m])
        np.testing.assert_allclose(logits[m].detach().numpy(), np.asarray(want), atol=1e-4)


def test_bf16_logits_match_flax_loosely():
    model, (tree,) = _flax_params(jnp.bfloat16, 1)
    images = _images(1, seed=5)
    want = np.asarray(model.apply({"params": tree}, images[0]))
    logits, _ = _port_logits([tree], images, torch.bfloat16)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits[0].numpy(), want, atol=5e-2 * max(1.0, np.abs(want).max()))


def test_param_names_and_count_match_flax_at_full_width():
    """Full width: ~11.2M parameters a member, every flax leaf carried."""
    shapes = jax.eval_shape(
        lambda: FlaxResNet(n_classes=100).init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    )
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    port = dict(ResNet(n_classes=100, population=1, device="meta").named_parameters())
    conv = flax_to_torch(tree)
    assert conv.keys() == port.keys()
    for k, v in conv.items():
        assert v.shape == port[k].shape, k
    n = sum(v[0].numel() for v in conv.values())
    assert 11.0e6 < n < 11.5e6, n

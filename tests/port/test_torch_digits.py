"""Config 8's data and workload in the port against the JAX package's.

- The digits table the port ships (``data/uci/digits.csv.gz``, the UCI
  handwritten-digits test set as scikit-learn bundles it) parses to
  scikit-learn's ``load_digits`` arrays, and ``load_dataset("digits",
  seed=s)`` is byte-equal to the JAX package's for seeds 0-4 (its
  ``_sklearn_tabular``: standardised f32 features, int32 labels, a
  stratified split); a missing file raises.
- ``digits_mlp``: the space's bytes, batch, augmentation and objective
  metrics equal the JAX workload's, the rows reach the trainer as
  ``[N, 1, 1, 64]``, and the hidden-32 MLP's logits equal flax's with
  the weights carried across (f32 within 1e-4, bf16 within 5e-2 of the
  logits' scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from mpi_opt_tpu.data import load_dataset as jax_load_dataset
from mpi_opt_tpu.models.mlp import MLP as FlaxMLP
from mpi_opt_tpu.workloads import get_workload as jax_get_workload
from mpi_opt_tpu_torch import get_workload
from mpi_opt_tpu_torch.data import load_dataset, loaders
from mpi_opt_tpu_torch.models import MLP
from mpi_opt_tpu_torch.models.convert import flax_to_torch
from mpi_opt_tpu_torch.models.resnet import fold_members


@pytest.mark.parametrize("seed", range(5))
def test_digits_arrays_byte_equal_jax(seed):
    want, got = jax_load_dataset("digits", seed=seed), load_dataset("digits", seed=seed)
    assert set(got) == set(want)
    for k in ("train_x", "train_y", "val_x", "val_y"):
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert got["n_classes"] == want["n_classes"] == 10


def test_the_shipped_digits_table_parses_as_sklearn():
    from sklearn.datasets import load_digits

    data, target = loaders.read_digits()
    want = load_digits()
    assert data.dtype == want.data.dtype and data.shape == (1797, 64)
    np.testing.assert_array_equal(data, want.data)
    np.testing.assert_array_equal(target, want.target)


def test_a_missing_digits_file_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(loaders, "UCI_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="'digits' data file"):
        loaders.read_digits()


def test_digits_mlp_workload_equals_jax():
    jwl, twl = jax_get_workload("digits_mlp"), get_workload("digits_mlp")
    assert twl.default_space().space_hash() == jwl.default_space().space_hash()
    assert twl.default_space().spec() == jwl.default_space().spec()
    assert (twl.batch_size, twl.augment, twl.hidden) == (jwl.batch_size, jwl.augment, 32)
    assert tuple(twl.objective_metrics()) == tuple(jwl.objective_metrics())
    d, jd = twl.data(), jwl.data()
    assert d["train_x"].shape == jd["train_x"].shape[:1] + (1, 1, 64)
    assert d["train_x"].reshape(jd["train_x"].shape).tobytes() == jd["train_x"].tobytes()
    assert d["val_y"].tobytes() == jd["val_y"].tobytes()
    with pytest.raises(ValueError, match="digits_mlp supports classification sets digits"):
        get_workload("digits_mlp", dataset="wine")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_digits_mlp_logits_match_flax(dtype):
    rows = load_dataset("digits", seed=0)["val_x"][:8]  # [8, 64]
    model = FlaxMLP(hidden=32, n_classes=10, dtype=getattr(jnp, dtype))
    trees = [jax.tree.map(np.asarray, model.init(jax.random.key(m), jnp.zeros((1, 64)))["params"])
             for m in range(2)]
    conv = [flax_to_torch(t) for t in trees]
    params = {k: torch.cat([c[k] for c in conv]) for k in conv[0]}
    wl = get_workload("digits_mlp")
    assert wl._model(10, 2, "meta").fc1.weight.shape == (2, 32, 64)
    port = MLP(64, hidden=wl.hidden, n_classes=10, dtype=getattr(torch, dtype), population=2,
               device="meta")
    x = torch.from_numpy(rows).reshape(8, 1, 1, 1, 64).expand(-1, -1, -1, 2, -1).contiguous()
    got = functional_call(port, params, (fold_members(x),))
    assert got.dtype == torch.float32 and got.shape == (2, 8, 10)
    for m in range(2):
        want = np.asarray(model.apply({"params": trees[m]}, rows))
        atol = 1e-4 if dtype == "float32" else 5e-2 * max(1.0, np.abs(want).max())
        np.testing.assert_allclose(got[m].numpy(), want, atol=atol)

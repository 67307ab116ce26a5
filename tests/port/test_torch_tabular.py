"""Config 4's data and model in the port against the JAX package's.

- The UCI tables the port ships (``mpi_opt_tpu_torch/data/uci/``) give
  ``breast_cancer`` and ``wine`` arrays byte-equal to
  ``mpi_opt_tpu.data.load_dataset``'s (which reads them through
  scikit-learn) for seeds 0-4; the numpy stratified split equals
  scikit-learn's ``train_test_split`` on class counts whose leftover
  draws tie; a missing file raises.
- ``tabular_mlp``: the space's bytes equal the JAX workload's, and the
  MLP's logits on the rows ``[N, 1, 1, F]`` equal flax's on ``[N, F]``
  with the weights carried across: f32 within 1e-4, bf16 within 5e-2 of
  the logits' scale (bf16 matmuls round differently in oneDNN and XLA).
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
from mpi_opt_tpu_torch.data import loaders
from mpi_opt_tpu_torch.data import load_dataset
from mpi_opt_tpu_torch.models import MLP
from mpi_opt_tpu_torch.models.convert import flax_to_torch
from mpi_opt_tpu_torch.models.resnet import fold_members


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("name", ["breast_cancer", "wine"])
def test_uci_arrays_byte_equal_jax(name, seed):
    want, got = jax_load_dataset(name, seed=seed), load_dataset(name, seed=seed)
    assert set(got) == set(want)
    for k in ("train_x", "train_y", "val_x", "val_y"):
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert got["n_classes"] == want["n_classes"]


@pytest.mark.parametrize("counts,seed", [
    ([5, 5, 5], 0),  # three classes tied in the leftover draw
    ([7, 3, 2, 4], 1),
    ([50, 13], 3),
    ([4, 4, 4, 4, 5], 4),
])
def test_stratified_split_equals_sklearn(counts, seed):
    from sklearn.model_selection import train_test_split

    y = np.repeat(np.arange(len(counts)), counts)
    y = y[np.random.default_rng(seed).permutation(len(y))]
    idx = np.arange(len(y))
    want_train, want_test = train_test_split(idx, test_size=0.25, random_state=seed, stratify=y)
    train, test = loaders.stratified_split(y, 0.25, seed)
    np.testing.assert_array_equal(train, want_train)
    np.testing.assert_array_equal(test, want_test)


def test_a_missing_uci_file_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(loaders, "UCI_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="'wine' data file"):
        loaders.read_uci_csv("wine")


def test_the_shipped_tables_parse_as_sklearn():
    from sklearn import datasets

    for name, fn in (("breast_cancer", datasets.load_breast_cancer), ("wine", datasets.load_wine)):
        data, target = loaders.read_uci_csv(name)
        want = fn()
        np.testing.assert_array_equal(data, want.data)
        np.testing.assert_array_equal(target, want.target)


@pytest.mark.parametrize("dataset", ["breast_cancer", "wine"])
def test_tabular_workload_equals_jax(dataset):
    jwl, twl = jax_get_workload("tabular_mlp", dataset=dataset), get_workload("tabular_mlp", dataset=dataset)
    assert twl.default_space().space_hash() == jwl.default_space().space_hash()
    assert twl.default_space().spec() == jwl.default_space().spec()
    assert (twl.batch_size, twl.augment) == (jwl.batch_size, jwl.augment) == (128, False)
    d, jd = twl.data(), jwl.data()
    assert d["train_x"].shape == jd["train_x"].shape[:1] + (1, 1) + jd["train_x"].shape[1:]
    assert d["train_x"].reshape(jd["train_x"].shape).tobytes() == jd["train_x"].tobytes()
    assert d["n_classes"] == jd["n_classes"]
    with pytest.raises(ValueError, match="breast_cancer/wine"):
        get_workload("tabular_mlp", dataset="digits")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tabular_mlp_logits_match_flax(dtype):
    rows = load_dataset("breast_cancer", seed=0)["val_x"][:8]  # [8, 30]
    model = FlaxMLP(hidden=64, n_classes=2, dtype=getattr(jnp, dtype))
    trees = [jax.tree.map(np.asarray, model.init(jax.random.key(m), jnp.zeros((1, 30)))["params"])
             for m in range(2)]
    conv = [flax_to_torch(t) for t in trees]
    params = {k: torch.cat([c[k] for c in conv]) for k in conv[0]}
    port = MLP(30, hidden=64, n_classes=2, dtype=getattr(torch, dtype), population=2, device="meta")
    x = torch.from_numpy(rows).reshape(8, 1, 1, 1, 30).expand(-1, -1, -1, 2, -1).contiguous()
    got = functional_call(port, params, (fold_members(x),))
    assert got.dtype == torch.float32 and got.shape == (2, 8, 2)
    for m in range(2):
        want = np.asarray(model.apply({"params": trees[m]}, rows))
        atol = 1e-4 if dtype == "float32" else 5e-2 * max(1.0, np.abs(want).max())
        np.testing.assert_allclose(got[m].numpy(), want, atol=atol)

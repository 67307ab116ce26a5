"""The port's synthetic image sets are byte-equal to the JAX package's."""

import pytest

from mpi_opt_tpu.data import load_dataset as jax_load_dataset
from mpi_opt_tpu_torch.data import load_dataset


@pytest.mark.parametrize("name", ["cifar100", "cifar10", "fashion_mnist"])
def test_image_sets_byte_equal(name):
    want = jax_load_dataset(name, n_train=96, n_val=40)
    got = load_dataset(name, n_train=96, n_val=40)
    assert got["n_classes"] == want["n_classes"]
    for k in ("train_x", "train_y", "val_x", "val_y"):
        assert got[k].dtype == want[k].dtype
        assert got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


def test_unknown_dataset_raises():
    with pytest.raises(ValueError, match="unknown dataset"):
        load_dataset("imagenet")

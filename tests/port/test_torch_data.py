"""The port's datasets are byte-equal to the JAX package's."""

import hashlib
import importlib.util
import os

import numpy as np
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


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["digits_image", "diabetes"])
def test_the_last_two_datasets_byte_equal(name, seed):
    want = jax_load_dataset(name, seed=seed)
    got = load_dataset(name, seed=seed)
    assert got["n_classes"] == want["n_classes"] == (10 if name == "digits_image" else 0)
    for k in ("train_x", "train_y", "val_x", "val_y"):
        assert got[k].dtype == want[k].dtype
        assert got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


def test_the_registry_has_every_jax_dataset():
    from mpi_opt_tpu.data.loaders import DATASETS as JAX_DATASETS
    from mpi_opt_tpu_torch.data import DATASETS

    assert set(DATASETS) == set(JAX_DATASETS)


def test_diabetes_parse_and_split_equal_scikit_learn():
    """The numpy parse and scaling equal ``load_diabetes()`` bit for bit,
    and the unstratified split equals ``ShuffleSplit``'s first split."""
    from sklearn.datasets import load_diabetes
    from sklearn.model_selection import ShuffleSplit

    from mpi_opt_tpu_torch.data.loaders import read_diabetes, shuffle_split

    x, y = read_diabetes()
    d = load_diabetes()
    assert x.dtype == d.data.dtype and x.tobytes() == d.data.tobytes()
    assert y.dtype == d.target.dtype and y.tobytes() == d.target.tobytes()
    for n, seed in ((442, 0), (442, 3), (10, 1)):
        train, test = next(ShuffleSplit(test_size=0.25, random_state=seed).split(np.zeros(n)))
        got = shuffle_split(n, 0.25, seed)
        assert got[0].tolist() == train.tolist() and got[1].tolist() == test.tolist()


def test_chip_smoke_pins_the_jax_arrays_digests():
    """The digests phase 23 holds the card's host to are the JAX
    package's arrays under scikit-learn here."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert set(chip_smoke.DATASET_SHA256) == {"digits_image", "diabetes"}
    for name, pinned in chip_smoke.DATASET_SHA256.items():
        d = jax_load_dataset(name, seed=0)
        assert {k: hashlib.sha256(d[k].tobytes()).hexdigest() for k in pinned} == pinned

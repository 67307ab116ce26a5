"""Dataset registry of the port: the synthetic image sets and the
tabular sets of ``mpi_opt_tpu/data/loaders.py``, every key of its
``DATASETS``.

The same generator and arguments as the JAX package's, so the arrays
are byte-equal to its own (NHWC float32 images, int32 labels).
``breast_cancer``, ``wine``, ``digits`` (and ``digits_image``, the same
rows as ``[n, 8, 8, 1]`` images) and the regression set ``diabetes``
are read from the files the port ships in ``data/uci/`` (copied from
scikit-learn's bundled data, BSD-3, see ``data/uci/LICENSE.txt``) and
parsed, scaled, split and standardised as the JAX package's sklearn
loader does, in numpy: scikit-learn itself is not needed.
"""

from __future__ import annotations

import csv
import gzip
import math
import os

import numpy as np

from mpi_opt_tpu_torch.data.synthetic import make_image_classification

_CACHE: dict = {}
UCI_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "uci")
UCI_FILES = {"breast_cancer": "breast_cancer.csv", "wine": "wine_data.csv",
             "digits": "digits.csv.gz", "diabetes_data": "diabetes_data_raw.csv.gz",
             "diabetes_target": "diabetes_target.csv.gz"}


def _uci_path(name: str) -> str:
    """The shipped file of ``name``; a missing file raises: nothing falls back."""
    path = os.path.join(UCI_DIR, UCI_FILES[name])
    if not os.path.exists(path):
        raise FileNotFoundError(f"the {name!r} data file {path} is missing from the package")
    return path


def read_digits():
    """(data float64[1797, 64], target int64[1797]) of the shipped digits
    table, parsed as scikit-learn's ``load_digits``: a gzipped CSV with
    no header, the 64 pixel columns, then the class."""
    with gzip.open(_uci_path("digits"), "rt") as f:
        data = np.loadtxt(f, delimiter=",")
    return data[:, :-1], data[:, -1].astype(np.int64)


def read_diabetes():
    """(data float64[442, 10], target float64[442]) as scikit-learn's
    ``load_diabetes()`` gives them (``scaled=True``): the gzipped,
    whitespace-separated files parsed by ``np.loadtxt``, each column
    centred and scaled by ``sklearn.preprocessing.scale`` (nan-aware
    mean and std, with its second centring passes when a mean is not
    close to zero after the first), then divided by sqrt(n_samples)."""
    with gzip.open(_uci_path("diabetes_data"), "rt") as f:
        x = np.loadtxt(f)
    with gzip.open(_uci_path("diabetes_target"), "rt") as f:
        target = np.loadtxt(f)
    mean_, scale_ = np.nanmean(x, 0), np.nanstd(x, 0)
    x -= mean_
    mean_1 = np.nanmean(x, axis=0)
    if not np.allclose(mean_1, 0):
        x -= mean_1
    # scikit-learn's _handle_zeros_in_scale: a near-constant column is divided by 1
    x /= np.where(scale_ < 10 * np.finfo(scale_.dtype).eps, 1.0, scale_)
    mean_2 = np.nanmean(x, axis=0)
    if not np.allclose(mean_2, 0):
        x -= mean_2
    x /= x.shape[0] ** 0.5
    return x, target


def read_uci_csv(name: str):
    """(data float64[n, f], target int64[n]) of a shipped UCI file, parsed
    as scikit-learn's ``load_csv_data``: a header ``n_samples,n_features,
    class names...``, then one row of features and the class per line."""
    with open(_uci_path(name), encoding="utf-8") as f:
        rows = csv.reader(f)
        head = next(rows)
        n, n_features = int(head[0]), int(head[1])
        data = np.empty((n, n_features))
        target = np.empty((n,), dtype=np.int64)
        for i, row in enumerate(rows):
            data[i] = np.asarray(row[:-1], dtype=np.float64)
            target[i] = np.asarray(row[-1], dtype=np.int64)
    return data, target


def _approximate_mode(class_counts, n_draws: int, rng: np.random.RandomState):
    """scikit-learn's ``utils.extmath._approximate_mode``: the per-class
    counts of ``n_draws`` draws nearest the multivariate hypergeometric
    mode, ties in the leftover broken by ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split(y, test_size: float, seed: int):
    """(train, test) row indices of scikit-learn's ``train_test_split(...,
    test_size=test_size, random_state=seed, stratify=y)``: the first
    split of ``StratifiedShuffleSplit`` with ``RandomState(seed)`` draws
    (the train and test counts per class, each class's permutation,
    then the two final permutations)."""
    n = len(y)
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    _classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(class_counts)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def shuffle_split(n: int, test_size: float, seed: int):
    """(train, test) row indices of scikit-learn's ``train_test_split(...,
    test_size=test_size, random_state=seed)`` without ``stratify``: the
    first split of ``ShuffleSplit``, one ``RandomState(seed)``
    permutation whose first ``ceil(test_size * n)`` rows are the test
    set and the rest the train set."""
    n_test = math.ceil(test_size * n)
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:], perm[:n_test]


def _uci_tabular(name: str, seed: int = 0, val_frac: float = 0.25):
    """A tabular set as the JAX package's ``_sklearn_tabular`` gives it:
    f32 features standardised over the whole set; a classification set
    (integer targets) with int32 labels and a stratified split, a
    regression set (``diabetes``) with f32 targets, ``n_classes`` 0 and
    an unstratified split."""
    if name == "diabetes":
        data, target = read_diabetes()
    else:
        data, target = read_digits() if name == "digits" else read_uci_csv(name)
    x = np.asarray(data, dtype=np.float32)
    x = (x - x.mean(0)) / (x.std(0) + 1e-8)
    classification = target.dtype.kind in "iu"
    if classification:
        y = target.astype(np.int32)
        train, test = stratified_split(y, val_frac, seed)
    else:
        y = target.astype(np.float32)
        train, test = shuffle_split(len(y), val_frac, seed)
    return {
        "train_x": x[train],
        "train_y": y[train],
        "val_x": x[test],
        "val_y": y[test],
        "n_classes": int(y.max()) + 1 if classification else 0,
    }


def _digits_images(seed: int = 0):
    """The ``digits`` rows reshaped to ``[n, 8, 8, 1]`` images."""
    d = _uci_tabular("digits", seed)
    for k in ("train_x", "val_x"):
        d[k] = d[k].reshape(-1, 8, 8, 1)
    return d

DATASETS = {
    "digits": lambda seed=0: _uci_tabular("digits", seed),
    "digits_image": _digits_images,
    "wine": lambda seed=0: _uci_tabular("wine", seed),
    "breast_cancer": lambda seed=0: _uci_tabular("breast_cancer", seed),
    "diabetes": lambda seed=0: _uci_tabular("diabetes", seed),  # regression
    "fashion_mnist": lambda seed=0, n_train=16384, n_val=2048, **kw: make_image_classification(
        n_train, n_val, 28, 28, 1, 10, seed=seed, **kw
    ),
    "cifar10": lambda seed=0, n_train=16384, n_val=2048, **kw: make_image_classification(
        n_train, n_val, 32, 32, 3, 10, seed=seed,
        **{"delta": 0.1, "noise": 2.0, "protos": 16, "coarse": 8, **kw}
    ),
    # label_noise=0.35 caps the reachable val accuracy at 1 - p + p/K
    "cifar100": lambda seed=0, n_train=16384, n_val=2048, **kw: make_image_classification(
        n_train, n_val, 32, 32, 3, 100, seed=seed,
        **{"coarse": 6, "noise": 1.2, "delta": 0.3, "label_noise": 0.35, **kw}
    ),
}


def load_dataset(name: str, **kwargs):
    """Host numpy dict(train_x, train_y, val_x, val_y, n_classes), cached."""
    key = (name, tuple(sorted(kwargs.items())))
    if key not in _CACHE:
        try:
            fn = DATASETS[name]
        except KeyError:
            raise ValueError(f"unknown dataset {name!r}; available: {sorted(DATASETS)}") from None
        _CACHE[key] = fn(**kwargs)
    return _CACHE[key]

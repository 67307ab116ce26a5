"""Dataset registry of the port: the synthetic image sets.

The same generator and arguments as ``mpi_opt_tpu/data/loaders.py``, so
the arrays are byte-equal to the JAX package's (NHWC float32 images,
int32 labels). The sklearn sets are not ported yet.
"""

from __future__ import annotations

from mpi_opt_tpu_torch.data.synthetic import make_image_classification

_CACHE: dict = {}

DATASETS = {
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

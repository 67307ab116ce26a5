"""The port's search space against the JAX package's: maps within one
float32 ulp (exp/log differ between XLA and torch by at most that),
durable identity (spec, space_hash) byte-equal."""

import numpy as np
import pytest
import torch

import mpi_opt_tpu.space as js
import mpi_opt_tpu_torch.space as ts
from mpi_opt_tpu.workloads import get_workload as jax_get_workload
from mpi_opt_tpu_torch.workloads import get_workload


def _spaces():
    doms = lambda m: {
        "lr": m.LogUniform(1e-3, 1.0),
        "momentum": m.Uniform(0.5, 0.99),
        "layers": m.IntUniform(1, 6),
        "act": m.Choice(["relu", "gelu", True]),
    }
    return js.SearchSpace(doms(js)), ts.SearchSpace(doms(ts))


def test_spec_hash_and_discrete_mask_equal():
    j, t = _spaces()
    assert t.spec() == j.spec()
    assert t.space_hash() == j.space_hash()
    np.testing.assert_array_equal(t.discrete_mask(), j.discrete_mask())


def test_workload_default_space_identity():
    j = jax_get_workload("cifar100_resnet18").default_space()
    t = get_workload("cifar100_resnet18").default_space()
    assert t.space_hash() == j.space_hash()


def test_from_unit_and_to_unit_within_one_ulp():
    j, t = _spaces()
    u = np.random.default_rng(0).random((257, 4), dtype=np.float32)
    u[0] = 0.0
    u[1] = 1.0
    want = j.from_unit(u)
    got = t.from_unit(torch.from_numpy(u))
    for name in j.names:
        np.testing.assert_array_max_ulp(got[name].numpy(), np.asarray(want[name]), maxulp=1)
    back_j = np.asarray(j.to_unit({k: np.asarray(v) for k, v in want.items()}))
    back_t = t.to_unit({k: v for k, v in got.items()}).numpy()
    np.testing.assert_array_max_ulp(back_t, back_j, maxulp=1)


def test_from_unit_rounds_float64_input_to_float32_first():
    _, t = _spaces()
    u = np.random.default_rng(1).random((8, 4))
    np.testing.assert_array_equal(
        t.from_unit(u)["lr"].numpy(), t.from_unit(u.astype(np.float32))["lr"].numpy()
    )


def test_materialize_row_and_params_to_unit_equal():
    j, t = _spaces()
    rows = np.random.default_rng(2).random((32, 4), dtype=np.float32)
    for row in rows:
        want = j.materialize_row(row)
        got = t.materialize_row(row)
        assert got.keys() == want.keys()
        for k in want:
            assert type(got[k]) is type(want[k])
            if isinstance(want[k], float):
                np.testing.assert_array_max_ulp(np.float32(got[k]), np.float32(want[k]), maxulp=1)
            else:
                assert got[k] == want[k]
        np.testing.assert_array_max_ulp(t.params_to_unit(want), j.params_to_unit(want), maxulp=1)


def test_sample_unit_shape_and_range():
    _, t = _spaces()
    g = torch.Generator().manual_seed(0)
    u = t.sample_unit(g, 64)
    assert u.shape == (64, 4) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


@pytest.mark.parametrize(
    "make", [lambda: ts.Uniform(1.0, 1.0), lambda: ts.LogUniform(0.0, 1.0), lambda: ts.IntUniform(3, 2)]
)
def test_bad_domains_raise(make):
    with pytest.raises(ValueError):
        make()

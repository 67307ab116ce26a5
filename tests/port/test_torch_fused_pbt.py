"""The port's fused PBT end to end on the CPU, at a tiny size.

Full ResNet-18 depth at width 8, population 4, 2 generations x 2 steps,
256 train / 128 val images.
"""

import math

import numpy as np
import pytest
import torch

from mpi_opt_tpu_torch import fused_pbt, get_workload
from mpi_opt_tpu_torch.ops import group_norm as gn

KEYS = {"best_score", "best_params", "diverged", "best_curve", "mean_curve",
        "member_failures", "state", "unit", "launch_gens", "launch_walls", "journal", "objectives",
        "pareto"}
RUN = dict(population=4, generations=2, steps_per_gen=2, seed=0, device="cpu")


@pytest.fixture(scope="module")
def workload():
    return get_workload("cifar100_resnet18", n_train=256, n_val=128, width=8)


@pytest.fixture(scope="module")
def runs(workload):
    gn.reset_launches()
    whole = fused_pbt(workload, **RUN)
    plain_calls = gn.LAUNCHES["plain"]
    return whole, plain_calls, fused_pbt(workload, gen_chunk=1, **RUN), fused_pbt(workload, **RUN)


def test_result_keys_and_finite(runs):
    res, plain_calls, _, _ = runs
    assert set(res) == KEYS
    assert res["objectives"] is None and res["pareto"] is None  # a scalar sweep
    assert math.isfinite(res["best_score"]) and not res["diverged"]
    assert res["best_curve"].shape == (2,) and np.isfinite(res["mean_curve"]).all()
    assert res["member_failures"] == [0, 0]
    assert res["unit"].shape == (4, 5) and ((res["unit"] >= 0) & (res["unit"] <= 1)).all()
    assert set(res["best_params"]) == {"lr", "momentum", "weight_decay", "flip_prob", "shift"}
    assert res["launch_gens"] == [2] and len(res["launch_walls"]) == 1
    assert res["state"].step.tolist() == [4] * 4
    # 20 GN sites: forward + backward per step, forward per eval chunk
    assert plain_calls == 2 * (2 * 40 + 20)


def test_gen_chunk_equals_one_launch(runs):
    whole, _, chunked, _ = runs
    assert chunked["launch_gens"] == [1, 1]
    np.testing.assert_array_equal(chunked["best_curve"], whole["best_curve"])
    np.testing.assert_array_equal(chunked["mean_curve"], whole["mean_curve"])
    np.testing.assert_array_equal(chunked["unit"], whole["unit"])
    assert chunked["best_score"] == whole["best_score"]
    for k, v in whole["state"].params.items():
        assert torch.equal(chunked["state"].params[k], v), k


def test_same_seed_twice_identical(runs):
    whole, _, _, again = runs
    np.testing.assert_array_equal(again["unit"], whole["unit"])
    np.testing.assert_array_equal(again["best_curve"], whole["best_curve"])
    for k, v in whole["state"].momentum.items():
        assert torch.equal(again["state"].momentum[k], v), k


def test_default_device_raises_without_cuda(workload, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fused_pbt(workload, population=4, generations=1, steps_per_gen=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        workload.make_trainer()


def _world_of_one():
    from mpi_opt_tpu_torch.parallel.mesh import Mesh

    return Mesh(1)


@pytest.mark.parametrize(
    "arg,value",
    [("mesh", _world_of_one())],
)
def test_out_of_scope_arguments_raise(workload, runs, arg, value):
    # mesh= is ported (tests/port/test_torch_multiprocess.py): a 1 x 1
    # mesh, a world of one, runs the one-process sweep bit for bit
    got = fused_pbt(workload, **RUN, **{arg: value})
    whole = runs[0]
    np.testing.assert_array_equal(got["best_curve"], whole["best_curve"])
    np.testing.assert_array_equal(got["unit"], whole["unit"])
    for k, v in whole["state"].params.items():
        assert torch.equal(got["state"].params[k], v), k


@pytest.mark.parametrize("arg,value,match", [
    ("step_chunk", 1, "step_chunk is not supported with multi-objective"),
    ("wave_size", 2, "wave scheduling is not supported with multi-objective"),
])
def test_objectives_keep_the_reference_refusals(workload, arg, value, match):
    """``objectives`` is ported (``test_torch_fused_mo.py``); what the JAX
    package refuses with it is refused here too, before any work."""
    from mpi_opt_tpu_torch.objectives import ObjectiveSpec

    run = dict(RUN, gen_chunk=0) if arg == "wave_size" else RUN
    with pytest.raises(ValueError, match=match):
        fused_pbt(workload, objectives=ObjectiveSpec.parse("accuracy,params:min"),
                  **run, **{arg: value})


@pytest.mark.parametrize("arg", ["step_chunk", "checkpoint_dir", "ledger", "oom_backoff", "wave_size"])
def test_durability_arguments_run(arg, tmp_path):
    """The arguments ported with the durability layer and the wave
    engine: each runs and leaves the sweep's result as it is (the MLP
    keeps this fast; ``test_torch_fused_resume.py`` and
    ``test_torch_fused_waves.py`` hold their contracts)."""
    from mpi_opt_tpu_torch.ledger import SweepLedger
    from mpi_opt_tpu_torch.utils import integrity

    wl = get_workload("fashion_mlp", n_train=256, n_val=128)
    kw = dict(population=4, generations=2, steps_per_gen=2, seed=0, gen_chunk=1, device="cpu")
    base = fused_pbt(wl, **kw)
    value = {"step_chunk": 1, "checkpoint_dir": str(tmp_path / "ck"), "oom_backoff": 0,
             "wave_size": 3}.get(arg)
    if arg == "wave_size":
        kw = dict(kw, gen_chunk=0)
    if arg == "ledger":
        value = SweepLedger(str(tmp_path / "l.jsonl"))
        value.ensure_header({"mode": "fused", "space_hash": wl.default_space().space_hash()})
    res = fused_pbt(wl, **kw, **{arg: value})
    np.testing.assert_array_equal(res["best_curve"], base["best_curve"])
    np.testing.assert_array_equal(res["unit"], base["unit"])
    for k, v in base["state"].params.items():
        assert torch.equal(res["state"].params[k], v), k
    if arg == "checkpoint_dir":
        assert integrity._committed_steps(value) == [1, 2]
    if arg == "ledger":
        value.close()
        assert res["journal"] == {"written": 8, "verified": 0}
    else:
        assert res["journal"] is None


def test_momentum_dtype_knob_raises(workload, monkeypatch):
    """The knob is ported: a dtype it names stores the momentum, and a
    spelling that names none raises."""
    monkeypatch.setenv("MPI_OPT_TPU_MOMENTUM_DTYPE", "float8")
    with pytest.raises(ValueError, match="MPI_OPT_TPU_MOMENTUM_DTYPE"):
        fused_pbt(workload, **RUN)
    monkeypatch.setenv("MPI_OPT_TPU_MOMENTUM_DTYPE", "bfloat16")
    res = fused_pbt(workload, population=2, generations=1, steps_per_gen=1, device="cpu")
    assert {v.dtype for v in res["state"].momentum.values()} == {torch.bfloat16}
    assert math.isfinite(res["best_score"])


def test_unknown_argument_and_zero_generations_raise(workload):
    with pytest.raises(TypeError):
        fused_pbt(workload, **RUN, no_such_option=1)
    with pytest.raises(ValueError, match="generations"):
        fused_pbt(workload, population=4, generations=0, steps_per_gen=1, device="cpu")

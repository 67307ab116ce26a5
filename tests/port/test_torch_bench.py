"""The port's bench, its metrics and FLOP count, and the workloads it runs.

- ``utils/metrics.py`` gives the JAX package's functions' results on the
  same curves, bit for bit (pure Python on both sides).
- ``utils/flops.py`` counts the SmallCNN exactly as the hand count of
  its conv and dense FLOPs, and within 10% of the JAX package's
  ``population_sweep_flops``, which reads XLA's cost analysis: XLA also
  counts elementwise work (GroupNorm, ReLU, the update, the loss) and
  counts a conv's FLOPs by its own rules, where the port's counter takes
  matrix products and convolutions only.
- The bench runs on the CPU at population 2 x 1 generation x 1 step on
  a small dataset and prints the JAX bench's record keys.
"""

import ast
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import mpi_opt_tpu.utils.metrics as jax_metrics
from mpi_opt_tpu.utils.flops import population_sweep_flops as jax_population_sweep_flops
from mpi_opt_tpu.workloads import get_workload as jax_get_workload
from mpi_opt_tpu_torch import bench
from mpi_opt_tpu_torch.utils import flops, metrics
from mpi_opt_tpu_torch.workloads import get_workload
from mpi_opt_tpu_torch.workloads.vision import Cifar10CNN

ROOT = Path(__file__).resolve().parents[2]

# SmallCNN at width 32 on 32x32x3, 10 classes: multiply-adds a sample
CONV0 = 32 * 32 * 32 * 27
MACS = CONV0 + 32 * 32 * 32 * 288 + 16 * 16 * 64 * 288 + 16 * 16 * 64 * 576 + 4096 * 128 + 128 * 10


# -- workloads ------------------------------------------------------------


@pytest.mark.parametrize("name,width,n_params", [
    ("cifar10_cnn", 32, 591_658), ("cifar100_cnn", 64, None), ("fashion_mlp", None, 101_770)])
def test_workloads_build_as_the_jax_package_defines_them(name, width, n_params):
    wl, jwl = get_workload(name, n_train=64, n_val=32), jax_get_workload(name, n_train=64, n_val=32)
    assert wl.batch_size == jwl.batch_size == 256 and wl.augment == jwl.augment
    assert wl.dataset == jwl.dataset
    assert wl.default_space().space_hash() == jwl.default_space().space_hash()
    d, jd = wl.data(), jwl.data()
    for k in ("train_x", "train_y", "val_x", "val_y"):
        assert np.asarray(d[k]).tobytes() == np.asarray(jd[k]).tobytes(), k
    assert getattr(wl, "width", None) == width
    x0 = jax.numpy.zeros((1,) + d["train_x"].shape[1:])
    shapes = jax.eval_shape(lambda: jwl._model(jd["n_classes"]).init(jax.random.key(0), x0)["params"])
    want = sum(math.prod(s.shape) for s in jax.tree.leaves(shapes))
    got = sum(v[0].numel() for v in wl.make_trainer(device="cpu").template.parameters())
    assert got == want
    if n_params is not None:
        assert got == n_params


# -- metrics --------------------------------------------------------------

CURVES = [
    ([0.1, 0.4, 0.7, 0.8], [2, 2], [3.0, 5.0]),
    ([0.1, 0.4, 0.69999999, 0.7000001], [1, 1, 1, 1], [1.0, 2.0, 3.0, 4.0]),
    ([0.75], [1], [7.25]),
    ([0.2, 0.3, 0.5], [3], [9.0]),
    ([np.float32(0.7), np.float32(0.1)], [1, 1], [0.5, 0.25]),
]


@pytest.mark.parametrize("curve,gens,walls", CURVES)
@pytest.mark.parametrize("target", [0.0, 0.5, 0.7, 1.0])
def test_metrics_equal_the_jax_package_bit_for_bit(curve, gens, walls, target):
    assert metrics.wall_to_target(curve, 10.0, target) == jax_metrics.wall_to_target(curve, 10.0, target)
    assert (metrics.wall_to_target_launchwise(curve, gens, walls, target)
            == jax_metrics.wall_to_target_launchwise(curve, gens, walls, target))
    res = {"best_curve": np.asarray(curve), "launch_gens": gens, "launch_walls": walls}
    for r in (res, {**res, "launch_walls": None}):
        assert (metrics.sweep_wall_to_target(r, 12.5, target)
                == jax_metrics.sweep_wall_to_target(r, 12.5, target))


@pytest.mark.parametrize("gens,walls", [([1], [1.0, 2.0]), ([1, 1], [1.0, 2.0])])
def test_metrics_refuse_misaligned_launches_as_the_jax_package(gens, walls):
    curve = [0.1, 0.2, 0.3]
    with pytest.raises(ValueError) as want:
        jax_metrics.wall_to_target_launchwise(curve, gens, walls, 0.5)
    with pytest.raises(ValueError, match=str(want.value).replace("(", r"\(").replace(")", r"\)")):
        metrics.wall_to_target_launchwise(curve, gens, walls, 0.5)


# -- FLOPs ----------------------------------------------------------------


@pytest.fixture(scope="module")
def cnn():
    return get_workload("cifar10_cnn", n_train=512, n_val=1500)


def test_flops_equal_the_hand_count(cnn):
    f_step, f_eval = cnn.make_trainer(device="cpu").member_flops(cnn.data()["train_x"].shape[1:])
    # training: forward, weight gradients, and input gradients of every
    # layer but conv0; eval: the forward of a 1024-image chunk
    assert f_step == 2 * 256 * (3 * MACS - CONV0) == 37_952_028_672
    assert f_eval == 2 * 1024 * MACS
    total = flops.population_sweep_flops(cnn, 4, 3, 5)
    assert total == 4 * (3 * 5 * f_step + 3 * 2 * f_eval)  # 1500 images: 2 eval chunks
    assert flops.population_sweep_flops(cnn, 4, 3, 5, n_evals=1) == 4 * (15 * f_step + 2 * f_eval)


def test_flops_within_tolerance_of_the_jax_count(cnn):
    jwl = jax_get_workload("cifar10_cnn", n_train=512, n_val=1500)
    want = jax_population_sweep_flops(jwl, 2, 1, 1)
    got = flops.population_sweep_flops(cnn, 2, 1, 1)
    assert want is not None and abs(got - want) <= 0.10 * want, (got, want)


def test_peak_and_mfu_come_from_the_card_name_only(monkeypatch):
    assert flops.peak_flops_per_chip("cpu") is None
    assert flops.mfu(1e15, 1.0, "cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, peak in [("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
                       ("NVIDIA H100 NVL", 835e12), ("NVIDIA A100-SXM4-80GB", None)]:
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None, n=name: n)
        assert flops.peak_flops_per_chip("cuda") == peak
        assert flops.mfu(peak and peak / 2, 1.0, "cuda") == (peak and 0.5)


# -- the bench ------------------------------------------------------------


def _jax_record_keys():
    """Keys of the record ``bench.py::main`` prints, read from its source."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and getattr(node.targets[0], "id", None) == "record":
            keys |= {k.value for k in node.value.keys}
        elif isinstance(node, ast.Subscript) and getattr(node.value, "id", None) == "record" \
                and isinstance(node.ctx, ast.Store):
            keys.add(node.slice.value)
    return keys


class _NarrowCNN(Cifar10CNN):
    """cifar10_cnn at width 8, so the CPU run takes seconds; the bench's
    path is the same at any width."""

    width = 8


def _small(name):
    assert name == "cifar10_cnn"
    return _NarrowCNN(n_train=256, n_val=64)


@pytest.fixture(scope="module")
def small_run():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "get_workload", _small)
        return bench.run(population=2, generations=1, steps=1, member_chunk=1, device="cpu"), _small("cifar10_cnn")


def test_bench_record_on_the_cpu(small_run):
    (rec, res), wl = small_run
    skipped_baseline = {"cpu_rank_trials_per_sec", "vs_one_rank", "vs_8rank_equiv"}
    # schema_version versions the JAX package's own trace tooling, which
    # is not ported
    assert _jax_record_keys() - skipped_baseline - {"schema_version"} <= set(rec)
    assert rec["metric"] == "pbt_cifar10_cnn_member_generations_per_sec_per_chip"
    assert rec["unit"] == "trials/sec/chip" and rec["device"] == "cpu"
    assert (rec["population"], rec["generations"], rec["steps_per_gen"]) == (2, 1, 1)
    assert rec["value"] == 2 / rec["wall_s"] and rec["member_steps_per_sec"] == 2 / rec["wall_s"]
    assert rec["flops_total"] == flops.population_sweep_flops(wl, 2, 1, 1)
    assert rec["tflops_per_sec"] == rec["flops_total"] / rec["wall_s"] / 1e12
    assert rec["mfu"] is None and rec["device_memory"] is None
    assert rec["vs_baseline"] == 1.0 and rec["baseline"] == "skipped"
    for k in ("trace_stream", "platform_matmul_tflops", "mfu_vs_platform_cap"):
        assert rec[k] is None, k
    # both runs traced into a temporary stream: its attribution rides the
    # record, with one train span a launch of each run
    assert rec["trace"]["phases"]["train"]["count"] == 2 and rec["trace"]["coverage"] > 0
    assert rec["best_val_acc"] == res["best_score"] and 0.0 <= rec["best_val_acc"] <= 1.0
    assert rec["wall_to_target_s"] == metrics.sweep_wall_to_target(res, rec["wall_s"], 0.70)
    assert rec["launch_gens"] == [1] and len(rec["launch_walls_s"]) == 1
    # the best post-exploit score is a gathered pre-exploit score
    assert rec["best_val_acc"] <= rec["best_curve"][-1]
    json.dumps(rec)


def test_bench_main_prints_one_json_line(monkeypatch, capsys):
    monkeypatch.setattr(bench, "get_workload", _small)
    assert bench.main(["--population", "2", "--generations", "1", "--steps", "1",
                       "--member-chunk", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["population"] == 2 and rec["member_chunk"] == 2 and rec["target_acc"] == 0.70


def test_bench_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--population", "2", "--generations", "1", "--steps", "1"])

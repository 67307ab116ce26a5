"""The port's multi-process SPMD on the CPU: 2 gloo ranks a world, small
shapes, five worlds in all (each costs ~7 s to start two torch
processes here).

- pop-sharded fused PBT (2 x 1) is bit-equal to one process launched at
  the same width (``member_chunk = P / 2``: oneDNN, like cuDNN, picks a
  grouped convolution's algorithm by group count);
- the sharded run is held against the JAX package's
  ``fused_pbt(..., mesh=make_mesh(n_pop=2))`` as the fused-PBT parity
  tests hold the two packages (the ledger's header and record structure,
  the result's keys, the journal counts);
- fused SHA over the mesh rounds its rungs as the JAX package's
  ``sha_cohort_sizes(..., round_to=2)``, warning once for the first
  cohort the axis does not divide;
- the gpu slot pool sharded over the mesh scores every trial as one
  process does;
- ``n_data = 2`` agrees with one process within 0.02 on the best score
  and the mean curve (``tests/test_parallel.py``'s tolerance), and one
  population step on half batches, gradients averaged, is held against
  the JAX package's step on the whole batch (``test_torch_population``'s
  case and tolerances), while a rank alone on its half is not;
- a device OOM on one rank alone, over either axis, halves the whole
  world's wave cap, and the run ends as the unfaulted one;
- the CLI through ``python -m mpi_opt_tpu_torch.launch`` with
  ``--rank-kill`` and ``--checkpoint-dir`` relaunches and ends in a
  ledger record-identical to the unkilled run's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mpi_opt_tpu.ledger.store as jstore
from mpi_opt_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mpi_opt_tpu.train.fused_asha import sha_cohort_sizes as jax_sha_cohort_sizes
from mpi_opt_tpu.train.fused_pbt import fused_pbt as jax_fused_pbt
from mpi_opt_tpu.workloads import get_workload as jax_get_workload
import mpi_opt_tpu.ops.pallas_gn as pg
from mpi_opt_tpu_torch.train.fused_pbt import fused_pbt
from mpi_opt_tpu_torch.workloads import get_workload
from test_torch_population import KW as POP_KW
from test_torch_population import LOSS_ATOL, MOMENTUM_ATOL, PARAMS_ATOL, pop_update_case
from torch_port_ranks import concat_params, spawn_world
from torch_port_small import KW, small_workload

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VOLATILE = {"ts", "sweep_id", "created_ts"}


@pytest.fixture(scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pop_world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pop"))
    return d, spawn_world("pop", d)


@pytest.fixture(scope="module")
def data_world(tmp_path_factory):
    """The 1 x 2 world; its ranks read the JAX step's inputs, and the
    JAX step's result stays here."""
    d = str(tmp_path_factory.mktemp("data"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pg, "_INTERPRET", True)
        port, want = pop_update_case()
    torch.save({**port, "kw": POP_KW}, os.path.join(d, "pop_update.pt"))
    return d, spawn_world("data", d), want


def _assert_oom_drill(ranks):
    """A device OOM on rank 1 alone: every rank halved once, together,
    and ended as the unfaulted run."""
    for r in ranks:
        clean, faulted = r["oom"]["clean"], r["oom"]["faulted"]
        assert clean["oom_backoffs"] == 0 and clean["wave_size"] == 4
        assert faulted["oom_backoffs"] == 1 and faulted["wave_size"] == 2
        for k in ("best_curve", "mean_curve", "unit"):
            np.testing.assert_array_equal(faulted[k], clean[k], err_msg=k)
    assert ranks[0]["oom"]["faulted"]["waves_run"] == ranks[1]["oom"]["faulted"]["waves_run"]


def test_pop_sharded_pbt_is_bit_equal_to_one_process_at_the_same_width(pop_world, one_thread):
    _, ranks = pop_world
    ref = fused_pbt(small_workload(), member_chunk=KW["population"] // 2, **KW)
    for r in ranks:
        got = r["cnn"]
        assert got["rows"] == KW["population"] // 2  # each rank holds its half
        np.testing.assert_array_equal(got["best_curve"], ref["best_curve"])
        np.testing.assert_array_equal(got["mean_curve"], ref["mean_curve"])
        np.testing.assert_array_equal(got["unit"], ref["unit"])
        assert got["best_score"] == ref["best_score"]
    params = concat_params([r["cnn"]["params"] for r in ranks])
    for k, v in ref["state"].params.items():
        np.testing.assert_array_equal(params[k], v.numpy(), err_msg=k)


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_sharded_run_held_against_the_jax_mesh_run(pop_world, tmp_path):
    d, ranks = pop_world
    jwl = jax_get_workload("fashion_mlp", n_train=256, n_val=128)
    led = jstore.SweepLedger(str(tmp_path / "jax.jsonl"))
    led.ensure_header({"mode": "fused", "seed": 0, "space_hash": jwl.default_space().space_hash()})
    try:
        want = jax_fused_pbt(jwl, population=4, generations=2, steps_per_gen=2, seed=0,
                             gen_chunk=1, ledger=led, mesh=jax_make_mesh(n_pop=2))
    finally:
        led.close()
    got = ranks[0]["pbt"]
    assert ranks[1]["pbt"]["best_curve"].tolist() == got["best_curve"].tolist()
    assert set(got) | {"state"} == set(want)
    assert got["journal"] == want["journal"] == {"written": 8, "verified": 0}
    assert got["launch_gens"] == want["launch_gens"] == [1, 1]
    t_lines, j_lines = _lines(os.path.join(d, "pbt.jsonl")), _lines(tmp_path / "jax.jsonl")
    strip = lambda r: {k: v for k, v in r.items() if k not in VOLATILE}
    assert strip(t_lines[0]) == strip(j_lines[0])
    shape = lambda rs: [(r["boundary"], r["boundary_size"], r["trial_id"], r["member"], r["step"])
                        for r in rs]
    assert shape(t_lines[1:]) == shape(j_lines[1:])
    assert [set(r) for r in t_lines[1:]] == [set(r) for r in j_lines[1:]]
    assert jstore.validate_ledger(os.path.join(d, "pbt.jsonl")) == []
    assert all(np.isfinite(got["best_curve"])) and all(np.isfinite(want["best_curve"]))


def test_sha_rungs_round_to_the_pop_axis_as_jax(pop_world):
    _, ranks = pop_world
    sizes = ranks[0]["sha"]["rung_sizes"]
    assert sizes == jax_sha_cohort_sizes(9, len(sizes), 3, round_to=2) == [9, 4, 2]
    assert ranks[1]["sha"] == ranks[0]["sha"]
    # the 9-member first cohort ran replicated, with the JAX package's warning
    assert ranks[0]["sha"]["warnings"] == [
        "population axis of size 9 does not divide the mesh 'pop' axis (2); the array is "
        "replicated on every device instead of sharded — correct, but not member-parallel. "
        "Use a population that is a multiple of 2 (e.g. 8 or 10)."]


def test_gpu_slot_pool_sharded_scores_as_one_process(pop_world, one_thread):
    from mpi_opt_tpu_torch.algorithms import get_algorithm
    from mpi_opt_tpu_torch.backends import get_backend
    from mpi_opt_tpu_torch.driver import run_search

    _, ranks = pop_world
    wl = get_workload("fashion_mlp", n_train=256, n_val=128)
    backend = get_backend("gpu", wl, population=4, seed=1, device="cpu")
    try:
        algo = get_algorithm("random")(wl.default_space(), seed=1, max_trials=8, budget=4)
        run_search(algo, backend)
    finally:
        backend.close()
    want = sorted((t.trial_id, t.score) for t in algo.trials.values())
    assert ranks[0]["driver"]["pool_size"] == 10  # 2 * 4 + 1 rounded up to the axis
    assert ranks[0]["driver"]["scores"] == ranks[1]["driver"]["scores"]
    assert [t for t, _ in ranks[0]["driver"]["scores"]] == [t for t, _ in want]
    np.testing.assert_allclose([s for _, s in ranks[0]["driver"]["scores"]],
                               [s for _, s in want], atol=1e-6)


def test_waves_tpe_hyperband_bohb_over_the_mesh(pop_world, one_thread):
    """Every fused driver over the 2 x 1 mesh: PBT in waves of 4 (each
    rank its 2 rows of a wave, launches of 1 member) bit-equal to one
    process's waves; TPE's cohort of 4 (2 a rank) bit-equal to one
    process at member chunk 2; Hyperband and BOHB (model-drawn cohorts,
    persisted under a shared checkpoint directory) the same on both
    ranks, their rungs rounded to the 'pop' axis."""
    from mpi_opt_tpu_torch.train.fused_tpe import fused_tpe

    _, ranks = pop_world
    mlp = lambda: get_workload("fashion_mlp", n_train=256, n_val=128)
    waves = fused_pbt(mlp(), device="cpu", population=8, generations=2, steps_per_gen=2, seed=1,
                      wave_size=4)
    tpe = fused_tpe(get_workload("tabular_mlp"), n_trials=8, batch=4, budget=2, seed=0, device="cpu",
                    member_chunk=2)
    for r in ranks:
        for k in ("best_curve", "mean_curve", "unit"):
            np.testing.assert_array_equal(r["pbt_waves"][k], waves[k], err_msg=k)
        assert r["pbt_waves"]["waves_run"] == waves["waves_run"] == 4
        np.testing.assert_array_equal(r["tpe"]["obs_scores"], tpe["obs_scores"])
        np.testing.assert_array_equal(r["tpe"]["obs_unit"], tpe["obs_unit"])
    assert ranks[0]["hyperband"] == ranks[1]["hyperband"] and ranks[0]["bohb"] == ranks[1]["bohb"]
    for b in ranks[0]["hyperband"] + ranks[0]["bohb"]:
        sizes = b["rung_sizes"]
        assert sizes == jax_sha_cohort_sizes(sizes[0], len(sizes), 3, round_to=2)
        assert np.isfinite(b["best_score"])


def test_a_signal_on_one_rank_drains_every_rank_at_one_boundary(pop_world):
    _, ranks = pop_world
    # rank 0 alone saw the request, at its 2nd boundary before the vote;
    # the vote carried it to rank 1, and both drained there
    assert ranks[0]["drain_at"] == ranks[1]["drain_at"] == "boundary:pbt launch 2/4"


def test_an_oom_on_one_rank_halves_the_world_together(pop_world, data_world):
    # pop axis: rank 0 meets rank 1's flag at its wave's score gather;
    # data axis: at its first gradient average of the wave
    _assert_oom_drill(pop_world[1])
    _assert_oom_drill(data_world[1])


def test_data_axis_pop_update_matches_jax_on_the_whole_batch(data_world):
    _, ranks, want = data_world
    for r in ranks:
        got = r["pop_update"]["averaged"]
        np.testing.assert_allclose(got["loss"], want["loss"], atol=LOSS_ATOL)
        for name, atol in (("params", PARAMS_ATOL), ("momentum", MOMENTUM_ATOL)):
            for k, v in want[name].items():
                np.testing.assert_allclose(got[name][k], v.numpy(), atol=atol, err_msg=f"{name} {k}")
        # a rank alone on its half (the average dropped) is refused
        alone = r["pop_update"]["alone"]["momentum"]
        assert max(np.abs(alone[k] - v.numpy()).max() for k, v in want["momentum"].items()) > 10 * MOMENTUM_ATOL
    for k, v in ranks[0]["pop_update"]["averaged"]["params"].items():
        np.testing.assert_array_equal(ranks[1]["pop_update"]["averaged"]["params"][k], v, err_msg=k)


def test_data_axis_agrees_with_one_process(data_world, one_thread):
    _, ranks, _ = data_world
    wl = get_workload("fashion_mlp", n_train=512, n_val=256)
    wl.batch_size = 32
    ref = fused_pbt(wl, device="cpu", population=8, generations=2, steps_per_gen=10, seed=3)
    for r in ranks:
        assert r["best_score"] == pytest.approx(ref["best_score"], abs=0.02)
        np.testing.assert_allclose(r["mean_curve"], ref["mean_curve"], atol=0.02)
    # both data ranks hold the same members and decide the same exploit
    np.testing.assert_array_equal(ranks[0]["unit"], ranks[1]["unit"])
    np.testing.assert_array_equal(ranks[0]["mean_curve"], ranks[1]["mean_curve"])


def _launch(tmp_path, name, *extra, launcher=("--retries", "1")):
    d = tmp_path / name
    d.mkdir()
    argv = [sys.executable, "-m", "mpi_opt_tpu_torch.launch", "--n-proc", "2", "--log-dir",
            str(d / "logs"), "--term-grace", "5", "--restart-backoff", "0", *launcher, "--",
            "--workload", "fashion_mlp", "--algorithm", "pbt", "--fused", "--population", "4",
            "--generations", "3", "--steps-per-generation", "2", "--gen-chunk", "1",
            "--device", "cpu", "--ledger", str(d / "sweep.jsonl"), "--checkpoint-dir",
            str(d / "ck"), "--coord-timeout", "60", *extra]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    p = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    return p, d


def test_rank_kill_through_the_launcher_resumes_record_identical(tmp_path):
    whole, dw = _launch(tmp_path, "whole")
    assert whole.returncode == 0, whole.stderr[-2000:]
    killed, dk = _launch(tmp_path, "killed", "--rank-kill",
                         f"rank=1,at=2,marker={tmp_path / 'killed.marker'}")
    assert killed.returncode == 0, killed.stderr[-2000:]
    events = [json.loads(line) for line in killed.stdout.splitlines()]
    kinds = [e.get("event") for e in events]
    assert kinds == ["launch", "restart", "launch", None, "done"]
    assert events[1]["rank"] == 1 and events[1]["returncode"] == -9  # SIGKILL
    assert events[2]["resume"] is True and os.path.exists(tmp_path / "killed.marker")
    summary = events[3]
    assert summary["mesh"] == {"pop": 2, "data": 1} and summary["n_chips"] == 2
    assert summary["best_curve"] == json.loads(whole.stdout.splitlines()[-2])["best_curve"]
    strip = lambda rs: [{k: v for k, v in r.items() if k not in VOLATILE} for r in rs]
    assert strip(_lines(dk / "sweep.jsonl")) == strip(_lines(dw / "sweep.jsonl"))
    # rank 1 only reads the ledger; the backend was chosen and logged
    rank1 = [json.loads(x) for x in open(dk / "logs" / "rank1.out") if x.startswith("{")]
    assert {"event": "ledger_rank_gated", "rank": 1}.items() <= next(
        e for e in rank1 if e.get("event") == "ledger_rank_gated").items()
    launch = next(e for e in rank1 if e.get("event") == "launch")
    assert launch["backend"] == "gloo" and launch["world"] == 2 and launch["device"] == "cpu"

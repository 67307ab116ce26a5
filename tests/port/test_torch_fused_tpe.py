"""Fused TPE in the port against the JAX package's, and its own
invariants on the CPU.

Against the JAX ``fused_tpe`` (one sweep each side, on ``tabular_mlp``,
config 4's workload, at 10 trials in batches of 4 and 2 steps: two XLA
compiles): the result's keys, the generation sizes (4, 4, 2) and write
positions (each generation's journal records are the next trials, in
order), the curve's length, one failure count a generation, and ledger
records with the JAX keys and the same (boundary, size, trial id, step)
sequence, which the JAX ledger reader validates. Scores differ (the
packages' random streams differ), so the comparison is structural.

The port alone: waves (with and without a member chunk) equal resident;
a crash and resume equals the unkilled run, records included; a
snapshot refuses another ``cfg`` and the other mode; the CLI runs
``--algorithm tpe`` with the JAX CLI's ledger header; ``mesh`` is not
ported (warm start: ``test_torch_warmstart.py``).
"""

import json

import numpy as np
import pytest
import torch

import mpi_opt_tpu.ledger.store as jstore
from mpi_opt_tpu.train.fused_tpe import fused_tpe as jax_fused_tpe
from mpi_opt_tpu.workloads import get_workload as jax_get_workload
from mpi_opt_tpu_torch import cli, get_workload
from mpi_opt_tpu_torch.ledger import SweepLedger, validate_ledger
from mpi_opt_tpu_torch.ops.tpe import TPEConfig
from mpi_opt_tpu_torch.train.fused_tpe import fused_tpe
from mpi_opt_tpu_torch.utils import resources
from torch_port_small import small_workload

KW = dict(n_trials=10, batch=4, budget=2, seed=0)
FIELDS = ("trial_id", "member", "boundary", "boundary_size", "params", "status", "score", "step")
SHAPE = ("boundary", "boundary_size", "trial_id", "member", "step")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _header(space, seed=0):
    return {"mode": "fused", "granularity": "batch", "algorithm": "tpe", "seed": seed,
            "space_hash": space.space_hash()}


def _recs(path):
    with open(path) as f:
        return [json.loads(x) for x in f.read().splitlines()[1:]]


def _pick(path):
    return [{k: r[k] for k in FIELDS} for r in _recs(path)]


def _run(wl, path=None, **kw):
    led = None
    if path is not None:
        led = SweepLedger(str(path))
        led.ensure_header(_header(wl.default_space(), kw.get("seed", KW["seed"])))
    try:
        return fused_tpe(wl, ledger=led, device="cpu", **{**KW, **kw})
    finally:
        if led is not None:
            led.close()


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_tpe")
    wl = jax_get_workload("tabular_mlp")
    led = jstore.SweepLedger(str(d / "jax.jsonl"))
    led.ensure_header(_header(wl.default_space()))
    try:
        res = jax_fused_tpe(wl, ledger=led, **KW)
    finally:
        led.close()
    return res, d / "jax.jsonl"


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_tpe")
    return _run(get_workload("tabular_mlp"), d / "port.jsonl"), d / "port.jsonl"


def test_result_equals_jax_in_structure(jax_run, port_run):
    want, got = jax_run[0], port_run[0]
    assert set(got) == set(want)
    assert got["n_trials"] == want["n_trials"] == 10 and got["n_warm"] == want["n_warm"] == 0
    assert got["best_curve"].shape == want["best_curve"].shape == (3,)
    assert len(got["member_failures"]) == len(want["member_failures"]) == 3
    assert got["obs_unit"].shape == want["obs_unit"].shape == (10, 3)
    assert got["obs_scores"].shape == want["obs_scores"].shape == (10,)
    assert got["journal"] == want["journal"] == {"written": 10, "verified": 0}
    assert np.all(np.diff(got["best_curve"]) >= 0)  # the running best never falls
    assert got["best_score"] == got["best_curve"][-1] == got["obs_scores"].max()
    assert got["best_params"] == get_workload("tabular_mlp").default_space().materialize_row(
        got["obs_unit"][int(np.argmax(got["obs_scores"]))])


def test_ledger_equals_jax_in_structure(jax_run, port_run):
    j_recs, t_recs = _recs(jax_run[1]), _recs(port_run[1])
    assert [set(r) for r in t_recs] == [set(r) for r in j_recs]
    shape = lambda rs: [tuple(r[k] for k in SHAPE) for r in rs]
    assert shape(t_recs) == shape(j_recs)
    # generations of 4, 4 and 2 write the ring in order, at the budget
    assert [r["boundary"] for r in t_recs] == [0] * 4 + [1] * 4 + [2] * 2
    assert [r["member"] for r in t_recs] == list(range(10))
    assert {r["step"] for r in t_recs} == {2}
    # the ring holds each journaled suggestion and its score
    units = np.asarray([list(r["params"].values()) for r in t_recs])
    assert units.shape == (10, 3) and [r["score"] for r in t_recs] == [
        pytest.approx(float(s)) for s in port_run[0]["obs_scores"]]
    assert jstore.validate_ledger(str(port_run[1])) == []
    assert validate_ledger(str(port_run[1])) == []


def test_waves_equal_resident(port_run):
    """tabular_mlp (no member chunk) in waves of 3 (launches of one
    member: 3 >> 2) equals the resident sweep, records included."""
    wav = _run(get_workload("tabular_mlp"), port_run[1].parent / "waves.jsonl", wave_size=3)
    res = port_run[0]
    np.testing.assert_array_equal(wav["obs_unit"], res["obs_unit"])
    np.testing.assert_array_equal(wav["obs_scores"], res["obs_scores"])
    np.testing.assert_array_equal(wav["best_curve"], res["best_curve"])
    assert wav["launch_width"] == 1 and wav["waves_run"] == 5  # [2, 1] + [2, 1] + [2]
    assert _pick(port_run[1].parent / "waves.jsonl") == _pick(port_run[1])


def test_smallcnn_waves_with_a_member_chunk_equal_resident():
    """The SmallCNN in chunks of 2: waves of 2 over batches of 4 (and the
    remainder of 2) end in the resident ring, curve and best."""
    wl = small_workload()
    kw = dict(n_trials=6, batch=4, budget=2, seed=1, member_chunk=2)
    res = _run(wl, **kw)
    wav = _run(wl, wave_size=2, **kw)
    np.testing.assert_array_equal(wav["obs_unit"], res["obs_unit"])
    np.testing.assert_array_equal(wav["obs_scores"], res["obs_scores"])
    assert (wav["best_score"], wav["best_params"]) == (res["best_score"], res["best_params"])
    assert wav["wave_lens"] == [2] and wav["launch_width"] == 2


def test_oom_in_a_wave_replays_the_generation():
    """A synthetic device OOM in generation 1's second wave halves the
    cap and replays the generation from its drawn suggestions: the ring
    and the curve equal the unfaulted run's."""
    wl = get_workload("tabular_mlp")
    clean = _run(wl, wave_size=4, batch=8, n_trials=16)
    seen = {"n": 0}

    def fault(kind):
        if kind == "wave":
            seen["n"] += 1
            if seen["n"] == 2:
                raise resources.synthetic_resource_exhausted()

    resources.set_launch_fault_injector(fault)
    try:
        faulted = _run(wl, wave_size=4, batch=8, n_trials=16)
    finally:
        resources.set_launch_fault_injector(None)
    assert faulted["oom_backoffs"] == 1 and faulted["wave_size"] == 2
    assert faulted["launch_width"] == clean["launch_width"] == 1
    assert faulted["launch_shape_changed"] is False
    np.testing.assert_array_equal(faulted["obs_unit"], clean["obs_unit"])
    np.testing.assert_array_equal(faulted["obs_scores"], clean["obs_scores"])


def test_crash_and_resume_equals_the_unkilled_run(port_run, tmp_path):
    """A crash after generation 2's snapshot: the resume runs generation
    3 only, verifies nothing re-computed, and ends with the unkilled
    run's ring, curve, best and records."""
    wl = get_workload("tabular_mlp")
    ck = str(tmp_path / "ck")

    def crash(stage):
        if stage == "tpe generation 2/3":
            raise RuntimeError("simulated crash")

    resources.set_boundary_fault_injector(crash)
    try:
        with pytest.raises(RuntimeError, match="simulated"):
            _run(wl, tmp_path / "cut.jsonl", checkpoint_dir=ck)
    finally:
        resources.set_boundary_fault_injector(None)
    got = _run(wl, tmp_path / "cut.jsonl", checkpoint_dir=ck)
    want = port_run[0]
    np.testing.assert_array_equal(got["obs_unit"], want["obs_unit"])
    np.testing.assert_array_equal(got["obs_scores"], want["obs_scores"])
    np.testing.assert_array_equal(got["best_curve"], want["best_curve"])
    assert (got["best_score"], got["best_params"]) == (want["best_score"], want["best_params"])
    assert got["journal"] == {"written": 2, "verified": 0}
    assert _pick(tmp_path / "cut.jsonl") == _pick(port_run[1])


@pytest.mark.parametrize("change,match", [
    (dict(cfg=TPEConfig(gamma=0.5)), "cfg"),
    (dict(wave_size=2), "wave_size"),
])
def test_resume_refuses_another_sweep(tmp_path, change, match):
    wl = get_workload("tabular_mlp")
    ck = str(tmp_path / "ck")
    _run(wl, checkpoint_dir=ck, n_trials=4, batch=4)
    with pytest.raises(ValueError, match=match):
        _run(wl, checkpoint_dir=ck, n_trials=4, batch=4, **change)


@pytest.mark.parametrize("arg", ["mesh"])
def test_not_ported_arguments_raise(arg):
    # mesh= is ported: a 1 x 1 mesh (a world of one) runs the one-process
    # sweep bit for bit
    from mpi_opt_tpu_torch.parallel.mesh import Mesh

    wl = get_workload("tabular_mlp")
    want = fused_tpe(wl, n_trials=4, device="cpu")
    got = fused_tpe(wl, n_trials=4, device="cpu", **{arg: Mesh(1)})
    np.testing.assert_array_equal(got["obs_scores"], want["obs_scores"])
    np.testing.assert_array_equal(got["obs_unit"], want["obs_unit"])


def test_cli_tpe_journals_the_jax_header(tmp_path, capsys):
    led = tmp_path / "cli.jsonl"
    rc = cli.main(["--workload", "tabular_mlp", "--algorithm", "tpe", "--fused", "--trials", "10",
                   "--population", "4", "--budget", "2", "--seed", "0", "--device", "cpu",
                   "--ledger", str(led)])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["algorithm"] == "tpe" and summary["n_trials"] == 10
    assert len(summary["best_curve"]) == 3 and summary["journal"]["written"] == 10
    with open(led) as f:
        header = json.loads(f.readline())
    config = json.loads(header["config"]) if isinstance(header["config"], str) else header["config"]
    assert config["granularity"] == "batch" and config["algorithm"] == "tpe"
    assert (config["trials"], config["batch"], config["budget"]) == (10, 4, 2)
    assert jstore.validate_ledger(str(led)) == []

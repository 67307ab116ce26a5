"""The wave engine's parity and drills for both of the port's adapters,
fused PBT and fused SHA (mirrors the JAX package's
``tests/test_engine_drills.py``): SHA in waves equals SHA resident; an
injected device OOM at wave k, with budget left, halves the cap,
re-runs the interval and ends record-identical to a clean run; without
budget the ``DeviceOOM`` propagates; a crashed SHA wave sweep resumes
bit-identically; a wave snapshot is refused by a resident resume; a
resume adopts the OOM-settled cap. The OOM comes through the engine's
own seam, ``resources.launch_fault("wave")``, as a real
``torch.cuda.OutOfMemoryError``."""

import json

import numpy as np
import pytest
import torch

import mpi_opt_tpu_torch.train.fused_asha as fa
import mpi_opt_tpu_torch.train.fused_pbt as fp
from mpi_opt_tpu_torch import get_workload
from mpi_opt_tpu_torch.ledger import SweepLedger, validate_ledger
from mpi_opt_tpu_torch.utils import integrity, resources

SHA_KW = dict(n_trials=8, min_budget=2, max_budget=8, eta=2, seed=3, device="cpu")
PBT_KW = dict(population=8, generations=3, steps_per_gen=2, seed=2, device="cpu")
FIELDS = ("trial_id", "member", "boundary", "boundary_size", "params", "status", "score", "step")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clear_seams():
    resources.set_observer(lambda event, **fields: None)  # events, not warnings
    yield
    resources.set_launch_fault_injector(None)
    resources.clear_observer()


@pytest.fixture(scope="module")
def wl():
    return get_workload("fashion_mlp", n_train=256, n_val=128)


@pytest.fixture(scope="module")
def sha_resident(wl):
    return fa.fused_sha(wl, **SHA_KW)


class OOMAt:
    """Raise a synthetic CUDA OOM at the ``at``-th wave launch (1-based)."""

    def __init__(self, at: int):
        self.at, self.seen, self.fired = at, 0, 0

    def __call__(self, kind):
        if kind != "wave":
            return
        self.seen += 1
        if self.seen == self.at:
            self.fired += 1
            raise resources.synthetic_resource_exhausted()


def _ledger(path, space, algorithm, seed):
    led = SweepLedger(str(path))
    led.ensure_header({"mode": "fused", "granularity": "rung" if algorithm == "asha" else "generation",
                       "algorithm": algorithm, "seed": seed, "space_hash": space.space_hash()})
    return led


def _records(path):
    with open(path) as f:
        return [{k: r.get(k) for k in FIELDS} for r in map(json.loads, f.read().splitlines()[1:])]


def _assert_same_sha(got, want):
    np.testing.assert_array_equal(got["last_score"], want["last_score"])
    np.testing.assert_array_equal(got["stop_rung"], want["stop_rung"])
    assert got["best_score"] == want["best_score"]
    assert got["best_trial"] == want["best_trial"]
    assert got["best_params"] == want["best_params"]
    assert got["rung_history"] == want["rung_history"]
    assert got["member_failures"] == want["member_failures"]


@pytest.mark.parametrize("wave_size", [1, 3, 4])  # [1]*8, [3, 3, 2] and [4, 4]
def test_sha_wave_bit_identical_to_resident(wl, sha_resident, wave_size):
    wav = fa.fused_sha(wl, wave_size=wave_size, **SHA_KW)
    _assert_same_sha(wav, sha_resident)
    assert wav["rung_sizes"] == sha_resident["rung_sizes"] == [8, 4, 2]
    assert wav["rung_budgets"] == [2, 4, 8]
    assert wav["wave_size"] == wave_size and wav["staged_bytes"] > 0
    assert "wave_size" not in sha_resident  # the resident result's shape is the JAX one


def test_sha_journal_and_snapshots_do_not_change_the_result(wl, sha_resident, tmp_path):
    """The eager path (snapshots + journal, a fetch a rung) and the
    deferred one (one fetch after the last rung) give one result."""
    led = _ledger(tmp_path / "l.jsonl", wl.default_space(), "asha", SHA_KW["seed"])
    try:
        eager = fa.fused_sha(wl, checkpoint_dir=str(tmp_path / "ck"), ledger=led, **SHA_KW)
    finally:
        led.close()
    _assert_same_sha(eager, sha_resident)
    assert eager["journal"] == {"written": 8 + 4 + 2, "verified": 0}
    assert integrity._committed_steps(str(tmp_path / "ck")) == [1, 2, 3]
    assert validate_ledger(str(tmp_path / "l.jsonl")) == []


def test_sha_oom_backoff_record_identical(wl, tmp_path):
    """W=4: rung 1 runs waves 1-2, rung 2's one wave is launch 3. An OOM
    there halves the cap to 2 and re-runs THAT rung; the sweep ends with
    the clean run's results and ledger records."""
    space = wl.default_space()
    led_a = _ledger(tmp_path / "clean.jsonl", space, "asha", SHA_KW["seed"])
    try:
        clean = fa.fused_sha(wl, wave_size=4, ledger=led_a, **SHA_KW)
    finally:
        led_a.close()
    events = []
    resources.set_observer(lambda e, **f: events.append((e, f)))
    inj = OOMAt(3)
    resources.set_launch_fault_injector(inj)
    led_b = _ledger(tmp_path / "oom.jsonl", space, "asha", SHA_KW["seed"])
    try:
        faulted = fa.fused_sha(wl, wave_size=4, oom_backoff=2, ledger=led_b, **SHA_KW)
    finally:
        led_b.close()
    assert inj.fired == 1
    assert faulted["oom_backoffs"] == 1 and faulted["wave_size"] == 2
    assert [e for e, _ in events] == ["oom_backoff"]
    assert events[0][1]["rung"] == 2 and events[0][1]["wave_size"] == 2
    assert events[0][1]["remaining"] == 1 and "CUDA out of memory" in events[0][1]["error"]
    _assert_same_sha(faulted, clean)
    assert validate_ledger(led_b.path) == []
    assert _records(tmp_path / "clean.jsonl") == _records(tmp_path / "oom.jsonl")


@pytest.mark.parametrize("at", [1, 3, 4])
def test_pbt_oom_backoff_record_identical(wl, tmp_path, at):
    """W=4 over 8 members: two waves a generation. An OOM at wave launch
    ``at`` (gen 1 wave 1, gen 2 wave 1, gen 2 wave 2) halves the cap and
    re-runs that generation from its first wave."""
    space = wl.default_space()
    led_a = _ledger(tmp_path / "clean.jsonl", space, "pbt", PBT_KW["seed"])
    try:
        clean = fp.fused_pbt(wl, wave_size=4, ledger=led_a, **PBT_KW)
    finally:
        led_a.close()
    inj = OOMAt(at)
    resources.set_launch_fault_injector(inj)
    led_b = _ledger(tmp_path / "oom.jsonl", space, "pbt", PBT_KW["seed"])
    try:
        faulted = fp.fused_pbt(wl, wave_size=4, oom_backoff=2, ledger=led_b, **PBT_KW)
    finally:
        led_b.close()
    assert inj.fired == 1
    assert faulted["oom_backoffs"] == 1 and faulted["wave_size"] == 2
    assert faulted["wave_lens"] == [2, 2, 2, 2]
    np.testing.assert_array_equal(clean["best_curve"], faulted["best_curve"])
    np.testing.assert_array_equal(clean["unit"], faulted["unit"])
    assert clean["best_score"] == faulted["best_score"]
    assert clean["best_params"] == faulted["best_params"]
    for k, v in clean["state"].params.items():
        assert torch.equal(v, faulted["state"].params[k]), k
    assert validate_ledger(led_b.path) == []
    assert _records(tmp_path / "clean.jsonl") == _records(tmp_path / "oom.jsonl")


def test_pbt_repeated_oom_halves_twice(wl):
    clean = fp.fused_pbt(wl, wave_size=4, **PBT_KW)
    fired = {"n": 0}

    def twice(kind):
        if kind == "wave" and fired["n"] < 2:
            fired["n"] += 1
            raise resources.synthetic_resource_exhausted()

    resources.set_launch_fault_injector(twice)
    faulted = fp.fused_pbt(wl, wave_size=4, oom_backoff=2, **PBT_KW)
    assert faulted["oom_backoffs"] == 2 and faulted["wave_size"] == 1
    np.testing.assert_array_equal(clean["best_curve"], faulted["best_curve"])
    np.testing.assert_array_equal(clean["unit"], faulted["unit"])


@pytest.mark.parametrize("driver", ["sha", "pbt"])
def test_oom_without_budget_raises_typed(wl, driver):
    """``oom_backoff=0`` (or the budget spent): the typed DeviceOOM,
    carrying the cap in force, propagates for the CLI's exit 74."""
    resources.set_launch_fault_injector(OOMAt(1))
    with pytest.raises(resources.DeviceOOM) as exc:
        if driver == "sha":
            fa.fused_sha(wl, wave_size=4, oom_backoff=0, **SHA_KW)
        else:
            fp.fused_pbt(wl, wave_size=4, oom_backoff=0, **PBT_KW)
    assert exc.value.wave_size == 4


def test_oom_at_a_cap_of_one_raises_typed(wl):
    resources.set_launch_fault_injector(OOMAt(1))
    with pytest.raises(resources.DeviceOOM) as exc:
        fp.fused_pbt(wl, wave_size=1, oom_backoff=2, **PBT_KW)
    assert exc.value.wave_size == 1


def test_sha_wave_crash_resume_bit_identical(wl, tmp_path, monkeypatch):
    """W=4 over rungs of 8, 4, 2 members: 2 + 1 + 1 waves. A crash in
    rung 1's second wave: the resume (no snapshot yet) starts over; one
    in rung 2's wave: it restores rung 1's snapshot and re-trains only
    the interrupted rung."""
    whole = fa.fused_sha(wl, wave_size=4, **SHA_KW)
    real = fa._run_wave
    for crash_at, steps in ((2, []), (3, [1])):
        calls = {"n": 0}

        def crashing(*a, **k):
            calls["n"] += 1
            if calls["n"] == crash_at:
                raise RuntimeError("simulated worker crash")
            return real(*a, **k)

        ckpt = str(tmp_path / f"ck{crash_at}")
        monkeypatch.setattr(fa, "_run_wave", crashing)
        with pytest.raises(RuntimeError, match="simulated"):
            fa.fused_sha(wl, wave_size=4, checkpoint_dir=ckpt, **SHA_KW)
        monkeypatch.setattr(fa, "_run_wave", real)
        assert integrity._committed_steps(ckpt) == steps
        resumed = fa.fused_sha(wl, wave_size=4, checkpoint_dir=ckpt, **SHA_KW)
        _assert_same_sha(resumed, whole)
        assert resumed["waves_run"] == (2 if steps else 4)  # rungs 2 and 3: one wave each


def test_sha_resume_after_completion_runs_nothing(wl, tmp_path, monkeypatch):
    ckpt = str(tmp_path / "ck")
    first = fa.fused_sha(wl, wave_size=3, checkpoint_dir=ckpt, **SHA_KW)

    def boom(*a, **k):
        raise AssertionError("a completed sweep re-ran a wave")

    monkeypatch.setattr(fa, "_run_wave", boom)
    _assert_same_sha(fa.fused_sha(wl, wave_size=3, checkpoint_dir=ckpt, **SHA_KW), first)


def test_sha_wave_snapshot_refused_by_resident_resume(wl, tmp_path):
    waved, res = str(tmp_path / "waved"), str(tmp_path / "resident")
    fa.fused_sha(wl, wave_size=4, checkpoint_dir=waved, **SHA_KW)
    with pytest.raises(ValueError, match="different sweep"):
        fa.fused_sha(wl, checkpoint_dir=waved, **SHA_KW)
    fa.fused_sha(wl, checkpoint_dir=res, **SHA_KW)
    with pytest.raises(ValueError, match="different sweep"):
        fa.fused_sha(wl, wave_size=4, checkpoint_dir=res, **SHA_KW)


@pytest.mark.parametrize("driver", ["sha", "pbt"])
def test_wave_resume_adopts_settled_cap(wl, tmp_path, monkeypatch, driver):
    """The OOM-settled cap rides the snapshot (``wave_size_run``): a
    resume adopts it instead of paying the halving again, while the
    requested cap stays the config's identity."""
    ckpt = str(tmp_path / "ck")
    mod, kw = (fa, SHA_KW) if driver == "sha" else (fp, PBT_KW)
    run = mod.fused_sha if driver == "sha" else mod.fused_pbt
    resources.set_launch_fault_injector(OOMAt(1))
    real = mod._run_wave
    calls = {"n": 0}

    def crashing(*a, **k):
        calls["n"] += 1
        if calls["n"] == 6:  # after the first interval settled at cap 2
            raise RuntimeError("simulated crash after the backoff")
        return real(*a, **k)

    monkeypatch.setattr(mod, "_run_wave", crashing)
    with pytest.raises(RuntimeError, match="simulated"):
        run(wl, wave_size=4, oom_backoff=2, checkpoint_dir=ckpt, **kw)
    monkeypatch.setattr(mod, "_run_wave", real)
    resources.set_launch_fault_injector(None)
    whole = run(wl, wave_size=4, **kw)
    resumed = run(wl, wave_size=4, oom_backoff=2, checkpoint_dir=ckpt, **kw)
    assert resumed["wave_size"] == 2  # adopted, not re-learned
    assert resumed["oom_backoffs"] == 0
    assert resumed["best_params"] == whole["best_params"]
    assert resumed["best_score"] == whole["best_score"]

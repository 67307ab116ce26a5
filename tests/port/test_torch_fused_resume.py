"""Crash recovery of the port's fused PBT on the CPU (mirrors the JAX
package's ``tests/test_fused_resume.py`` by name where one exists): a
killed, drained or corrupted sweep resumes from its verified
launch-granular snapshots to the unkilled run's state digest, curves
and ledger records; the checkpoint config refuses another sweep; the
ledger refuses a lag or a divergence; ``step_chunk`` is bit-identical
to the unchunked sweep; a device OOM and a full disk are typed.

The model tests run a narrow SmallCNN (``torch_port_small``) and the
contract tests the MLP, as the JAX tests do, to stay fast.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

import mpi_opt_tpu_torch.train.fused_pbt as fp
from mpi_opt_tpu_torch import get_workload
from mpi_opt_tpu_torch.health import ShutdownGuard, SweepInterrupted
from mpi_opt_tpu_torch.ledger import LedgerError, SweepLedger, validate_ledger
from mpi_opt_tpu_torch.utils import integrity, resources
from mpi_opt_tpu_torch.utils.checkpoint import SweepCheckpointer
from torch_port_small import KW, small_workload

#: the journal's result fields (ts and sweep_id are wall-clock/random)
FIELDS = ("trial_id", "member", "boundary", "boundary_size", "params", "status", "score", "step")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """bf16 CPU convolutions on many threads of a CPU-quota'd host are
    slower than on one; the sweeps here are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clear_seams():
    yield
    resources.set_boundary_fault_injector(None)
    resources.set_launch_fault_injector(None)
    resources.set_disk_fault_injector(None)
    integrity.clear_observer()
    resources.clear_observer()


def _mlp():
    return get_workload("fashion_mlp", n_train=256, n_val=128)


def _state_digest(res):
    st = res["state"]
    return integrity.tree_digest({"params": st.params, "momentum": st.momentum, "step": st.step})


def _fault_at(n: int, exc=None):
    """A boundary-fault injector that raises at the n-th launch boundary
    (1-based), as a process killed there would stop."""
    calls = {"n": 0}

    def inject(stage):
        calls["n"] += 1
        if calls["n"] == n:
            raise exc if exc is not None else RuntimeError(f"simulated crash at {stage}")

    return inject


def _open_ledger(path, space):
    led = SweepLedger(str(path))
    led.ensure_header({"mode": "fused", "granularity": "generation", "algorithm": "pbt",
                       "seed": KW["seed"], "space_hash": space.space_hash()})
    return led


def _records(path):
    return [{k: r[k] for k in FIELDS} for r in (json.loads(x) for x in open(path).read().splitlines()[1:])]


def _assert_same_sweep(got, want):
    np.testing.assert_array_equal(got["best_curve"], want["best_curve"])
    np.testing.assert_array_equal(got["mean_curve"], want["mean_curve"])
    np.testing.assert_array_equal(got["unit"], want["unit"])
    assert got["best_score"] == want["best_score"]
    assert got["best_params"] == want["best_params"]
    assert got["member_failures"] == want["member_failures"]
    assert got["launch_gens"] == want["launch_gens"]
    assert len(got["launch_walls"]) == len(want["launch_gens"])
    assert _state_digest(got) == _state_digest(want)


@pytest.fixture(scope="module")
def cnn(tmp_path_factory):
    """The narrow SmallCNN workload, its unkilled sweep, and the ledger
    that sweep journaled."""
    wl = small_workload()
    clean = tmp_path_factory.mktemp("unkilled") / "clean.jsonl"
    led = _open_ledger(clean, wl.default_space())
    whole = fp.fused_pbt(wl, ledger=led, **KW)
    led.close()
    return wl, whole, clean


def test_crash_resume_bit_identical(tmp_path, cnn):
    wl, whole, _ = cnn
    ckpt = str(tmp_path / "ck")
    resources.set_boundary_fault_injector(_fault_at(2))  # dies after launch 2 of 4
    with pytest.raises(RuntimeError, match="simulated crash at pbt launch 2/4"):
        fp.fused_pbt(wl, checkpoint_dir=ckpt, **KW)
    resources.set_boundary_fault_injector(None)
    assert integrity._committed_steps(ckpt) == [1, 2]
    resumed = fp.fused_pbt(wl, checkpoint_dir=ckpt, **KW)
    _assert_same_sweep(resumed, whole)
    assert integrity._committed_steps(ckpt) == [2, 3, 4]  # keep=3


@pytest.mark.parametrize("crash_at,every,journal", [
    (2, 1, {"written": 8, "verified": 0}),
    # the journal holds generations 0-2, the snapshot 0-1: the resume
    # re-computes generation 2 and verifies it against the journal
    (3, 2, {"written": 4, "verified": 4}),
], ids=["snapshot_every_launch", "journal_ahead_of_snapshot"])
def test_pbt_crash_resume_journal_identical_to_unkilled(tmp_path, cnn, crash_at, every, journal):
    wl, whole, clean = cnn
    space = wl.default_space()
    assert whole["journal"] == {"written": 16, "verified": 0}
    killed, ckpt = tmp_path / "killed.jsonl", str(tmp_path / "ck")
    led = _open_ledger(killed, space)
    resources.set_boundary_fault_injector(_fault_at(crash_at))
    with pytest.raises(RuntimeError, match="simulated"):
        fp.fused_pbt(wl, checkpoint_dir=ckpt, snapshot_every=every, ledger=led, **KW)
    led.close()
    resources.set_boundary_fault_injector(None)
    led = _open_ledger(killed, space)
    resumed = fp.fused_pbt(wl, checkpoint_dir=ckpt, snapshot_every=every, ledger=led, **KW)
    led.close()
    assert resumed["journal"] == journal
    assert _records(killed) == _records(clean)
    assert validate_ledger(str(killed)) == []
    _assert_same_sweep(resumed, whole)


def test_drain_flushes_snapshot_and_resumes_identically(tmp_path, cnn):
    """SIGTERM before boundary 2 of a sweep that snapshots every 3
    launches: the handler only sets the flag; boundary 2 flushes an
    off-cadence snapshot and raises SweepInterrupted; the resume gives
    the unkilled sweep."""
    wl, whole, _ = cnn
    ckpt = str(tmp_path / "ck")
    led = _open_ledger(tmp_path / "l.jsonl", wl.default_space())

    def sigterm_at_2(stage, calls={"n": 0}):
        calls["n"] += 1
        if calls["n"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    resources.set_boundary_fault_injector(sigterm_at_2)
    with ShutdownGuard(), pytest.raises(SweepInterrupted) as exc:
        fp.fused_pbt(wl, checkpoint_dir=ckpt, snapshot_every=3, ledger=led, **KW)
    resources.set_boundary_fault_injector(None)
    assert (exc.value.signal, exc.value.at) == ("SIGTERM", "pbt launch 2/4")
    assert integrity._committed_steps(ckpt) == [2]
    led.close()
    led = _open_ledger(tmp_path / "l.jsonl", wl.default_space())
    resumed = fp.fused_pbt(wl, checkpoint_dir=ckpt, snapshot_every=3, ledger=led, **KW)
    led.close()
    assert resumed["journal"] == {"written": 8, "verified": 0}
    _assert_same_sweep(resumed, whole)


def test_shutdown_guard_first_signal_named_second_sigint_aborts():
    """The handler only sets the flag and names the first signal;
    repeated SIGTERM stays graceful, a SIGINT after it aborts, and the
    previous handlers come back on exit."""
    from mpi_opt_tpu_torch.health import shutdown

    before = signal.getsignal(signal.SIGTERM)
    with ShutdownGuard() as guard:
        assert not shutdown.requested()
        os.kill(os.getpid(), signal.SIGTERM)
        os.kill(os.getpid(), signal.SIGTERM)
        assert shutdown.requested() and shutdown.active_signal() == "SIGTERM"
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)
        assert guard.signal_name == "SIGTERM"
    assert signal.getsignal(signal.SIGTERM) is before
    assert not shutdown.requested()


def test_write_step_never_replaces_a_committed_step(tmp_path):
    """A step is committed once: saving it again raises before anything
    is written, and the committed step still verifies."""
    ck = SweepCheckpointer(str(tmp_path), {"k": 1})
    sweep = {"w": torch.arange(6, dtype=torch.float32)}
    ck.save(1, sweep, {"n": 1})
    with pytest.raises(FileExistsError):
        ck.save(1, {"w": torch.zeros(6)}, {"n": 2})
    assert integrity._committed_steps(str(tmp_path)) == [1]
    assert [d for d in os.listdir(tmp_path) if d.startswith(".")] == []
    got, meta = ck.restore()
    assert torch.equal(got["w"], sweep["w"]) and meta["n"] == 1


def test_launch_and_step_chunk_sub_launches_beat(tmp_path):
    """Every launch boundary beats, and with step_chunk every training
    sub-launch too, so a stall watchdog can be sized to one chunk."""
    from mpi_opt_tpu_torch.health import heartbeat

    path = str(tmp_path / "beat.json")
    heartbeat.configure(path)
    try:
        fp.fused_pbt(_mlp(), **dict(KW, steps_per_gen=5, step_chunk=2))
    finally:
        heartbeat.deconfigure()
    rec = heartbeat.read_beat(path)
    assert rec["beats"] == 4 * (3 + 1)  # 3 sub-launches and a boundary a generation
    assert rec["progress"] == {"stage": "pbt launch 4/4", "launch": 4, "of": 4}
    assert rec["pid"] == os.getpid() and rec["phase"] is None


def test_resume_after_completion_skips_all_launches(tmp_path, monkeypatch):
    wl = _mlp()
    ckpt = str(tmp_path / "ck")
    first = fp.fused_pbt(wl, checkpoint_dir=ckpt, **KW)

    def boom(*a, **k):
        raise AssertionError("completed sweep re-ran a launch")

    monkeypatch.setattr(fp, "_run_stepped_generation", boom)
    again = fp.fused_pbt(wl, checkpoint_dir=ckpt, **KW)
    _assert_same_sweep(again, first)
    assert again["launch_walls"] == first["launch_walls"]


def test_checkpoint_config_mismatch_raises(tmp_path):
    wl = _mlp()
    ckpt = str(tmp_path / "ck")
    fp.fused_pbt(wl, checkpoint_dir=ckpt, **KW)
    with pytest.raises(ValueError, match="different sweep.*seed"):
        fp.fused_pbt(wl, checkpoint_dir=ckpt, **dict(KW, seed=KW["seed"] + 1))
    with pytest.raises(ValueError, match="different sweep.*launch_lens"):
        fp.fused_pbt(wl, checkpoint_dir=ckpt, **dict(KW, gen_chunk=2))
    # the same snapshot, as a CUDA run would have written it, committed
    # as the newest step (a valid, verified step): its generator state
    # is another device's stream
    manifest, meta, sweep = integrity.read_step(ckpt, 4)
    meta["config"]["device"] = "cuda"
    integrity.write_step(ckpt, 5, sweep, meta, integrity.build_manifest({"meta": meta}, {"sweep": sweep}))
    with pytest.raises(ValueError, match="device: snapshot='cuda' vs run='cpu'"):
        fp.fused_pbt(wl, checkpoint_dir=ckpt, **KW)


def test_momentum_dtype_mismatch_refuses_resume(tmp_path, monkeypatch):
    wl = _mlp()
    ckpt = str(tmp_path / "ck")
    resources.set_boundary_fault_injector(_fault_at(1))
    with pytest.raises(RuntimeError, match="simulated"):
        fp.fused_pbt(wl, checkpoint_dir=ckpt, **KW)
    resources.set_boundary_fault_injector(None)
    monkeypatch.setenv("MPI_OPT_TPU_MOMENTUM_DTYPE", "bfloat16")
    with pytest.raises(ValueError, match="momentum_dtype"):
        fp.fused_pbt(wl, checkpoint_dir=ckpt, **KW)


def test_snapshot_last_false_skips_final_save(tmp_path):
    wl = _mlp()
    ckpt = str(tmp_path / "ck")
    fp.fused_pbt(wl, checkpoint_dir=ckpt, snapshot_every=2, snapshot_last=False, **KW)
    assert integrity._committed_steps(ckpt) == [2]
    assert sorted(os.listdir(os.path.join(ckpt, "2"))) == [
        integrity.COMMIT_MARKER, integrity.MANIFEST_FILE, integrity.META_FILE, integrity.SWEEP_FILE]


# -- step_chunk -----------------------------------------------------------------


def test_step_chunk_deterministic_and_bit_identical_to_unchunked():
    """One generator threads every draw, so (unlike the JAX package's
    folded sub-keys) a step-chunked sweep equals the unchunked one."""
    wl = _mlp()
    kw = dict(KW, steps_per_gen=5)
    whole = fp.fused_pbt(wl, **kw)
    for chunk in (2, 5, 7):
        _assert_same_sweep(fp.fused_pbt(wl, **dict(kw, step_chunk=chunk)), whole)


def test_step_chunk_crash_resume_identical(tmp_path, monkeypatch):
    wl = _mlp()
    kw = dict(KW, steps_per_gen=5, step_chunk=2)
    whole = fp.fused_pbt(wl, **kw)
    real = fp._run_stepped_generation
    calls = {"n": 0}

    def crashing(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("simulated crash")
        return real(*a, **k)

    ckpt = str(tmp_path / "ck")
    monkeypatch.setattr(fp, "_run_stepped_generation", crashing)
    with pytest.raises(RuntimeError, match="simulated"):
        fp.fused_pbt(wl, checkpoint_dir=ckpt, **kw)
    monkeypatch.setattr(fp, "_run_stepped_generation", real)
    _assert_same_sweep(fp.fused_pbt(wl, checkpoint_dir=ckpt, **kw), whole)


def test_step_chunk_changes_config_and_guards_resume(tmp_path):
    """step_chunk is recorded in the checkpoint config, as in the JAX
    package: a resume under another value is refused."""
    wl = _mlp()
    ckpt = str(tmp_path / "ck")
    fp.fused_pbt(wl, checkpoint_dir=ckpt, **KW)
    with pytest.raises(ValueError, match="step_chunk: snapshot=0 vs run=2"):
        fp.fused_pbt(wl, checkpoint_dir=ckpt, step_chunk=2, **KW)


def test_step_chunk_accepts_zero_steps_like_unchunked():
    wl = _mlp()
    kw = dict(KW, steps_per_gen=0)
    res = fp.fused_pbt(wl, step_chunk=2, **kw)
    assert len(res["best_curve"]) == 4
    _assert_same_sweep(res, fp.fused_pbt(wl, **kw))


def test_step_chunk_rejects_gen_chunk_combination():
    with pytest.raises(ValueError, match="ambiguous"):
        fp.fused_pbt(_mlp(), **dict(KW, gen_chunk=2, step_chunk=2))


# -- integrity: quarantine and walk-back -------------------------------------------


def test_corrupt_newest_step_quarantined_and_restore_walks_back(tmp_path):
    wl = _mlp()
    ckpt = str(tmp_path / "ck")
    whole = fp.fused_pbt(wl, checkpoint_dir=ckpt, **KW)
    assert integrity._committed_steps(ckpt) == [2, 3, 4]
    events = []
    integrity.set_observer(lambda event, **f: events.append((event, f["step"])))
    # one flipped byte in the newest step's tensors: it still decodes,
    # its digest no longer matches
    path = os.path.join(ckpt, "4", integrity.SWEEP_FILE)
    raw = bytearray(open(path, "rb").read())
    raw[-2000] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    assert integrity.verify_step(ckpt, 4)[0] == "corrupt"
    resumed = fp.fused_pbt(wl, checkpoint_dir=ckpt, **KW)
    _assert_same_sweep(resumed, whole)  # restored step 3, re-ran launch 4
    assert events == [("snapshot_corrupt", 4)]
    assert integrity.list_quarantined(ckpt) == [os.path.join(ckpt, "4.corrupt")]
    assert integrity._committed_steps(ckpt) == [2, 3, 4]


def test_no_verified_snapshot_raises(tmp_path):
    wl = _mlp()
    ckpt = str(tmp_path / "ck")
    fp.fused_pbt(wl, checkpoint_dir=ckpt, **KW)
    events = []
    integrity.set_observer(lambda event, **f: events.append(event))
    with open(os.path.join(ckpt, "4", integrity.SWEEP_FILE), "r+b") as f:
        f.truncate(100)  # undecodable
    os.remove(os.path.join(ckpt, "3", integrity.SWEEP_FILE))  # a file gone
    with open(os.path.join(ckpt, "2", integrity.META_FILE), "w") as f:
        f.write('{"config": {}, "launches_done": 2}')  # valid JSON, wrong digest
    with pytest.raises(integrity.NoVerifiedSnapshotError, match="3 step"):
        fp.fused_pbt(wl, checkpoint_dir=ckpt, **KW)
    assert events == ["snapshot_corrupt"] * 3
    assert len(integrity.list_quarantined(ckpt)) == 3


def test_journal_lagging_snapshot_is_refused(tmp_path):
    """A snapshot taken without a journal, resumed with a fresh one: the
    generations the snapshot records complete can never be journaled."""
    wl = _mlp()
    ckpt = str(tmp_path / "ck")
    resources.set_boundary_fault_injector(_fault_at(2))
    with pytest.raises(RuntimeError, match="simulated"):
        fp.fused_pbt(wl, checkpoint_dir=ckpt, **KW)
    resources.set_boundary_fault_injector(None)
    led = _open_ledger(tmp_path / "late.jsonl", wl.default_space())
    with pytest.raises(LedgerError, match="lags"):
        fp.fused_pbt(wl, checkpoint_dir=ckpt, ledger=led, **KW)
    led.close()


# -- resources: device OOM and a full disk -------------------------------------------


def test_device_oom_classification():
    assert resources.is_device_oom(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB"))
    assert resources.is_device_oom(RuntimeError("CUDA error: out of memory"))
    assert resources.is_device_oom(resources.synthetic_resource_exhausted())
    assert not resources.is_device_oom(RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to allocate"))
    assert not resources.is_device_oom(ValueError("CUDA out of memory"))
    assert not resources.is_device_oom(RuntimeError("host out of memory"))
    with pytest.raises(resources.DeviceOOM) as exc:
        with resources.oom_funnel():
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
    assert isinstance(exc.value.__cause__, torch.cuda.OutOfMemoryError)
    with pytest.raises(KeyError):
        with resources.oom_funnel():
            raise KeyError("not an OOM")


def test_device_oom_in_a_launch_is_typed(tmp_path):
    def oom_at_2(kind, calls={"n": 0}):
        calls["n"] += 1
        if calls["n"] == 2:
            raise resources.synthetic_resource_exhausted()

    resources.set_launch_fault_injector(oom_at_2)
    ckpt = str(tmp_path / "ck")
    with pytest.raises(resources.DeviceOOM, match="CUDA out of memory"):
        fp.fused_pbt(_mlp(), checkpoint_dir=ckpt, **KW)
    assert integrity._committed_steps(ckpt) == [1]  # state intact


def test_full_disk_prunes_once_then_parks(tmp_path):
    wl = _mlp()
    ckpt = str(tmp_path / "ck")
    events = []
    resources.set_observer(lambda event, **f: events.append((event, f["step"])))
    fails = {"left": 1}

    def enospc_once_at_3(op, path):
        if op == "snapshot_save" and len(integrity._committed_steps(path)) == 2 and fails["left"]:
            fails["left"] -= 1
            raise resources.storage_full_error(path, op)

    resources.set_disk_fault_injector(enospc_once_at_3)
    whole = fp.fused_pbt(wl, checkpoint_dir=ckpt, **KW)
    assert events == [("snapshot_pruned", 1)]  # the oldest, never the newest
    assert integrity._committed_steps(ckpt) == [2, 3, 4]

    def always(op, path):
        if op == "snapshot_save":
            raise resources.storage_full_error(path, op)

    resources.set_disk_fault_injector(always)
    other = str(tmp_path / "other")
    with pytest.raises(resources.StorageFull, match="no superseded"):
        fp.fused_pbt(wl, checkpoint_dir=other, **KW)
    assert integrity._committed_steps(other) == []
    assert not [d for d in os.listdir(other) if ".tmp" in d]  # no debris
    assert whole["best_curve"].shape == (4,)

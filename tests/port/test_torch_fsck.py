"""The port's ``fsck`` subcommand over its own snapshot layout, on sweeps
its CLI runs on the CPU.

A clean fused sweep audits clean, its ledger cross-checked, with the
JSON keys the JAX ``fsck`` prints. A corrupt step (a flipped byte in a
tensor of ``sweep.pt``), a torn step (no ``COMMIT`` marker) and a torn
ledger tail each exit 1 and name what they found; ``--repair``
quarantines or truncates, and ``--resume`` then restores the newest
verified step and ends in the unkilled run's records. ``--deep`` passes a
clean directory and catches a flipped byte in an archive entry that no
restore reads. A driver sweep's journal, and a Hyperband journal cut
back to its first bracket, fail the cross-check. Usage errors exit 2.
"""

import json
import os
import shutil
import struct
import zipfile

import pytest

import mpi_opt_tpu.utils.integrity as jintegrity
import mpi_opt_tpu_torch.cli as cli
from mpi_opt_tpu_torch.utils import integrity

FIELDS = ("trial_id", "member", "boundary", "boundary_size", "params", "status", "score", "step")


def _argv(d, *extra):
    return ["--workload", "fashion_mlp", "--algorithm", "pbt", "--fused", "--population", "4",
            "--generations", "4", "--steps-per-generation", "1", "--gen-chunk", "1", "--seed",
            "3", "--device", "cpu", "--checkpoint-dir", str(d / "ck"), "--ledger",
            str(d / "l.jsonl"), *extra]


@pytest.fixture(autouse=True)
def _small_data(monkeypatch):
    real = cli.get_workload
    monkeypatch.setattr(cli, "get_workload", lambda name: real(name, n_train=256, n_val=128))


@pytest.fixture
def sweep(tmp_path, capsys):
    """A finished fused PBT sweep (4 generations, a snapshot each, 3
    retained) with its ledger."""
    assert cli.main(_argv(tmp_path)) == 0
    capsys.readouterr()
    return tmp_path


def _records(path):
    with open(path) as f:
        return [{k: r[k] for k in FIELDS} for r in map(json.loads, f.read().splitlines()[1:])]


def _fsck(capsys, *argv):
    rc = cli.main(["fsck", *map(str, argv), "--json"])
    return rc, json.loads(capsys.readouterr().out)


def _flip(path, pick):
    """Flip one byte in the middle of the archive entry ``pick`` chooses
    from ``sweep.pt``'s entries."""
    with zipfile.ZipFile(path) as z:
        info = pick(z.infolist())
    data = bytearray(open(path, "rb").read())
    name_len, extra_len = struct.unpack("<HH", data[info.header_offset + 26:info.header_offset + 30])
    data[info.header_offset + 30 + name_len + extra_len + info.file_size // 2] ^= 0x01
    with open(path, "wb") as f:
        f.write(data)
    return info.filename


def _largest_tensor(infos):
    return max((i for i in infos if "/data/" in i.filename), key=lambda i: i.file_size)


def _serialization_id(infos):
    return next(i for i in infos if i.filename.endswith("serialization_id"))


def test_a_clean_sweep_audits_clean_with_the_jax_keys(sweep, tmp_path_factory, capsys):
    rc, rep = _fsck(capsys, sweep / "ck", "--ledger", sweep / "l.jsonl")
    assert rc == 0 and rep["ok"] is True
    assert [(s["root"], s["step"], s["status"]) for s in rep["steps"]] == [
        (".", 2, "verified"), (".", 3, "verified"), (".", 4, "verified")]
    assert rep["newest_verified"] == {"root": ".", "step": 4}
    assert rep["ledger"]["cross_checked"] is True and rep["ledger"]["problems"] == []
    # the JAX fsck's JSON, on a directory with no step, over the same ledger
    empty = tmp_path_factory.mktemp("empty")
    assert jintegrity.fsck_main([str(empty), "--ledger", str(sweep / "l.jsonl"), "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert set(rep) == set(want) and set(rep["ledger"]) == set(want["ledger"])
    assert {k for s in rep["steps"] for k in s} == {"root", "step", "status", "problems"}


def test_deep_passes_a_clean_directory(sweep, capsys):
    rc, rep = _fsck(capsys, sweep / "ck", "--deep")
    assert rc == 0 and {s["status"] for s in rep["steps"]} == {"verified"}


@pytest.mark.parametrize("damage", ["corrupt", "torn"])
def test_a_damaged_step_is_found_quarantined_and_resumed_past(sweep, damage, capsys):
    want = _records(sweep / "l.jsonl")
    step4 = sweep / "ck" / "4"
    if damage == "corrupt":
        _flip(step4 / integrity.SWEEP_FILE, _largest_tensor)
    else:
        os.remove(step4 / integrity.COMMIT_MARKER)
    rc, rep = _fsck(capsys, sweep / "ck", "--ledger", sweep / "l.jsonl")
    bad = [s for s in rep["steps"] if s["status"] != "verified"]
    assert rc == 1 and [(s["step"], s["status"]) for s in bad] == [(4, damage)]
    if damage == "torn":
        assert bad[0]["problems"] == ["uncommitted save (no COMMIT marker)"]
    assert rep["newest_verified"] == {"root": ".", "step": 3}
    rc, rep = _fsck(capsys, sweep / "ck", "--repair")
    assert rc == 1 and rep["repaired"] == ["4.corrupt"] and rep["quarantined"] == ["4.corrupt"]
    assert _fsck(capsys, sweep / "ck", "--ledger", sweep / "l.jsonl")[0] == 0
    # the resume restores step 3, re-trains generation 4 against its records
    assert cli.main(_argv(sweep, "--resume")) == 0
    capsys.readouterr()
    assert _records(sweep / "l.jsonl") == want


def test_a_torn_ledger_tail_is_found_and_truncated(sweep, capsys):
    with open(sweep / "l.jsonl", "a") as f:
        f.write('{"kind": "trial", "trial_id": 16, "mem')
    rc, rep = _fsck(capsys, sweep / "ck", "--ledger", sweep / "l.jsonl")
    assert rc == 1 and rep["ledger"]["torn_tail"] is True
    rc, rep = _fsck(capsys, sweep / "ck", "--ledger", sweep / "l.jsonl", "--repair")
    assert rc == 1 and rep["repaired"] == ["l.jsonl (torn tail truncated)"]
    rc, rep = _fsck(capsys, sweep / "ck", "--ledger", sweep / "l.jsonl")
    assert rc == 0 and rep["ledger"]["torn_tail"] is False


def test_deep_catches_a_byte_no_restore_reads(sweep, capsys):
    entry = _flip(sweep / "ck" / "4" / integrity.SWEEP_FILE, _serialization_id)
    assert _fsck(capsys, sweep / "ck")[0] == 0  # the digests verify what a restore reads
    rc, rep = _fsck(capsys, sweep / "ck", "--deep")
    bad = [s for s in rep["steps"] if s["status"] != "verified"]
    assert rc == 1 and [s["step"] for s in bad] == [4]
    assert bad[0]["problems"] == [f"sweep.pt: archive entry {entry!r} fails its CRC-32"]


def _cut_journal(src, dst, keep):
    with open(src) as f:
        lines = f.read().splitlines()
    dst.write_text("\n".join([lines[0]] + [x for x in lines[1:] if keep(json.loads(x))]) + "\n")
    return dst


@pytest.mark.parametrize("sweep_kind", ["driver", "hyperband"])
def test_a_journal_that_lags_its_snapshot_fails_the_audit(tmp_path, sweep_kind, capsys):
    argv = {"driver": ["--algorithm", "random", "--trials", "8", "--budget", "2",
                       "--population", "4"],
            "hyperband": ["--algorithm", "hyperband", "--fused", "--max-budget", "2",
                          "--eta", "2"]}[sweep_kind]
    assert cli.main(["--workload", "fashion_mlp", *argv, "--device", "cpu", "--checkpoint-dir",
                     str(tmp_path / "ck"), "--ledger", str(tmp_path / "l.jsonl")]) == 0
    capsys.readouterr()
    assert _fsck(capsys, tmp_path / "ck", "--ledger", tmp_path / "l.jsonl")[0] == 0
    # the driver's first 4 trials; bracket 0's two rungs of the Hyperband
    keep = {"driver": lambda r: r["trial_id"] < 4,
            "hyperband": lambda r: r["boundary"] < 2}[sweep_kind]
    cut = _cut_journal(tmp_path / "l.jsonl", tmp_path / "cut.jsonl", keep)
    rc, rep = _fsck(capsys, tmp_path / "ck", "--ledger", cut)
    assert rc == 1 and len(rep["ledger"]["problems"]) == 1
    assert ("absent from the journal" if sweep_kind == "driver" else "lags the snapshot") in (
        rep["ledger"]["problems"][0])


@pytest.mark.parametrize("argv", [[], ["no-such-dir"], ["ck", "--ledger"], ["ck", "--bogus"]])
def test_usage_errors_exit_2(argv, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "ck").mkdir()
    with pytest.raises(SystemExit) as exc:
        cli.main(["fsck", *argv])
    assert exc.value.code == 2
    capsys.readouterr()
    assert not os.listdir(tmp_path / "ck")


def test_a_sibling_ledger_is_schema_checked_only(sweep, capsys):
    shutil.copy(sweep / "l.jsonl", sweep / "only.jsonl")
    os.remove(sweep / "l.jsonl")
    rc, rep = _fsck(capsys, sweep / "ck")
    assert rc == 0 and rep["ledger"]["path"].endswith("only.jsonl")
    assert rep["ledger"]["cross_checked"] is False

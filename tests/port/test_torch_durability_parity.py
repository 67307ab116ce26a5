"""The port's durability layer against the JAX package's, bit-equal:
canonical params, snapshot digests (f32, int32 and bf16 leaves), fused
journal records, each package reading and verifying the other's
ledgers, and the exit-code contract.

The JAX side here is pure Python and numpy: no XLA program is
compiled. ``SearchSpace.materialize_row`` is the one JAX function a
journal calls that runs XLA ops, so both packages' journals are handed
the same rows materialised by the port (``_RowsView``); the two
packages' maps agree within one float32 ulp (``test_torch_space.py``),
and the journal logic under test is everything after them.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import mpi_opt_tpu.ledger.fused as jfused
import mpi_opt_tpu.ledger.store as jstore
import mpi_opt_tpu.space as js
import mpi_opt_tpu.utils.exitcodes as jexit
import mpi_opt_tpu.utils.integrity as jint
import mpi_opt_tpu_torch.ledger.fused as tfused
import mpi_opt_tpu_torch.ledger.store as tstore
import mpi_opt_tpu_torch.space as ts
import mpi_opt_tpu_torch.utils.exitcodes as texit
import mpi_opt_tpu_torch.utils.integrity as tint
from mpi_opt_tpu.ledger.report import summarize_ledger
from mpi_opt_tpu_torch import fused_pbt, get_workload

# wall-clock and per-ledger random fields: everything else must match
VOLATILE = {"ts", "sweep_id", "created_ts"}


def _cnn_spaces():
    from mpi_opt_tpu.workloads import get_workload as jax_get_workload

    return jax_get_workload("cifar10_cnn").default_space(), get_workload("cifar10_cnn").default_space()


def _mixed_spaces():
    doms = lambda m: {
        "lr": m.LogUniform(1e-4, 0.5),
        "layers": m.IntUniform(1, 6),
        "act": m.Choice(["relu", "gelu", True, 3]),
        "drop": m.Uniform(0.0, 0.5),
    }
    return js.SearchSpace(doms(js)), ts.SearchSpace(doms(ts))


# -- canonical params -------------------------------------------------------


@pytest.mark.parametrize("spaces", [_cnn_spaces, _mixed_spaces], ids=["cifar10_cnn", "mixed"])
def test_canonical_params_and_params_key_bytes_equal(spaces):
    j, t = spaces()
    rng = np.random.default_rng(0)
    for i in range(16):
        params = {}
        for name, dom in t.domains.items():
            if isinstance(dom, ts.Choice):
                params[name] = dom.options[i % len(dom.options)]
            elif isinstance(dom, ts.IntUniform):
                params[name] = np.int64(rng.integers(dom.low, dom.high + 1)) if i % 2 else int(dom.low)
            else:
                v = dom.low + (dom.high - dom.low) * rng.random()
                params[name] = np.float32(v) if i % 2 else float(v)
        # plumbing keys and keys of other spaces are dropped, reversed
        # insertion order is canonicalised
        params = {"__inherit_from__": 3, "other": 1.0, **dict(reversed(list(params.items())))}
        cj, ct = j.canonical_params(params), t.canonical_params(params)
        assert json.dumps(ct) == json.dumps(cj)
        assert [type(v) for v in ct.values()] == [type(v) for v in cj.values()]
        assert t.params_key(params) == j.params_key(params)
    missing = {t.names[0]: 0.1}
    with pytest.raises(KeyError):
        t.canonical_params(missing)
    with pytest.raises(KeyError):
        j.canonical_params(missing)


# -- digests ------------------------------------------------------------------


def _trees(seed=0):
    """(JAX-side tree of numpy/ml_dtypes arrays, port-side tree of the
    same values as torch tensors, bf16 built from the same bits)."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    bits = rng.integers(-(2**15), 2**15, size=(4, 3, 3), dtype=np.int16)
    np_tree = {
        "state": {
            "params": {"conv0.weight": f32(4, 3, 3, 8), "fc1.bias": f32(4, 16)},
            "momentum": {"conv0.weight": bits.view(ml_dtypes.bfloat16), "fc1.bias": f32(4, 16)},
            "step": np.arange(4, dtype=np.int32),
        },
        "unit": rng.random((4, 5), dtype=np.float32),
        "scores": np.float32(0.5) * np.ones(4, dtype=np.float32),
        "rng_state": rng.integers(0, 255, size=16, dtype=np.uint8),
    }

    def to_torch(x):
        if isinstance(x, dict):
            return {k: to_torch(v) for k, v in x.items()}
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(x))

    return np_tree, to_torch(np_tree)


def test_leaf_digest_equal_f32_int32_bf16():
    np_tree, t_tree = _trees()
    st_np, st_t = np_tree["state"], t_tree["state"]
    for np_leaf, t_leaf in [
        (st_np["params"]["conv0.weight"], st_t["params"]["conv0.weight"]),
        (st_np["momentum"]["conv0.weight"], st_t["momentum"]["conv0.weight"]),
        (st_np["step"], st_t["step"]),
        (np_tree["rng_state"], t_tree["rng_state"]),
    ]:
        want = jint._leaf_digest(np_leaf)
        assert tint._leaf_digest(t_leaf) == want
        if t_leaf.dtype != torch.bfloat16:
            assert tint._leaf_digest(np_leaf) == want
    assert t_tree["state"]["momentum"]["conv0.weight"].dtype == torch.bfloat16


@pytest.mark.parametrize("parallel", [False, True], ids=["serial", "threads"])
def test_tree_digest_and_manifest_equal(monkeypatch, parallel):
    np_tree, t_tree = _trees(1)
    if parallel:  # both packages' thread-pool paths
        monkeypatch.setattr(jint, "_PARALLEL_DIGEST_BYTES", 0)
        monkeypatch.setattr(tint, "_PARALLEL_DIGEST_BYTES", 0)
    want = jint.tree_digest(np_tree)
    assert tint.tree_digest(t_tree) == want
    assert tint.tree_digest(np_tree) == want
    meta = {"config": {"seed": 2, "launch_lens": [1, 1], "cfg": {"truncation_frac": 0.25}},
            "best": [[0.5], [0.625]], "launches_done": 2}
    assert tint.json_digest(meta) == jint.json_digest(meta)
    assert tint.build_manifest({"meta": meta}, {"sweep": t_tree}) == jint.build_manifest(
        {"meta": meta}, {"sweep": np_tree})
    # one flipped bf16 bit moves the digest
    t_tree["state"]["momentum"]["conv0.weight"].view(torch.int16)[0, 0, 0] ^= 1
    assert tint.tree_digest(t_tree) != want


def test_snapshot_step_digests_as_the_jax_package_would(tmp_path):
    """A step the port commits holds the tree it was given: its manifest
    verifies under the JAX package's digests of the same host arrays."""
    np_tree, t_tree = _trees(2)
    meta = {"config": {"seed": 0}, "launches_done": 1}
    manifest = tint.build_manifest({"meta": meta}, {"sweep": t_tree})
    tint.write_step(str(tmp_path), 1, t_tree, meta, manifest)
    assert tint._committed_steps(str(tmp_path)) == [1]
    m, meta_back, sweep = tint.read_step(str(tmp_path), 1)
    assert jint.verify_restored(m, {"meta": meta_back}, {"sweep": np_tree}) == []
    assert tint.verify_step(str(tmp_path), 1) == ("verified", [])
    # a numeric directory without the commit marker is debris, not a step
    os.makedirs(tmp_path / "2")
    (tmp_path / ".3.tmp99").mkdir()
    assert (tint._committed_steps(str(tmp_path)), tint._torn_steps(str(tmp_path))) == ([1], [2])


# -- journals -------------------------------------------------------------------


class _RowsView:
    """A package's search space, with rows materialised by the port's map."""

    def __init__(self, space, rows_from):
        self.canonical_params = space.canonical_params
        self.materialize_row = rows_from.materialize_row
        self.space_hash = space.space_hash


HEADER = {"mode": "fused", "granularity": "generation", "algorithm": "pbt",
          "workload": "cifar10_cnn", "backend": "fused", "seed": 0, "warm_start": None,
          "population": 3, "generations": 2, "steps_per_generation": 5}


def _journal(store, fused, path, space, spec):
    led = store.SweepLedger(str(path))
    led.ensure_header({**HEADER, "space_hash": space.space_hash()}, space_spec=spec)
    return led, fused.FusedJournal(led, space)


def _write_boundaries(journal, units):
    journal.record_boundary(0, [0, 1, 2], units[0], [0.5, float("nan"), 0.75], step=5)
    journal.record_boundary(1, [0, 1, 2], units[1], [0.625, 0.8125, 0.25], step=10)


def _lines(path):
    return [json.loads(x) for x in open(path).read().splitlines()]


def test_fused_journal_records_equal_field_by_field(tmp_path):
    j_space, t_space = _cnn_spaces()
    units = np.random.default_rng(3).random((2, 3, t_space.dim), dtype=np.float32)
    jl, jj = _journal(jstore, jfused, tmp_path / "jax.jsonl", _RowsView(j_space, t_space), j_space.spec())
    tl, tj = _journal(tstore, tfused, tmp_path / "port.jsonl", _RowsView(t_space, t_space), t_space.spec())
    _write_boundaries(jj, units)
    _write_boundaries(tj, units)
    jl.close()
    tl.close()
    assert (tj.written, tj.verified) == (jj.written, jj.verified) == (6, 0)
    j_recs, t_recs = _lines(tmp_path / "jax.jsonl"), _lines(tmp_path / "port.jsonl")
    assert len(t_recs) == len(j_recs) == 7
    for a, b in zip(t_recs, j_recs):
        assert list(a) == list(b)  # same keys, same order
        assert {k: v for k, v in a.items() if k not in VOLATILE} == {
            k: v for k, v in b.items() if k not in VOLATILE}
    assert t_recs[2]["status"] == "failed" and t_recs[2]["score"] is None


def _port_sweep_ledger(tmp_path):
    """A real port sweep (fashion_mlp, 4 members x 3 generations)
    journaled through the port's ledger."""
    wl = get_workload("fashion_mlp", n_train=256, n_val=128)
    space = wl.default_space()
    path = tmp_path / "sweep.jsonl"
    led = tstore.SweepLedger(str(path))
    led.ensure_header({**HEADER, "workload": "fashion_mlp", "population": 4, "generations": 3,
                       "steps_per_generation": 2, "space_hash": space.space_hash()},
                      space_spec=space.spec())
    res = fused_pbt(wl, population=4, generations=3, steps_per_gen=2, seed=1, gen_chunk=1,
                    ledger=led, device="cpu")
    led.close()
    return path, res


def test_jax_reader_reads_a_port_ledger(tmp_path):
    path, res = _port_sweep_ledger(tmp_path)
    assert res["journal"] == {"written": 12, "verified": 0}
    assert jstore.validate_ledger(str(path)) == []
    led = jstore.SweepLedger(str(path), read_only=True)
    assert (led.n_torn, led.n_torn_boundary, len(led.records)) == (0, 0, 12)
    by_b, sizes, problems, torn = jstore.scan_boundaries(led.records)
    assert (problems, torn, sorted(by_b), set(sizes.values())) == ([], None, [0, 1, 2], {4})
    rep = summarize_ledger(str(path))
    ok = [r for r in led.records if r["status"] == "ok"]
    best = max(ok, key=lambda r: r["score"])  # the first of equal maxima
    assert rep["best"] == {"trial_id": best["trial_id"], "score": best["score"],
                           "step": best["step"], "params": best["params"]}
    assert rep["fused"]["boundaries"] == 3 and rep["fused"]["member_records"] == 12
    # the last generation's journaled best is the sweep's best score
    assert max(r["score"] for r in ok if r["boundary"] == 2) == res["best_score"]
    # and the JAX journal verifies a re-computation of it
    by_b2 = {m: r for m, r in by_b[2].items()}
    jj = jfused.FusedJournal(led, None)
    jj.record_boundary(2, [0, 1, 2, 3], None, [by_b2[m]["score"] for m in range(4)], step=6)
    assert jj.verified == 4


def test_port_journal_verifies_against_a_jax_written_one(tmp_path):
    j_space, t_space = _cnn_spaces()
    units = np.random.default_rng(4).random((2, 3, t_space.dim), dtype=np.float32)
    jl, jj = _journal(jstore, jfused, tmp_path / "jax.jsonl", _RowsView(j_space, t_space), j_space.spec())
    _write_boundaries(jj, units)
    jl.close()
    # the port resumes the JAX-written journal: the same header is accepted,
    # re-computed boundaries verify instead of being written again
    led = tstore.SweepLedger(str(tmp_path / "jax.jsonl"))
    led.ensure_header({**HEADER, "space_hash": t_space.space_hash()}, space_spec=t_space.spec())
    tj = tfused.FusedJournal(led, t_space)
    tj.require_prefix(2)
    _write_boundaries(tj, units)
    assert (tj.written, tj.verified) == (0, 6)
    # a score within the JAX tolerance (rtol 1e-5, atol 1e-6) verifies, one
    # ulp of an accuracy on 2048 images does not
    tj.record_boundary(1, [0, 1, 2], units[1], [0.625 * (1 + 5e-6), 0.8125, 0.25], step=10)
    with pytest.raises(tstore.LedgerError, match="diverges"):
        tj.record_boundary(1, [0, 1, 2], units[1], [0.625 + 1 / 2048, 0.8125, 0.25], step=10)
    with pytest.raises(tstore.LedgerError, match="status"):
        tj.record_boundary(0, [0, 1, 2], units[0], [0.5, 0.3, 0.75], step=5)
    with pytest.raises(tstore.LedgerError, match="lags"):
        tj.require_prefix(3)
    led.close()
    assert len(_lines(tmp_path / "jax.jsonl")) == 7  # nothing was appended


def test_torn_tail_and_torn_boundary_heal_as_in_jax(tmp_path):
    """The two shapes an append-kill leaves, read by both packages: the
    torn final line and the torn final boundary are dropped on load, and
    both packages keep the same records."""
    path, _ = _port_sweep_ledger(tmp_path)
    lines = open(path).read().splitlines(keepends=True)
    # kill mid-boundary 2 (two of its four records written), mid-line
    with open(path, "w") as f:
        f.write("".join(lines[:-2]) + lines[-2][:17])
    for store in (jstore, tstore):
        _, recs, n_torn = store.read_ledger(str(path))
        assert n_torn == 1
        led = store.SweepLedger(str(path), read_only=True)
        assert (led.n_torn, led.n_torn_boundary, len(led.records)) == (1, 2, 8)
    led = tstore.SweepLedger(str(path))  # writable: repairs the file
    led.close()
    assert jstore.validate_ledger(str(path)) == []
    assert len(_lines(path)) == 9


# -- exit codes -----------------------------------------------------------------


def test_exit_codes_equal():
    names = ("EX_OK", "EX_FAILURE", "EX_USAGE", "EX_DATAERR", "EX_UNAVAILABLE", "EX_IOERR",
             "EX_TEMPFAIL", "EX_PROTOCOL")
    assert [getattr(texit, n) for n in names] == [getattr(jexit, n) for n in names]
    assert (texit.EX_DATAERR, texit.EX_IOERR, texit.EX_TEMPFAIL) == (65, 74, 75)
    assert [texit.classify(rc) for rc in range(-2, 130)] == [jexit.classify(rc) for rc in range(-2, 130)]
    assert tint.EX_DATAERR == jint.EX_DATAERR

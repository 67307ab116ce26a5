"""The port's ledger corpus (``mpi_opt_tpu_torch/corpus``) and
``--warm-start auto:DIR`` against the JAX package's, on ledgers the
port's CLI writes on the CPU and ledgers built by hand.

- ``fingerprint_from_spec``, ``fingerprint_from_records``,
  ``compat_score``, ``encode_record`` and ``fuzzy_observations`` give
  what the JAX functions give on the same spaces and records;
- ``build_index``/``index_corpus`` build the JAX package's document (one
  package reads the other's index), errored entries included, and the
  ``corpus index`` subcommand exits as the JAX one does;
- ``resolve`` gives the same observations, sources and skips: exact and
  fuzzy sources, the self-warm-start exclusion, a stale entry and a
  corrupt index degraded to skips, a ledger grown behind the index;
- ``--warm-start auto:DIR`` over a corpus whose one same-space ledger is
  the prior equals ``--warm-start PATH`` on the fused and the driver
  path (the same ``n_warm`` and records), and its event names the
  source; the ``auto`` usage errors are the JAX CLI's.
"""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest

import mpi_opt_tpu.corpus.index as jindex
import mpi_opt_tpu.corpus.match as jmatch
import mpi_opt_tpu.corpus.resolve as jresolve
import mpi_opt_tpu_torch.cli as cli
import mpi_opt_tpu_torch.workloads as tworkloads
from mpi_opt_tpu.space import LogUniform as JLogUniform
from mpi_opt_tpu.space import SearchSpace as JSearchSpace
from mpi_opt_tpu.space import Uniform as JUniform
from mpi_opt_tpu.workloads import get_workload as jax_get_workload
from mpi_opt_tpu_torch.corpus import index as cindex
from mpi_opt_tpu_torch.corpus import match
from mpi_opt_tpu_torch.corpus.resolve import resolve
from mpi_opt_tpu_torch.ledger import SweepLedger
from mpi_opt_tpu_torch.space import LogUniform, SearchSpace, Uniform
from mpi_opt_tpu_torch.trial import TrialResult

TPE = ["--workload", "fashion_mlp", "--algorithm", "tpe", "--trials", "8", "--population", "4",
       "--budget", "2", "--device", "cpu"]


def _small(real):
    def small(name, **kw):
        return real(name, n_train=256, n_val=128, **kw) if name == "fashion_mlp" else real(name, **kw)
    return small


def _cli(argv):
    """(exit code, JSON lines) of the port's CLI run in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    return rc, [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]


def _spaces(wide=False):
    """fashion_mlp's space in both packages; ``wide`` widens one bound
    (another hash, the same structure)."""
    hi = 2.0 if wide else 1.0
    port = SearchSpace({"lr": LogUniform(1e-3, hi), "momentum": Uniform(0.5, 0.99),
                        "weight_decay": LogUniform(1e-6, 1e-2), "flip_prob": Uniform(0.0, 0.5),
                        "shift": Uniform(0.0, 4.0)})
    jax = JSearchSpace({"lr": JLogUniform(1e-3, hi), "momentum": JUniform(0.5, 0.99),
                        "weight_decay": JLogUniform(1e-6, 1e-2), "flip_prob": JUniform(0.0, 0.5),
                        "shift": JUniform(0.0, 4.0)})
    return port, jax


POINTS = [  # (params, score, step) of the hand-built fuzzy ledger
    ({"lr": 0.01, "momentum": 0.9, "weight_decay": 1e-4, "flip_prob": 0.1, "shift": 1.0}, 0.05, 2),
    ({"lr": 0.1, "momentum": 0.6, "weight_decay": 1e-5, "flip_prob": 0.3, "shift": 2.0}, 0.07, 2),
    ({"lr": 0.5, "momentum": 0.7, "weight_decay": 1e-3, "flip_prob": 0.2, "shift": 0.5}, 0.04, 2),
    ({"lr": 1.5, "momentum": 0.8, "weight_decay": 1e-3, "flip_prob": 0.2, "shift": 0.5}, 0.09, 2),
]


def _fabricate(path, space, points, workload="fashion_mlp", spec=True):
    led = SweepLedger(str(path))
    led.ensure_header({"algorithm": "tpe", "workload": workload, "backend": "cpu", "seed": 1,
                       "space_hash": space.space_hash()}, space_spec=space.spec() if spec else None)
    for i, (params, score, step) in enumerate(points):
        led.record_trial(TrialResult(trial_id=i, score=score, step=step, wall_time=0.1),
                         space.canonical_params(params))
    led.close()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """``exact.jsonl`` (a port fused TPE ledger over fashion_mlp's space),
    ``fuzzy.jsonl`` (hand-built over a widened space: another hash, one
    record out of the live domain), ``inferred.jsonl`` (the same without
    a ``space_spec``, another workload) and ``other/tabular.jsonl`` (a
    port ledger of another workload and space)."""
    d = tmp_path_factory.mktemp("corpus")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "get_workload", _small(tworkloads.get_workload))
        rc, _ = _cli([*TPE, "--fused", "--seed", "0", "--ledger", str(d / "exact.jsonl")])
        assert rc == 0
        rc, _ = _cli(["--workload", "tabular_mlp", "--algorithm", "tpe", "--fused", "--trials",
                      "4", "--population", "2", "--budget", "2", "--device", "cpu", "--ledger",
                      str(d / "other" / "tabular.jsonl")])
        assert rc == 0
    wide, _ = _spaces(wide=True)
    _fabricate(d / "fuzzy.jsonl", wide, POINTS)
    _fabricate(d / "inferred.jsonl", wide, POINTS, workload="digits_mlp", spec=False)
    return d


def _same_obs(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x.unit), np.asarray(y.unit))
        assert (x.score, x.budget) == (y.score, y.budget)


def _same_resolution(port, jax):
    _same_obs(port.observations, jax.observations)
    assert (port.sources, port.skips, port.skipped) == (jax.sources, jax.skips, jax.skipped)


# -- fingerprints and fuzzy matching -------------------------------------------


def test_fingerprints_and_compat_equal_jax(corpus):
    records = [json.loads(x) for x in (corpus / "exact.jsonl").read_text().splitlines()[1:]]
    assert match.fingerprint_from_records(records) == jmatch.fingerprint_from_records(records)
    for wide in (False, True):
        port, jax = _spaces(wide)
        assert match.fingerprint_from_spec(port.spec()) == jmatch.fingerprint_from_spec(jax.spec())
    live, jlive = _spaces()
    for other in (_spaces(True)[0], SearchSpace({"lr": LogUniform(1e-3, 1.0)}),
                  SearchSpace({"alpha": Uniform(0, 1)})):
        fp = match.fingerprint_from_spec(other.spec())
        assert match.compat_score(live.spec(), fp) == jmatch.compat_score(jlive.spec(), fp)
    inferred = match.fingerprint_from_records(records)
    assert match.compat_score(live.spec(), inferred) == jmatch.compat_score(jlive.spec(), inferred) == 1.0


def test_encode_record_and_fuzzy_observations_equal_jax():
    live, jlive = _spaces()
    records = [{"params": p, "score": s, "step": st, "status": "ok"} for p, s, st in POINTS]
    records += [{"params": POINTS[0][0], "score": None, "step": 2, "status": "failed"},
                {"params": {"lr": 0.1}, "score": 0.1, "step": 2, "status": "ok"},
                {"params": POINTS[1][0], "score": float("nan"), "step": 2, "status": "ok"}]
    for rec in records:
        a, b = match.encode_record(live, rec), jmatch.encode_record(jlive, rec)
        assert (a is None) == (b is None) and (a is None or np.array_equal(a, b))
    for keep in (0.5, 1.0, 0.25):
        obs, skipped = match.fuzzy_observations(live, records, keep_frac=keep)
        jobs, jskipped = jmatch.fuzzy_observations(jlive, records, keep_frac=keep)
        _same_obs(obs, jobs)
        assert skipped == jskipped and all(o.budget == 0 for o in obs)


# -- the index ---------------------------------------------------------------


def test_index_equals_jax_and_each_reads_the_other(corpus, tmp_path):
    d = tmp_path / "c"
    shutil.copytree(corpus, d)
    (d / "bad.jsonl").write_text('{"kind": "header", "version": 1, "config": {}}\nnot json\nalso not\n')
    doc = cindex.build_index(str(d))
    assert doc == jindex.build_index(str(d))
    assert [os.path.basename(e["path"]) for e in doc["entries"]] == [
        "bad.jsonl", "exact.jsonl", "fuzzy.jsonl", "inferred.jsonl", "tabular.jsonl"]
    assert doc["entries"][0]["error"] and doc["entries"][1]["ok"] == 8
    written = cindex.index_corpus(str(d))
    assert jindex.read_index(str(d)) == written
    # incremental: unchanged ledgers carry over in either package
    assert jindex.build_index(str(d), prior=written) == cindex.build_index(str(d), prior=written)
    for garbage in ("{torn", '{"entries": [], "version": null}', '{"entries": [], "version": 99}'):
        with open(cindex.index_path(str(d)), "w") as f:  # sweeplint: disable=corpus-index-write -- forges the damaged index a reader must survive
            f.write(garbage)
        assert cindex.read_index(str(d)) is None is jindex.read_index(str(d))
    # the subcommand: an unreadable entry is recorded, and the operator sees red
    from mpi_opt_tpu.corpus.cli import corpus_main as jax_corpus_main

    outs = []
    for main in (cli.main, lambda a: jax_corpus_main(a[1:])):
        for extra in (["--json"], []):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                outs.append((main(["corpus", "index", str(d), *extra]), buf.getvalue()))
    assert outs[:2] == outs[2:]
    assert [rc for rc, _ in outs[:2]] == [0, 1] and "UNREADABLE" in outs[1][1]


# -- resolution --------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "workload", "exclude", "stale", "corrupt", "grown"])
def test_resolve_equals_jax(corpus, tmp_path, case):
    d = tmp_path / "c"
    shutil.copytree(corpus, d)
    live, jlive = _spaces()
    kw = {"workload": None if case == "plain" else "fashion_mlp"}
    if case == "exclude":
        kw["exclude"] = str(d / "." / "exact.jsonl")
    if case in ("stale", "grown"):
        cindex.index_corpus(str(d))
    if case == "stale":
        os.unlink(d / "fuzzy.jsonl")
    if case == "corrupt":
        with open(cindex.index_path(str(d)), "w") as f:  # sweeplint: disable=corpus-index-write -- forges the torn index resolution must degrade over
            f.write("{half a docu")
    if case == "grown":
        led = SweepLedger(str(d / "exact.jsonl"))
        led.record_trial(TrialResult(trial_id=99, score=0.99, step=2, wall_time=0.0),
                         live.canonical_params(POINTS[0][0]))
        led.close()
    events = {"port": [], "jax": []}

    class Spy:
        def __init__(self, key):
            self.key = key

        def log(self, event, **f):
            events[self.key].append((event, f))

    port = resolve(live, str(d), metrics=Spy("port"), **kw)
    jax = jresolve.resolve(jlive, str(d), metrics=Spy("jax"), **kw)
    _same_resolution(port, jax)
    assert events["port"] == events["jax"]
    kinds = [s["match"] for s in port.sources]
    assert kinds == {"plain": ["exact"], "workload": ["exact", "fuzzy"], "exclude": ["fuzzy"],
                     "stale": ["exact"], "corrupt": ["exact", "fuzzy"],
                     "grown": ["exact", "fuzzy"]}[case]
    if case == "grown":
        assert max(o.score for o in port.observations) == 0.99


# -- --warm-start auto:DIR ---------------------------------------------------


@pytest.mark.parametrize("path", ["fused", "driver"])
def test_auto_warm_start_equals_manual_and_names_the_source(corpus, tmp_path, monkeypatch, path):
    """A corpus whose one same-space ledger is ``exact.jsonl`` (the other
    ledger is another workload's): ``auto:DIR`` ingests what naming the
    file ingests, and the sweep journals the same records."""
    monkeypatch.setattr(cli, "get_workload", _small(tworkloads.get_workload))
    d = tmp_path / "c"
    d.mkdir()
    shutil.copy(corpus / "exact.jsonl", d / "exact.jsonl")
    shutil.copytree(corpus / "other", d / "other")
    fused = ["--fused"] if path == "fused" else []
    runs = {}
    for name, warm in (("auto", f"auto:{d}"), ("manual", str(d / "exact.jsonl"))):
        rc, lines = _cli([*TPE, *fused, "--seed", "3", "--warm-start", warm, "--ledger",
                          str(tmp_path / f"{name}.jsonl")])
        assert rc == 0
        runs[name] = lines
    keep = ("trial_id", "params", "status", "score", "step", "member", "boundary")

    def records(name):
        with open(tmp_path / f"{name}.jsonl") as f:
            return [{k: r.get(k) for k in keep} for r in map(json.loads, f.read().splitlines()[1:])]

    assert records("auto") == records("manual")
    ws = {k: next(x for x in v if x.get("event") == "warm_start") for k, v in runs.items()}
    assert ws["auto"]["observations"] == ws["manual"]["observations"] == 8
    assert [(s["match"], os.path.basename(s["path"])) for s in ws["auto"]["sources"]] == [
        ("exact", "exact.jsonl")]
    assert ws["auto"]["path"] == f"auto:{d}"


@pytest.mark.parametrize("spec", ["auto", "auto:", "auto:nope"])
def test_auto_usage_errors_equal_jax(tmp_path, spec, capsys):
    import mpi_opt_tpu.cli as jcli

    warm = spec if spec != "auto:nope" else f"auto:{tmp_path}/nope"
    argv = ["--workload", "fashion_mlp", "--algorithm", "tpe", "--fused", "--trials", "4",
            "--population", "2", "--budget", "1", "--warm-start", warm, "--ledger",
            str(tmp_path / "own.jsonl")]
    errs = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (jcli.main, ["--no-mesh"])):
        with pytest.raises(SystemExit) as e:
            main([*argv, *extra])
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1])
    assert errs[0] == errs[1]
    assert not (tmp_path / "own.jsonl").exists()


def test_corpus_resolve_cli_equals_jax(corpus):
    from mpi_opt_tpu.corpus.cli import corpus_main as jax_corpus_main

    outs = []
    for main in (lambda a: cli.main(["corpus", *a]), jax_corpus_main):
        for extra in (["--json"], []):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main(["resolve", str(corpus), "--workload", "fashion_mlp", *extra]) == 0
            outs.append(buf.getvalue())
    assert outs[:2] == outs[2:]
    rep = json.loads(outs[0])
    assert rep["observations"] == 10 and [s["match"] for s in rep["sources"]] == ["exact", "fuzzy"]
    assert jax_get_workload("fashion_mlp").default_space().space_hash() == rep["space_hash"]

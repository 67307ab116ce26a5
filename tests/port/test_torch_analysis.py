"""The port's lint (``mpi_opt_tpu_torch/analysis``, ``obs/events.py``)
against the JAX package's sweeplint: the same findings on the same
sources for the shared checks, the same directives, baselines, JSON
schema and project summary, and torch's own host-sync and key-reuse."""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import pytest

from mpi_opt_tpu.analysis import all_checkers as jax_all_checkers
from mpi_opt_tpu.analysis import core as jax_core
from mpi_opt_tpu.analysis import project as jax_project
from mpi_opt_tpu.analysis.cli import lint_main as jax_lint_main
from mpi_opt_tpu.obs import events as jax_events
from mpi_opt_tpu_torch.analysis import all_checkers
from mpi_opt_tpu_torch.analysis import core
from mpi_opt_tpu_torch.analysis.checkers_torch import HostSyncChecker, KeyReuseChecker
from mpi_opt_tpu_torch.analysis.cli import default_paths, lint_main, repo_root
from mpi_opt_tpu_torch.obs import events

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TORCH_IDS = ("key-reuse", "host-sync")
HOT = "mpi_opt_tpu_torch/train/fused_x.py"

_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _checker(factory, check_id):
    (c,) = [c for c in factory() if c.id == check_id]
    return c


def _both(check_id, src, path):
    """(JAX findings, port findings) of one check over one source."""
    src = textwrap.dedent(src)
    return (jax_core.check_source(src, path=path, checkers=[_checker(jax_all_checkers, check_id)]),
            core.check_source(src, path=path, checkers=[_checker(all_checkers, check_id)]))


def _same(jax_f, port_f):
    assert [(f.check, f.line, f.severity) for f in port_f] == [
        (f.check, f.line, f.severity) for f in jax_f]
    for a, b in zip(jax_f, port_f):
        if "mpi_opt_tpu" not in a.message + b.message:
            assert a.message == b.message


# (id, path, true positive, true negative) for each check both packages
# share; resource-funnel's shared rule is the errno one
SHARED = [
    ("exit-code", "pkg/x.py",
     "import sys\ndef bail():\n    sys.exit(75)\nok = rc == 65\n",
     "import sys\nfrom pkg.utils.exitcodes import EX_TEMPFAIL\ndef bail():\n"
     "    sys.exit(EX_TEMPFAIL)\nn = len((1, 2)) == 2\n"),
    ("journal-order", "pkg/train/x.py",
     "def run(snap, journal):\n    for g in range(3):\n        snap.save(g, sweep={})\n"
     "        journal_boundary(journal, g, [], [], [], step=1)\n",
     "def run(snap, journal):\n    for g in range(3):\n"
     "        journal_boundary(journal, g, [], [], [], step=1)\n        snap.save(g, sweep={})\n"),
    ("ledger-gate", "pkg/somewhere.py",
     "led = SweepLedger('/tmp/x.jsonl')\n",
     "led = SweepLedger(path, read_only=rank != 0)\n"),
    ("atomic-write", "pkg/x.py",
     "import json\ndef out(dest, recs):\n    with open(dest, 'w') as f:\n        json.dump(recs, f)\n",
     "import json, os\ndef out(path, obj):\n    tmp = path + '.tmp'\n    with open(tmp, 'w') as f:\n"
     "        json.dump(obj, f)\n    os.replace(tmp, path)\n"),
    ("ledger-fsync", "pkg/ledger/store.py",
     "class L:\n    def _write_line(self, rec):\n        self._file.write(rec)\n        self._file.flush()\n",
     "import os\nclass L:\n    def _write_line(self, rec):\n        self._file.write(rec)\n"
     "        self._file.flush()\n        os.fsync(self._file.fileno())\n"),
    ("drain-swallow", "pkg/x.py",
     "try:\n    go()\nexcept (ValueError, SweepInterrupted):\n    log()\n",
     "try:\n    go()\nexcept BaseException:\n    cleanup()\n    raise\n"),
    ("event-registry", "pkg/x.py",
     "metrics.log('totally_new_event', x=1)\nwith trace.span('train', no_such_attr=1):\n    pass\n",
     "metrics.log('summary', x=1)\nwith trace.span('train', launch=1):\n    pass\nlog('bare')\n"),
    ("lease-write", "pkg/service/scheduler.py",
     "import os\ndef sneak(tmp, lease_path):\n    os.replace(tmp, lease_path)\n",
     "import os\ndef rel(released):\n    os.unlink(released)\n"),
    ("coord-write", "pkg/launch.py",
     "import os\ndef scrub(tmp, coord_dir):\n    os.replace(tmp, coord_dir + '/READY.json')\n"
     "    os.unlink(coord_dir + '/READY.json')\n",
     "import os\ndef read(coordinator, log_path):\n    with open(log_path, 'w') as f:\n"
     "        f.write(coordinator)\n"),
    ("corpus-index-write", "pkg/corpus/resolve.py",
     "import os\ndef sneak(tmp, d):\n    os.replace(tmp, d + '/corpus-index.json')\n",
     "import json\ndef read(corpus_index_path):\n    with open(corpus_index_path) as f:\n"
     "        return json.load(f)\n"),
    ("resource-funnel", "pkg/x.py",
     "import errno\nfrom errno import EDQUOT\ndef full(e):\n    return e.errno == errno.ENOSPC\n",
     "from pkg.utils.resources import is_storage_full\ndef full(e):\n    return is_storage_full(e)\n"),
    ("fsync-before-rename", "pkg/service/spool.py",
     "import json, os\ndef put(path, obj):\n    tmp = path + '.tmp'\n    with open(tmp, 'w') as f:\n"
     "        json.dump(obj, f)\n    os.replace(tmp, path)\n",
     "import json, os\ndef put(path, obj):\n    tmp = path + '.tmp'\n    with open(tmp, 'w') as f:\n"
     "        json.dump(obj, f)\n        f.flush()\n        os.fsync(f.fileno())\n    os.replace(tmp, path)\n"),
    ("http-handler-contained", "pkg/service/http.py",
     "class H(BaseHTTPRequestHandler):\n    def do_GET(self):\n        self.send_response(200)\n"
     "    def do_POST(self):\n        try:\n            go()\n        except ValueError:\n            pass\n",
     "class H(BaseHTTPRequestHandler):\n    def do_GET(self):\n        '''Doc.'''\n        try:\n"
     "            self.send_response(200)\n        except Exception:\n            self.send_error(500)\n"),
    ("guarded-by", "pkg/x.py",
     "import threading\n_LOCK = threading.Lock()\n_COUNT = 0\ndef _worker():\n    global _COUNT\n"
     "    _COUNT += 1\ndef start():\n    threading.Thread(target=_worker).start()\ndef reset():\n"
     "    global _COUNT\n    _COUNT = 0\n",
     "import threading\n_LOCK = threading.Lock()\n_COUNT = 0  # sweeplint: guarded-by(_LOCK)\n"
     "def _worker():\n    global _COUNT\n    with _LOCK:\n        _COUNT += 1\ndef start():\n"
     "    threading.Thread(target=_worker).start()\ndef reset():\n    global _COUNT\n    with _LOCK:\n"
     "        _COUNT = 0\n"),
    ("beat-path-nonblocking", "pkg/x.py",
     "import threading\n_LOCK = threading.Lock()\ndef hook(stage):\n    with _LOCK:\n        pass\n"
     "def wire():\n    set_slice_hook(hook)\n",
     "import threading\n_LOCK = threading.Lock()\ndef hook(stage):\n"
     "    if _LOCK.acquire(blocking=False):\n        _LOCK.release()\ndef wire():\n    set_slice_hook(hook)\n"),
    ("signal-safety", "pkg/x.py",
     "import signal, threading\n_LOCK = threading.Lock()\ndef _h(signum, frame):\n    with _LOCK:\n"
     "        pass\ndef install():\n    signal.signal(signal.SIGTERM, _h)\n",
     "import signal\n_FLAG = False\ndef _h(signum, frame):\n    global _FLAG\n    _FLAG = True\n"
     "def install():\n    signal.signal(signal.SIGTERM, _h)\n"),
    ("lock-order", "pkg/x.py",
     "import threading\n_A = threading.Lock()\n_B = threading.Lock()\ndef one():\n    with _A:\n"
     "        with _B:\n            pass\ndef two():\n    with _B:\n        with _A:\n            pass\n",
     "import threading\n_A = threading.Lock()\n_B = threading.Lock()\ndef one():\n    with _A:\n"
     "        with _B:\n            pass\ndef two():\n    with _A:\n        with _B:\n            pass\n"),
]


def test_the_shared_ids_are_the_jax_ids_but_torch_s_two():
    assert [c.id for c in all_checkers()] == [c.id for c in jax_all_checkers()]
    shared = [c.id for c in all_checkers() if c.id not in TORCH_IDS]
    assert [s[0] for s in SHARED] == shared and len(shared) == 17


@pytest.mark.parametrize("check_id,path,tp,tn", SHARED, ids=[s[0] for s in SHARED])
def test_shared_check_fixtures_equal_the_jax_findings(check_id, path, tp, tn):
    jax_f, port_f = _both(check_id, tp, path)
    assert port_f, "the true positive must fire"
    assert {f.check for f in port_f} == {check_id}
    _same(jax_f, port_f)
    jax_f, port_f = _both(check_id, tn, path)
    assert jax_f == [] and port_f == []


# -- the torch checks -------------------------------------------------------


def _port(checker, src, path=HOT):
    return core.check_source(textwrap.dedent(src), path=path, checkers=[checker])


@pytest.mark.parametrize("call,kind", [
    ("x.item()", ".item()"), ("x.tolist()", ".tolist()"), ("x.cpu()", ".cpu()"),
    ("x.numpy()", ".numpy()"), ("torch.cuda.synchronize()", ".synchronize()"),
    ("ev.synchronize()", ".synchronize()"), ("x.to('cpu')", '.to("cpu")'),
    ("x.to(device='cpu')", '.to("cpu")'), ("np.asarray(x)", "np.asarray"),
])
def test_host_sync_flags_torch_spellings_in_the_hot_path(call, kind):
    src = f"import numpy as np\nimport torch\ndef step(x, ev):\n    return {call}\n"
    (f,) = _port(HostSyncChecker(), src)
    assert f.check == "host-sync" and f.line == 4 and f.message.startswith(kind + " forces")
    # outside train/fused_*.py and train/staging.py: not this check's business
    assert _port(HostSyncChecker(), src, path="mpi_opt_tpu_torch/driver.py") == []
    assert _port(HostSyncChecker(), src, path="mpi_opt_tpu_torch/train/staging.py")


def test_host_sync_barriers_and_nested_defs():
    src = """
    def boundary(x):  # sweeplint: barrier(journal: scores to the host)
        s = x.tolist()
        def inner(y):
            return y.cpu()
        return s, inner
    def hot(x, y):
        a = x.to(y.device)
        b = x.item(0)
        # sweeplint: barrier(the slice is reused)
        x.synchronize()
        y.synchronize()  # sweeplint: barrier(the copy left)
        c = a + b
        return c, x.numpy()
    """
    # the annotated def's direct body passes; its nested def is judged on
    # its own; a barrier on a call's line or the line above passes that
    # call (a barrier comment covers its own line and the next); .to(<device>)
    # and .item(<arg>) are not syncs
    assert sorted((f.line, f.message.split()[0]) for f in _port(HostSyncChecker(), src)) == [
        (5, ".cpu()"), (14, ".numpy()")]


def test_host_sync_barrier_on_a_decorated_def():
    src = """
    @functools.cache  # sweeplint: barrier(built once)
    def table(x):
        return x.cpu()
    """
    assert _port(HostSyncChecker(), src) == []


@pytest.mark.parametrize("src,line,head", [
    ("import torch\nx = torch.randn(3)\n", 2, "torch.randn without generator="),
    ("import torch\nx = torch.randint(0, 4, (3,), device='cuda')\n", 2, "torch.randint without"),
    ("import torch\nx = torch.rand_like(y)\n", 2, "torch.rand_like without"),
    ("import torch\nx = torch.multinomial(p, 2)\n", 2, "torch.multinomial without"),
    ("w.uniform_(-1, 1)\n", 1, ".uniform_() without"),
    ("torch.nn.init.normal_(w)\n", 1, ".normal_() without"),
    ("import torch\ntorch.manual_seed(0)\n", 2, "torch.manual_seed seeds"),
    ("import torch\ntorch.cuda.manual_seed_all(s)\n", 2, "torch.cuda.manual_seed_all seeds"),
    ("def f(seed):\n    a = torch.Generator()\n    a.manual_seed(seed)\n    b = torch.Generator()\n"
     "    b.manual_seed(seed)\n", 5, "seed 'seed' fed to manual_seed again (first use line 3)"),
])
def test_key_reuse_flags_streams_the_seed_does_not_give(src, line, head):
    (f,) = _port(KeyReuseChecker(), src, path="mpi_opt_tpu_torch/ops/x.py")
    assert f.check == "key-reuse" and f.line == line and f.message.startswith(head)


def test_key_reuse_true_negatives():
    src = """
    import numpy as np
    import torch
    def draws(gen, n, kw, seed, flag):
        a = torch.randn(n, generator=gen)
        b = torch.randint(0, 4, (n,), generator=gen, device=gen.device)
        c = torch.rand(n, **kw)  # the splat may carry the generator
        w = torch.empty(n).uniform_(-1, 1, generator=gen)
        d = np.random.normal(size=n)  # numpy's stream: not torch's
        g1, g2 = torch.Generator(), torch.Generator()
        if flag:  # a balanced if/else seeds once an arm
            g1.manual_seed(seed)
        else:
            g2.manual_seed(seed)
        g1.manual_seed(seed)
        seed = seed + 1  # a rebind between two seeds
        g2.manual_seed(seed)
        g3 = torch.Generator().manual_seed(int(seed))  # computed seeds are not judged
        return a, b, c, w, d, g3
    """
    assert _port(KeyReuseChecker(), src) == []


# -- directives, baselines, the CLI ----------------------------------------


DIRECTIVES = """
import sys
import threading
_LOCK = threading.Lock()
_N = 0  # sweeplint: guarded-by(_LOCK)
sys.exit(75)  # sweeplint: disable=exit-code -- a drill
# sweeplint: disable=exit-code,atomic-write -- next line too
sys.exit(65)
sys.exit(2)  # sweeplint: disable=atomic-write
def f(x):  # sweeplint: barrier(host loop)
    return x.item()
def g(x):
    return x.item()
def _worker():
    global _N
    _N += 1
def start():
    threading.Thread(target=_worker).start()
def reset():
    global _N
    with _LOCK:
        _N = 0
"""


def test_directives_parse_and_act_alike():
    a = jax_core.FileContext.parse(HOT, DIRECTIVES)
    b = core.FileContext.parse(HOT, DIRECTIVES)
    assert (a.disabled, a.barriers, a.guards) == (b.disabled, b.barriers, b.guards)
    # exit-code suppressed on its line and the line above, per id;
    # host-sync's .item() (a sync in both packages) exempted by the barrier;
    # the guarded-by write outside its lock flagged in both
    jax_f = jax_core.check_source(DIRECTIVES, path=HOT)
    port_f = core.check_source(DIRECTIVES, path=HOT)
    assert [(f.check, f.line) for f in port_f] == [
        ("exit-code", 9), ("host-sync", 13), ("guarded-by", 16)]
    _same(jax_f, port_f)


def _exit_tree(tmp_path):
    (tmp_path / "legacy.py").write_text("import sys\nsys.exit(75)\nsys.exit(65)\n")
    (tmp_path / "newer.py").write_text("import sys\nsys.exit(69)\n")
    return str(tmp_path)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_baseline_of_one_package_splits_the_other_s_findings_alike(tmp_path, writer):
    root = _exit_tree(tmp_path)
    jax_f, _n, _e = jax_core.run_paths([root], [_checker(jax_all_checkers, "exit-code")])
    port_f, _n, _e = core.run_paths([root], [_checker(all_checkers, "exit-code")])
    base = str(tmp_path / "baseline.json")
    accepted_src = [f for f in (jax_f if writer == "jax" else port_f) if f.file.endswith("legacy.py")]
    (jax_core if writer == "jax" else core).write_baseline(base, accepted_src, root)
    for mod, found in ((jax_core, jax_f), (core, port_f)):
        fresh, accepted = mod.split_baselined(found, mod.load_baseline(base), root)
        assert [(f.file, f.line) for f in accepted] == [(os.path.join(root, "legacy.py"), 2),
                                                       (os.path.join(root, "legacy.py"), 3)]
        assert [(f.file, f.line) for f in fresh] == [(os.path.join(root, "newer.py"), 2)]


def _json_report(main, argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out)


def test_lint_json_schema_equals_the_jax_output(tmp_path, capsys):
    bad = tmp_path / "legacy.py"
    bad.write_text("import sys\nsys.exit(75)\n")
    rc_j, jax_rep = _json_report(jax_lint_main, [str(bad), "--json"], capsys)
    rc_p, port_rep = _json_report(lint_main, [str(bad), "--json"], capsys)
    assert rc_j == rc_p == 1
    assert set(port_rep) == set(jax_rep)
    assert [c["id"] for c in port_rep["checks"]] == [c["id"] for c in jax_rep["checks"]]
    assert [c["id"] for c in port_rep["checks"]] == [*chip_smoke.LINT_CHECKS, "project-table"]
    assert [set(c) for c in port_rep["checks"]] == [set(c) for c in jax_rep["checks"]]
    (fj,), (fp,) = jax_rep["findings"], port_rep["findings"]
    assert set(fp) == set(fj)
    assert {k: fp[k] for k in ("check", "file", "line", "severity", "message")} == {
        k: fj[k] for k in ("check", "file", "line", "severity", "message")}
    assert fp["hint"] == "import the named constant from mpi_opt_tpu_torch.utils.exitcodes"
    assert set(port_rep["project"]) == set(jax_rep["project"])


def test_lint_exit_codes_and_baseline_flow(tmp_path, capsys):
    root = _exit_tree(tmp_path)
    base = str(tmp_path / "b.json")
    assert lint_main([root, "--write-baseline", base]) == 0
    assert lint_main([root, "--baseline", base]) == 0
    assert "OK: 2 file(s), 0 finding(s), 3 baselined" in capsys.readouterr().err
    (tmp_path / "broken.py").write_text("def f(:\n")
    assert lint_main([root, "--write-baseline", base]) == 1
    assert "refusing to write a baseline" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        lint_main([str(tmp_path / "nope")])
    assert exc.value.code == 2


# -- the port's tree ----------------------------------------------------------


@pytest.fixture(scope="module")
def tree_lints():
    """One lint of the port's default paths by each package: the port's
    as a user runs it (``python -m mpi_opt_tpu_torch lint --json``, in a
    subprocess that reports whether it imported torch or jax), the JAX
    package's in this process meanwhile."""
    proc = subprocess.Popen([sys.executable, "-c", chip_smoke._LINT_PROBE, "--json"], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    jax_run = jax_core.run_paths_ex(default_paths())
    out, err = proc.communicate(timeout=300)
    return {"rc": proc.returncode, "report": json.loads(out),
            "probe": json.loads(err.strip().splitlines()[-1]), "jax": jax_run}


def test_default_paths_are_the_port_s_tree():
    assert repo_root() == ROOT
    assert default_paths() == [os.path.join(ROOT, "mpi_opt_tpu_torch"), os.path.join(ROOT, "chip_smoke.py")]


def test_the_port_s_tree_is_clean_under_both_packages(tree_lints):
    rep = tree_lints["report"]
    assert tree_lints["rc"] == 0 and tree_lints["probe"]["rc"] == 0
    assert rep["ok"] is True and rep["errors"] == [] and rep["findings"] == []
    findings, n_files, errors, _table = tree_lints["jax"]
    assert findings == [] and errors == []
    assert rep["files_scanned"] == n_files > 100


def test_lint_imports_neither_torch_nor_jax(tree_lints):
    assert tree_lints["probe"]["torch"] is False
    assert tree_lints["probe"]["jax"] is False


def test_the_project_summaries_are_equal(tree_lints):
    *_rest, table = tree_lints["jax"]
    want = json.loads(json.dumps(jax_project.summary(table, ROOT)))
    got = tree_lints["report"]["project"]
    assert got == want
    assert len(got["locks"]) >= 17 and got["signal_handlers"] and got["thread_entries"]
    assert got["lock_order"]["cycles"] == []


def test_a_planted_tree_gives_equal_findings_for_the_shared_ids(tmp_path):
    want = chip_smoke.plant_lint_faults(str(tmp_path))
    assert {w[0] for w in want} == {c.id for c in all_checkers()
                                    if not isinstance(c, core.ProjectChecker)}

    def found(findings):
        return {(f.check, os.path.relpath(f.file, tmp_path), f.line) for f in findings}

    port_f, n, errors = core.run_paths([str(tmp_path)])
    jax_f, _n, _e = jax_core.run_paths([str(tmp_path)])
    assert errors == [] and n == len(chip_smoke.LINT_PLANTS)
    assert found(port_f) == want
    # the shared ids agree but for the CUDA OOM catch, which only the
    # port's resource-funnel knows
    oom = ("resource-funnel", "mpi_opt_tpu_torch/planted_oom.py", 9)
    assert oom in want
    assert found(f for f in jax_f if f.check not in TORCH_IDS) == {
        w for w in want if w[0] not in TORCH_IDS and w != oom}


# -- the event/span registry ----------------------------------------------------


def test_the_registry_tables_equal_the_jax_tables():
    assert events.EVENTS == jax_events.EVENTS
    # the JAX tables plus the port's own step-phase spans, none of them a
    # JAX name
    assert events.SPANS == jax_events.SPANS | events.PORT_SPANS
    assert events.PORT_SPANS and events.PORT_SPANS.isdisjoint(jax_events.SPANS)
    assert events.SPAN_ATTRS == jax_events.SPAN_ATTRS
    assert events.is_event("summary") and not events.is_event("no_such")
    assert events.is_span("train") and events.is_span_attr("launch")


def test_the_registry_shims_scan_the_port_as_the_jax_ones_do():
    pkg = os.path.join(ROOT, "mpi_opt_tpu_torch")
    assert events.lint(pkg) == [] == jax_events.lint(pkg)
    sites = set(events.scan_call_sites(pkg))
    assert sites == set(jax_events.scan_call_sites(pkg))
    kinds = {(k, n) for _p, _l, k, n in sites}
    assert {("event", "summary"), ("event", "stall"), ("span", "train"), ("span", "stage_out")} <= kinds

"""The port's sweep service (``mpi_opt_tpu_torch/service``) against the
JAX package's, on the CPU (``serve --platform cpu``; the server passes
``--device cpu`` to every slice).

- The tenant state machine over every exit code, ``check_argv`` over
  every reserved flag and its abbreviations (and ``--device``, which
  only the port reserves), ``program_key`` over a set of argvs, the
  pick order on one spool, lease acquire/refresh/fence/takeover on the
  same files, the spool fault schedules and the stream idle fraction
  equal the JAX package's, called live (none of them compiles anything).
- One spool serves both packages: a job the port submits is admitted
  and reported by the JAX ``Spool`` and ``_collect_status``, and the
  reverse; ``report`` over a state dir prints what the JAX report prints.
- Three tiny ``fashion_mlp`` tenants time-sliced at every boundary end
  with their solo runs' ledger records; the shape-matching second tenant
  is a program-cache hit. A SIGTERM mid-slice parks the tenant and a
  restarted server finishes it; so does a SIGKILL-shaped death (a
  ``running`` tenant behind a dead server), through a lease takeover.
- The shutdown guard's slice side: a slice request is scoped to its
  guard, and a real signal outranks the slice label.
"""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import time

import pytest

import mpi_opt_tpu.service.leases as jleases
import mpi_opt_tpu.service.spool as jspool
import mpi_opt_tpu.service.tenants as jtenants
import mpi_opt_tpu_torch.cli as cli
import mpi_opt_tpu_torch.workloads as tworkloads
from mpi_opt_tpu_torch.health import shutdown
from mpi_opt_tpu_torch.service import leases, service_main
from mpi_opt_tpu_torch.service import tenants as tstates
from mpi_opt_tpu_torch.service.scheduler import SweepService
from mpi_opt_tpu_torch.service.spool import RESERVED_FLAGS, Spool, SpoolError, check_argv
from mpi_opt_tpu_torch.utils.metrics import MetricsLogger

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FUSED = ["--workload", "fashion_mlp", "--algorithm", "pbt", "--fused", "--population", "4",
         "--generations", "3", "--steps-per-generation", "2", "--gen-chunk", "1"]


def _records(path, fused=True):
    """A ledger's result fields (``sweep_id`` and ``ts`` differ by run)."""
    keep = ("trial_id", "params", "status", "score", "step")
    if fused:
        keep += ("member", "boundary", "boundary_size")
    with open(path) as f:
        return [{k: r[k] for k in keep} for r in map(json.loads, f.read().splitlines()[1:])]


@pytest.fixture
def small_mlp(monkeypatch):
    """fashion_mlp at 256 training and 128 validation images, for the
    server's program cache and the solo CLI runs alike."""
    real = tworkloads.get_workload

    def small(name, **kw):
        return real(name, n_train=256, n_val=128, **kw) if name == "fashion_mlp" else real(name, **kw)

    monkeypatch.setattr(tworkloads, "get_workload", small)
    monkeypatch.setattr(cli, "get_workload", small)


def _service(state_dir, **kw):
    kw.setdefault("drain_on_empty", True)
    kw.setdefault("poll_seconds", 0.02)
    kw.setdefault("device", "cpu")
    kw.setdefault("metrics", MetricsLogger(path=os.path.join(str(state_dir), "server-metrics.jsonl")))
    return SweepService(str(state_dir), **kw)


def _solo(argv, path):
    """The same argv as a solo CLI run on the CPU, journaled at ``path``."""
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        assert cli.main([*argv, "--device", "cpu", "--ledger", str(path)]) == 0
    return _records(path)


def _events(state_dir, name):
    with open(os.path.join(str(state_dir), "server-metrics.jsonl")) as f:
        return [r for r in map(json.loads, f.read().splitlines()) if r.get("event") == name]


# -- the tenant state machine, the guard's slice side ----------------------


@pytest.mark.parametrize("rc", [0, 1, 2, 3, 65, 69, 74, 75, 76, 124, 137, 139, -9, -15])
@pytest.mark.parametrize("cancel", [False, True])
def test_tenant_state_machine_equals_jax(rc, cancel):
    assert tstates.after_slice(rc, cancel) == jtenants.after_slice(rc, cancel)
    for name in ("QUEUED", "RUNNING", "PARKED", "DONE", "FAILED", "CANCELLED", "DATA_ERROR",
                 "TERMINAL", "RUNNABLE"):
        assert getattr(tstates, name) == getattr(jtenants, name)


def test_slice_request_is_guard_scoped():
    # no guard active: a slice request has nothing to drain
    assert shutdown.request() is False
    with shutdown.ShutdownGuard() as g:
        assert shutdown.request() is True
        assert g.requested and g.signal_name == shutdown.SLICE
        assert shutdown.requested()
    # the request died with its guard: nothing leaks to the next sweep
    assert not shutdown.requested()


def test_real_signal_outranks_slice_label():
    shutdown.clear_delivered()
    with shutdown.ShutdownGuard() as g:
        shutdown.request()
        g._handle(signal.SIGTERM, None)
        assert g.signal_name == "SIGTERM"  # the platform's signal wins the label
    assert shutdown.delivered_signal() == "SIGTERM"
    shutdown.clear_delivered()
    assert shutdown.delivered_signal() is None


# -- the spool, both ways ---------------------------------------------------


def _abbreviations(flag):
    return [flag[:n] for n in range(3, len(flag) + 1)]


@pytest.mark.parametrize("flag", sorted({a for f in jspool.RESERVED_FLAGS for a in _abbreviations(f)}))
def test_check_argv_equals_jax_on_every_reserved_flag(flag):
    """Every reserved flag and its abbreviations (argparse resolves
    them), bare and as ``--flag=value``: refused by both or by neither."""
    for argv in (["--workload", "fashion_mlp", flag, "x"], ["--workload", "fashion_mlp", f"{flag}=x"]):
        outcomes = []
        for check, err in ((check_argv, SpoolError), (jspool.check_argv, jspool.SpoolError)):
            try:
                check(argv)
                outcomes.append("ok")
            except err:
                outcomes.append("refused")
        assert outcomes[0] == outcomes[1], (argv, outcomes)


@pytest.mark.parametrize("flag", _abbreviations("--device"))
def test_device_and_its_abbreviations_are_server_owned(flag):
    """The one deliberate difference: the port's CLI has --device, which
    the server owns like --platform (the JAX CLI has no such flag)."""
    assert "--device" in RESERVED_FLAGS and "--device" not in jspool.RESERVED_FLAGS
    for argv in (["--workload", "fashion_mlp", flag, "cpu"], [f"{flag}=cpu"]):
        with pytest.raises(SpoolError, match="server-owned --device"):
            check_argv(argv)
        jspool.check_argv(argv)  # the JAX CLI has no --device to reserve


@pytest.mark.parametrize("submitter", ["port", "jax"])
def test_one_spool_serves_both_packages(tmp_path, submitter):
    """A job one package submits is admitted by the other's ``Spool``, and
    both ``_collect_status`` give the same report of the spool."""
    from mpi_opt_tpu.service.client import _collect_status as jax_status
    from mpi_opt_tpu_torch.service.client import _collect_status as port_status

    mine, theirs = (Spool(str(tmp_path)), jspool.Spool(str(tmp_path)))
    if submitter == "jax":
        mine, theirs = theirs, mine
    a = mine.submit(FUSED, tenant="alice", priority=2, deadline_ts=time.time() + 60)
    b = mine.submit(FUSED, tenant="bob")
    queued = [port_status(Spool(str(tmp_path), create=False)),
              jax_status(jspool.Spool(str(tmp_path), create=False))]
    assert queued[0] == queued[1] and [j["job"] for j in queued[0]["jobs"]] == [a, b]
    t = theirs.admit(os.path.join(str(tmp_path), "queue", f"{a}.json"))
    assert t.job_id == a and t.job["argv"] == FUSED
    theirs.cancel(b)
    after = [port_status(Spool(str(tmp_path), create=False)),
             jax_status(jspool.Spool(str(tmp_path), create=False))]
    assert after[0] == after[1]
    assert [(j["job"], j["state"]) for j in after[0]["jobs"]] == [(a, "queued"), (b, "cancelled")]
    assert after[0]["jobs"][0]["priority"] == 2


# -- leases -------------------------------------------------------------------


def _ident(pkg, sid):
    return pkg.ServerIdentity.local(sid)


@pytest.mark.parametrize("holder", ["port", "jax"])
def test_leases_acquire_refresh_fence_takeover_equal_jax(tmp_path, holder):
    hold, other = (leases, jleases) if holder == "port" else (jleases, leases)
    path = str(tmp_path / "lease.json")
    lease = hold.acquire(path, _ident(hold, "a"), ttl_s=60.0)
    assert lease is not None
    # a live lease of either package blocks the other's acquire
    assert other.acquire(path, _ident(other, "b"), ttl_s=60.0) is None
    for pkg in (leases, jleases):
        assert pkg.held(path, lease) and not pkg.expired(pkg.read_lease(path))
        assert not pkg.holder_dead(pkg.read_lease(path))
    lease = hold.refresh(path, lease, 60.0)
    assert lease["refreshes"] == 1 and other.held(path, lease)
    # a holder provably dead on this host: both judge the lease expired,
    # and the other package takes it over; the dead holder is fenced
    dead = dict(lease, pid=2**22 + 7919, pid_start=None)
    os.unlink(path)
    assert hold.acquire(path, _ident(hold, "a"), ttl_s=60.0) is not None
    os.unlink(path)
    with open(path, "w") as f:
        json.dump(dead, f)
    assert leases.holder_dead(dead) == jleases.holder_dead(dead) is True
    assert leases.expired(dead) == jleases.expired(dead) is True
    new = other.acquire(path, _ident(other, "b"), ttl_s=60.0)
    assert new is not None and new["server_id"] == "b"
    for pkg, fenced in ((leases, leases.LeaseFenced), (jleases, jleases.LeaseFenced)):
        assert not pkg.held(path, dead)
        with pytest.raises(fenced):
            pkg.check_fence(path, dead)
        assert pkg.release(path, dead) is False  # a stale releaser never unlinks the new lease
    assert hold.held(path, new) and hold.release(path, new) and not os.path.exists(path)
    # an expired deadline alone (a live pid) is judged the same way
    stale = dict(new, expires_ts=time.time() - 1.0)
    assert leases.expired(stale) == jleases.expired(stale) is True


# -- program_key, the pick order -----------------------------------------------


@pytest.mark.parametrize("argv", [
    FUSED,
    [*FUSED, "--seed", "7"],
    [*FUSED, "--member-chunk", "2"],
    [*FUSED, "--gen-chunk", "3"],
    [*FUSED, "--wave-size", "2"],
    ["--workload", "fashion_mlp", "--algorithm", "asha", "--fused", "--trials", "16",
     "--min-budget", "2", "--max-budget", "18", "--eta", "3"],
    ["--workload", "tabular_mlp", "--algorithm", "tpe", "--fused", "--trials", "8",
     "--population", "4", "--budget", "2"],
    ["--workload", "cifar10_cnn", "--algorithm", "pbt", "--fused", "--population", "32",
     "--generations", "4", "--steps-per-generation", "20", "--truncation", "0.5"],
    ["--workload", "quadratic", "--algorithm", "random", "--trials", "6", "--workers", "2"],
    ["--workload", "fashion_mlp", "--algorithm", "bohb", "--fused", "--n-pop", "2", "--no-mesh"],
    "warm", "warm-other",
])
def test_program_key_equals_jax(tmp_path, argv):
    """The same tuple as the JAX package's for the same argv, with the
    backend given explicitly (the port's default is gpu, the JAX CLI's
    cpu), and the warm-start split: two priors of different size give
    two keys."""
    from mpi_opt_tpu.cli import build_parser as jax_parser
    from mpi_opt_tpu.service.programs import program_key as jax_key
    from mpi_opt_tpu_torch.service.programs import program_key

    if argv in ("warm", "warm-other"):
        prior = tmp_path / "prior.jsonl"
        prior.write_text("{}\n" * (1 if argv == "warm" else 3))
        argv = ["--workload", "fashion_mlp", "--algorithm", "tpe", "--fused", "--warm-start",
                str(prior)]
        cold = program_key(cli.build_parser().parse_args([*argv[:5], "--backend", "cpu"]))
    argv = [*argv, "--backend", "cpu"]
    key = program_key(cli.build_parser().parse_args(argv))
    assert key == jax_key(jax_parser().parse_args(argv))
    if "--warm-start" in argv:
        assert key != cold


def test_program_key_names_the_backend_as_each_cli_does():
    """The port's gpu backend is the JAX package's tpu: one key field
    apart, every other field equal."""
    from mpi_opt_tpu.cli import build_parser as jax_parser
    from mpi_opt_tpu.service.programs import program_key as jax_key
    from mpi_opt_tpu_torch.service.programs import program_key

    port = program_key(cli.build_parser().parse_args([*FUSED]))
    jax = jax_key(jax_parser().parse_args([*FUSED, "--backend", "tpu"]))
    assert port[1] == "gpu" and jax[1] == "tpu"
    assert port[:1] + port[2:] == jax[:1] + jax[2:]


def _pick_sequence(svc, lease_mod):
    """Pick, mark the pick done, release its lease, repeat: the job ids
    in pick order."""
    order = []
    while True:
        svc._status_memo.clear()
        svc._tenants_memo = None
        pick = svc._pick_next()
        if pick is None:
            return order
        t, lease, _ = pick
        order.append(t.job_id)
        t.write_status(dict(t.status, state="done"))
        lease_mod.release(t.lease, lease)


@pytest.mark.parametrize("case", ["priority", "deadline", "fair_share", "starvation"])
def test_pick_order_equals_jax(tmp_path, case):
    """``_pick_next`` of both schedulers on copies of one spool: priority
    class first, earliest deadline within it, then fair share (fewest
    slices a tenant name, FIFO within), with the starvation floor aging
    a waiting job upward."""
    import shutil

    from mpi_opt_tpu.service.scheduler import SweepService as JaxService

    now = time.time()
    spool = Spool(str(tmp_path / "port"))
    jobs = {
        "priority": [("cheap", 0, None), ("busy", 5, None), ("mid", 2, None), ("busy", 5, None)],
        "deadline": [("a", 0, None), ("b", 0, now + 3600), ("c", 0, now + 60), ("d", 1, now + 9e3)],
        "fair_share": [("a", 0, None), ("a", 0, None), ("b", 0, None), ("c", 0, None)],
        "starvation": [("patient", 0, None), ("vip", 2, None), ("vip", 2, None), ("late", 0, None)],
    }[case]
    ids = [spool.submit(FUSED, tenant=n, priority=p, deadline_ts=d) for n, p, d in jobs]
    for q in spool.pending_jobs():
        spool.admit(q)
    if case == "starvation":  # the first job has waited ~10 floors of 0.1 s
        t = spool.tenant(ids[0])
        t.write_status(dict(t.status, submitted_ts=now - 1.0))
    shutil.copytree(str(tmp_path / "port"), str(tmp_path / "jax"))
    floor = 0.1 if case == "starvation" else 300.0
    usage = {"a": 3, "busy": 50} if case in ("fair_share", "priority") else {}
    port = _service(tmp_path / "port", starvation_floor_s=floor)
    jax = JaxService(str(tmp_path / "jax"), starvation_floor_s=floor, metrics=MetricsLogger())
    port._usage.update(usage)
    jax._usage.update(usage)
    order = _pick_sequence(port, leases)
    assert order == _pick_sequence(jax, jleases)
    assert sorted(order) == sorted(ids)
    if case == "starvation":
        assert order[0] == ids[0]


# -- chaos, stream idle -------------------------------------------------------


@pytest.mark.parametrize("replace_fail,read_fail,seed,window", [
    (0, 0, 0, None), (2, 1, 0, None), (3, 2, 7, 50), (1, 4, 11, 9), (5, 5, 3, 5),
])
def test_spool_fault_schedules_equal_jax(replace_fail, read_fail, seed, window):
    from mpi_opt_tpu.workloads.chaos import SpoolFaultInjector as JaxInjector
    from mpi_opt_tpu_torch.workloads.chaos import SpoolFaultInjector

    kw = dict(replace_fail=replace_fail, read_fail=read_fail, seed=seed, ops_window=window)
    assert SpoolFaultInjector(**kw)._fail == JaxInjector(**kw)._fail


def test_spool_faults_are_absorbed_by_the_retry(tmp_path):
    """Two failed replaces and one EIO status read on the port's spool:
    the retry budget absorbs them, and the faults fired are counted."""
    from mpi_opt_tpu_torch.workloads.chaos import inject_spool_faults

    spool = Spool(str(tmp_path))
    injector, uninstall = inject_spool_faults(replace_fail=2, read_fail=1)
    try:
        job = spool.submit(FUSED, tenant="a")
        t = spool.admit(os.path.join(str(tmp_path), "queue", f"{job}.json"))
        assert t.status["state"] == "queued"
    finally:
        uninstall()
    assert injector.faults_fired == {"replace": 2, "read": 1}


def test_stream_idle_equals_jax(tmp_path):
    """``stream_idle_frac`` and ``StreamIdleTracker`` on one span stream,
    polled as it grows (a torn last line waits for its end)."""
    from mpi_opt_tpu.obs import bubbles as jbubbles
    from mpi_opt_tpu_torch.obs import bubbles

    path = tmp_path / "m.jsonl"

    def span(name, ts, dur, rank=0, tenant="a"):
        return json.dumps({"event": "span", "span": name, "ts": ts, "dur_s": dur, "rank": rank,
                           "tenant": tenant, "t": ts}) + "\n"

    chunks = [
        span("setup", 100.0, 1.0) + span("train", 101.0, 2.0) + '{"event": "summary"}\n',
        span("journal", 103.0, 0.5) + span("train", 103.6, 1.0) + span("train", 104.0, 0.3, rank=1),
        span("boundary", 105.0, 0.2) + span("stage_in", 104.5, 0.4)[:20],
        span("stage_in", 104.5, 0.4)[20:] + span("save", 105.3, 0.7, tenant="b"),
    ]
    port, jax = bubbles.StreamIdleTracker(str(path)), jbubbles.StreamIdleTracker(str(path))
    assert port.poll() is None and jax.poll() is None  # no stream yet
    for chunk in chunks:
        with open(path, "a") as f:
            f.write(chunk)
        assert port.poll() == jax.poll()
        assert bubbles.stream_idle_frac(str(path)) == jbubbles.stream_idle_frac(str(path))
    assert 0.0 < port.idle_frac() < 1.0


# -- the server on the CPU ----------------------------------------------------


def test_three_tenants_slice_interleaved_ledgers_identical_to_solo(tmp_path, small_mlp):
    """Three fashion_mlp tenants (fused PBT twice, one shape-matching,
    and fused TPE), time-sliced at every boundary: each ledger equals
    its solo run's and validates; the second PBT tenant is a program
    cache hit from its first slice, the first a miss."""
    d = tmp_path / "svc"
    spool = Spool(str(d))
    tpe = ["--workload", "fashion_mlp", "--algorithm", "tpe", "--fused", "--trials", "8",
           "--population", "4", "--budget", "2"]
    specs = {spool.submit(FUSED, tenant="alice"): FUSED,
             spool.submit([*FUSED, "--seed", "1"], tenant="bob"): [*FUSED, "--seed", "1"],
             spool.submit(tpe, tenant="carol"): tpe}
    assert _service(d, slice_boundaries=1).serve() == 0
    summary = _events(d, "summary")[-1]
    assert summary["slices"] >= 7 and summary["tenants_done"] == 3
    assert summary["device_memory_peak_bytes"] is None  # no card
    (a, b, c) = specs
    for job, argv in specs.items():
        s = spool.tenant(job).status
        assert s["state"] == tstates.DONE and s["preemptions"] >= 1, (job, s)
        assert _records(spool.tenant(job).ledger) == _solo(argv, tmp_path / f"solo-{job}.jsonl")
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(["report", "--validate", spool.tenant(job).ledger]) == 0
    sa, sb = spool.tenant(a).status, spool.tenant(b).status
    assert sa["first_slice_program_cache_hit"] is False
    assert sb["first_slice_program_cache_hit"] is True
    assert sb["program_cache"] == {"hits": sb["slices"], "misses": 0}
    starts = _events(d, "slice_start")
    assert [e["job"] for e in starts[:3]] == [a, b, c]  # fair share interleaves


def test_sigterm_parks_and_a_restart_finishes(tmp_path, small_mlp):
    """A real SIGTERM mid-slice: the tenant drains at its next boundary
    and parks, the server exits 0; a restarted server resumes the tenant
    to its solo run's records."""
    spool = Spool(str(tmp_path))
    job = spool.submit(FUSED, tenant="alice")

    def kill_mid_slice(t, stage, n):
        if n == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    assert _service(tmp_path, slice_boundaries=100, on_boundary=kill_mid_slice).serve() == 0
    st = spool.tenant(job).status
    assert st["state"] == tstates.PARKED and st["slices"] == 1
    assert _events(tmp_path, "slice_end")[-1]["signal"] == "SIGTERM"
    assert spool.read_server() is None  # the registration cleared on exit
    shutdown.clear_delivered()
    assert _service(tmp_path, slice_boundaries=100).serve() == 0
    assert spool.tenant(job).status["state"] == tstates.DONE
    assert _records(spool.tenant(job).ledger) == _solo(FUSED, tmp_path / "solo.jsonl")


def test_sigkill_shaped_death_recovers_by_takeover(tmp_path, small_mlp):
    """A tenant left ``running`` behind a dead server (the SIGKILL shape):
    a restarted server takes its lease over and resumes it to the solo
    records; ``status`` and ``drain`` read the spool meanwhile."""
    spool = Spool(str(tmp_path))
    job = spool.submit(FUSED, tenant="alice")
    queued = spool.submit([*FUSED, "--seed", "3"], tenant="bob")

    def drain_mid_slice(t, stage, n):
        if n == 1:
            spool.request_drain()

    assert _service(tmp_path, slice_boundaries=100, on_boundary=drain_mid_slice).serve() == 0
    t = spool.tenant(job)
    assert t.status["state"] == tstates.PARKED
    assert spool.tenant(queued).status["state"] == tstates.QUEUED  # drain kept the queue
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert service_main(["cancel", "--state-dir", str(tmp_path), queued]) == 0
    assert json.loads(out.getvalue())["state"] == tstates.CANCELLED
    # forge the kill: status running, a registration naming a dead pid
    t.write_status(dict(t.status, state=tstates.RUNNING))
    spool.write_server()
    srv = spool.read_server()
    with open(spool.server_path, "w") as f:
        json.dump(dict(srv, pid=2**22 + 7919), f)
    assert spool.server_alive() is False
    assert _service(tmp_path, slice_boundaries=100).serve() == 0
    st = spool.tenant(job).status
    assert st["state"] == tstates.DONE and st["takeovers"] == 1
    assert [e["job"] for e in _events(tmp_path, "tenant_takeover")] == [job]
    assert _records(t.ledger) == _solo(FUSED, tmp_path / "solo.jsonl")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert service_main(["status", "--state-dir", str(tmp_path), "--json"]) == 0
    states = {j["job"]: j["state"] for j in json.loads(out.getvalue())["jobs"]}
    assert states == {job: "done", queued: "cancelled"}


def test_report_over_a_service_state_dir_equals_jax(tmp_path, small_mlp, capsys):
    import mpi_opt_tpu.ledger.report as jreport
    import mpi_opt_tpu_torch.ledger.report as treport

    spool = Spool(str(tmp_path))
    spool.submit(FUSED, tenant="alice")
    spool.submit([*FUSED, "--seed", "1"], tenant="bob")
    assert _service(tmp_path, slice_boundaries=2).serve() == 0
    capsys.readouterr()
    for extra in ([], ["--json"], ["--validate"]):
        outs = []
        for main in (treport.report_main, jreport.report_main):
            assert main([str(tmp_path), *extra]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1], extra
        if not extra:
            assert outs[0].count("service:") == 2 and "state=done" in outs[0]


def test_serve_without_a_card_fails_unless_asked_for_the_cpu(tmp_path, capsys):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    assert service_main(["serve", "--state-dir", str(tmp_path)]) == 69
    assert "pass --platform cpu" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        service_main(["serve", "--state-dir", str(tmp_path), "--platform", "cpu",
                      "--local-devices", "2"])
    assert e.value.code == 2


def test_spool_clients_start_without_torch(tmp_path):
    """``submit``/``status``/``cancel``/``drain`` through ``python -m``
    import neither torch nor the CLI module."""
    code = ("import runpy, sys; sys.argv = ['x', 'status', '--state-dir', sys.argv[1]]\n"
            "try:\n    runpy.run_module('mpi_opt_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n    assert e.code == 0\n"
            "assert 'torch' not in sys.modules and 'mpi_opt_tpu_torch.cli' not in sys.modules\n")
    Spool(str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "server down" in proc.stdout


# -- the JAX package's scheduler contracts, on the port ------------------------
#
# tests/test_service.py's cases on the port's server, with fused
# fashion_mlp tenants (3 launches, 2 boundaries) where the JAX tests run
# quadratic driver sweeps: the port's quadratic needs the cpu backend's
# fork server, which the in-process server does not need to show these.


def test_submit_status_cancel_roundtrip(tmp_path, capsys):
    d = str(tmp_path)
    assert service_main(["submit", "--state-dir", d, "--tenant", "alice", "--", *FUSED]) == 0
    j1 = json.loads(capsys.readouterr().out)["job"]
    assert service_main(["submit", "--state-dir", d, "--", *FUSED, "--seed", "1"]) == 0
    j2 = json.loads(capsys.readouterr().out)["job"]
    assert service_main(["status", "--state-dir", d, "--json"]) == 0
    st = json.loads(capsys.readouterr().out)
    assert st["server"]["alive"] is False
    assert [j["job"] for j in st["jobs"]] == [j1, j2]
    assert all(j["state"] == tstates.QUEUED for j in st["jobs"])
    assert service_main(["cancel", j2, "--state-dir", d]) == 0
    assert json.loads(capsys.readouterr().out)["state"] == tstates.CANCELLED
    assert service_main(["status", "--state-dir", d, "--json"]) == 0
    by_job = {j["job"]: j["state"] for j in json.loads(capsys.readouterr().out)["jobs"]}
    assert by_job == {j1: tstates.QUEUED, j2: tstates.CANCELLED}
    with pytest.raises(SystemExit):  # unknown job: usage error
        service_main(["cancel", "job-nope", "--state-dir", d])
    with pytest.raises(SystemExit) as e:  # a server-owned flag: usage error
        service_main(["submit", "--state-dir", d, "--", *FUSED, "--resume"])
    assert e.value.code == 2


def test_readonly_clients_refuse_a_nonexistent_spool(tmp_path, capsys):
    missing = str(tmp_path / "typo")
    for argv in (["status", "--state-dir", missing], ["cancel", "some-job", "--state-dir", missing],
                 ["drain", "--state-dir", missing]):
        with pytest.raises(SystemExit) as e:
            service_main(argv)
        assert e.value.code == 2 and not os.path.exists(missing)
    fresh = str(tmp_path / "fresh")  # submit queues ahead: it creates the spool
    assert service_main(["submit", "--state-dir", fresh, "--", *FUSED]) == 0
    assert os.path.isdir(os.path.join(fresh, "queue"))


def test_serve_refuses_a_second_server_with_the_same_id(tmp_path, monkeypatch, capsys):
    from mpi_opt_tpu_torch.service.spool import ServerClaimError

    spool = Spool(str(tmp_path))
    spool.write_server()  # this live process "is" the default server
    with pytest.raises(ServerClaimError, match="federate with a distinct"):
        _service(tmp_path).serve()
    assert service_main(["serve", "--state-dir", str(tmp_path), "--platform", "cpu"]) == 2
    assert "already owns server-id" in capsys.readouterr().err
    assert spool.register_server("srv-b") is True  # a distinct id registers beside it
    assert {s["server_id"] for s in spool.read_servers()} == {"server", "srv-b"}
    spool.clear_server("srv-b")
    spool.clear_server()

    def crash(self):
        raise RuntimeError("scheduler bug")

    monkeypatch.setattr(SweepService, "serve", crash)  # a crash keeps its traceback
    with pytest.raises(RuntimeError, match="scheduler bug"):
        service_main(["serve", "--state-dir", str(tmp_path), "--platform", "cpu"])


def test_registrations_are_atomic_and_stale_ones_are_broken(tmp_path):
    from mpi_opt_tpu_torch.service.spool import _write_json_atomic

    spool = Spool(str(tmp_path))
    assert spool.register_server() is True
    assert Spool(str(tmp_path)).register_server() is False  # we are alive
    spool.clear_server()
    spool.write_server()
    srv = spool.read_server()
    with open(spool.server_path, "w") as f:
        json.dump(dict(srv, pid=2**22 + 7919), f)  # a dead pid
    assert spool.register_server() is True
    assert spool.refresh_server(Spool.DEFAULT_SERVER_ID, takeovers=3) is True
    assert spool.read_server()["takeovers"] == 3
    with open(spool.server_path, "w") as f:
        json.dump(dict(srv, pid_start="999"), f)  # someone else's now
    assert spool.refresh_server(Spool.DEFAULT_SERVER_ID) is False
    # a recycled pid (ours, another start time) is not alive
    _write_json_atomic(spool.server_path, dict(srv, pid_start="12345"))
    assert spool.server_alive() is False and spool.register_server() is True
    spool.clear_server()


def test_fair_share_across_tenants_fifo_within(tmp_path, small_mlp):
    """Two slices a job: tenant names alternate while both hold live
    work, a finished job retires its tally, FIFO within a name."""
    spool = Spool(str(tmp_path))
    a1 = spool.submit(FUSED, tenant="alice")
    a2 = spool.submit([*FUSED, "--seed", "1"], tenant="alice")
    b1 = spool.submit([*FUSED, "--seed", "2"], tenant="bob")
    svc = _service(tmp_path, slice_boundaries=2)
    assert svc.serve() == 0
    assert all(t.status["state"] == tstates.DONE for t in spool.tenants())
    assert [e["job"] for e in _events(tmp_path, "slice_start")] == [a1, b1, a1, a2, a2, b1]
    assert svc._usage.get("alice", 0) == svc._usage.get("bob", 0) == 0  # retired with the jobs


def test_admission_cap_per_tenant(tmp_path, small_mlp):
    spool = Spool(str(tmp_path))
    jobs = [spool.submit([*FUSED, "--seed", str(s)], tenant="alice") for s in range(3)]
    assert _service(tmp_path, slice_boundaries=50, max_active_per_tenant=1).serve() == 0
    assert [e["job"] for e in _events(tmp_path, "tenant_admit")] == jobs
    assert all(t.status["state"] == tstates.DONE for t in spool.tenants())


def test_cancel_running_tenant_drains_cleanly(tmp_path, small_mlp, capsys):
    """A cancel lands at the running tenant's next boundary: drained, not
    killed (its records journaled, fsck clean), and the next job runs."""
    from mpi_opt_tpu_torch.utils.integrity import fsck_main

    spool = Spool(str(tmp_path))
    long_argv = [*FUSED[:8], "6", *FUSED[9:]]  # 6 generations
    long_job = spool.submit(long_argv, tenant="alice")
    short_job = spool.submit(FUSED, tenant="bob")

    def cancel_mid_slice(t, stage, n):
        if t.job_id == long_job and n == 2:
            spool.tenant(long_job).request_cancel()

    assert _service(tmp_path, slice_boundaries=100, on_boundary=cancel_mid_slice).serve() == 0
    s_long = spool.tenant(long_job).status
    assert s_long["state"] == tstates.CANCELLED and s_long["slices"] == 1
    assert spool.tenant(short_job).status["state"] == tstates.DONE
    assert len(_records(spool.tenant(long_job).ledger)) == 2 * 4  # generations 1-2
    capsys.readouterr()
    assert cli.main(["report", "--validate", spool.tenant(long_job).ledger]) == 0
    assert fsck_main([spool.tenant(long_job).ckpt]) == 0


def test_sigkill_during_first_slice_resumes_not_fails(tmp_path, small_mlp):
    """Killed in its FIRST slice with records journaled: the retry passes
    --resume, so the stale-ledger refusal never fails the tenant."""
    spool = Spool(str(tmp_path))
    job = spool.submit(FUSED, tenant="alice")

    def drain_mid_slice(t, stage, n):
        if n == 1:
            spool.request_drain()

    assert _service(tmp_path, slice_boundaries=100, on_boundary=drain_mid_slice).serve() == 0
    t = spool.tenant(job)
    assert t.status["state"] == tstates.PARKED and os.path.getsize(t.ledger) > 0
    t.write_status(dict(t.status, state=tstates.RUNNING, slices=0))
    assert _service(tmp_path, slice_boundaries=100).serve() == 0
    assert spool.tenant(job).status["state"] == tstates.DONE
    assert _records(t.ledger) == _solo(FUSED, tmp_path / "solo.jsonl")


def test_drain_subcommand_parks_and_preserves_queue(tmp_path, small_mlp, capsys):
    spool = Spool(str(tmp_path))
    j1 = spool.submit(FUSED, tenant="alice")
    j2 = spool.submit([*FUSED, "--seed", "1"], tenant="bob")

    def drain_early(t, stage, n):
        if n == 1:
            assert service_main(["drain", "--state-dir", str(tmp_path)]) == 0

    assert _service(tmp_path, slice_boundaries=100, on_boundary=drain_early).serve() == 0
    states = {t.job_id: t.status["state"] for t in spool.tenants()}
    assert states[j1] == tstates.PARKED and states.get(j2, tstates.QUEUED) == tstates.QUEUED
    assert _events(tmp_path, "summary")[-1]["reason"] == "drain"
    assert _service(tmp_path, slice_boundaries=100).serve() == 0
    assert all(t.status["state"] == tstates.DONE for t in spool.tenants())


def test_program_cache_commits_only_after_a_real_run():
    from mpi_opt_tpu_torch.service.programs import ProgramCache

    cache = ProgramCache()
    key, hit, workload = cache.acquire(FUSED)
    assert key is not None and hit is False and workload.name == "fashion_mlp"
    key2, hit2, same = cache.acquire([*FUSED, "--seed", "5"])  # no commit yet: a miss
    assert key2 == key and hit2 is False and same is workload
    cache.commit(key)
    assert cache.acquire(FUSED)[1] is True
    # a chaos drill's wrapper is rebuilt a run: no key, no hit, no workload
    assert cache.acquire(["--workload", "quadratic", "--backend", "cpu", "--chaos",
                          "exc=0.1,seed=1"]) == (None, False, None)
    assert cache.acquire(["--workload", "nosuch"]) == (None, False, None)


def test_unreadable_job_spec_fails_tenant_not_server(tmp_path, small_mlp):
    spool = Spool(str(tmp_path))
    bad = spool.submit(FUSED, tenant="alice")
    good = spool.submit([*FUSED, "--seed", "1"], tenant="bob")
    svc = _service(tmp_path, slice_boundaries=100)
    svc._admit_pending()
    os.unlink(spool.tenant(bad).job_path)
    assert svc.serve() == 0
    assert spool.tenant(bad).status["state"] == tstates.FAILED
    assert spool.tenant(good).status["state"] == tstates.DONE


def test_workload_construction_failure_fails_tenant_not_server(tmp_path, small_mlp, monkeypatch):
    real = tworkloads.get_workload

    def exploding(name, **kw):
        if name == "tabular_mlp":
            raise RuntimeError("dataset cache corrupt")
        return real(name, **kw)

    monkeypatch.setattr(tworkloads, "get_workload", exploding)
    spool = Spool(str(tmp_path))
    bad = spool.submit(["--workload", "tabular_mlp", "--algorithm", "pbt", "--fused"], tenant="a")
    good = spool.submit(FUSED, tenant="b")
    assert _service(tmp_path, slice_boundaries=100).serve() == 0
    st = spool.tenant(bad).status
    assert st["state"] == tstates.FAILED and "dataset cache corrupt" in st["note"]
    assert spool.tenant(good).status["state"] == tstates.DONE


def test_fair_share_usage_is_session_scoped(tmp_path):
    spool = Spool(str(tmp_path))
    svc = _service(tmp_path, slice_boundaries=100)
    a_new = spool.submit(FUSED, tenant="alice")
    b_new = spool.submit(FUSED, tenant="bob")
    hist = spool.submit(FUSED, tenant="alice")
    svc._admit_pending()
    done = spool.tenant(hist)
    done.write_status(dict(done.status, state=tstates.DONE, slices=100))
    parked = spool.tenant(b_new)
    parked.write_status(dict(parked.status, state=tstates.PARKED, slices=3))
    restarted = _service(tmp_path, slice_boundaries=100)
    assert restarted._usage.get("alice", 0) == 0 and restarted._usage["bob"] == 3
    picked, lease, takeover_from = restarted._pick_next()
    assert picked.job_id == a_new and lease is not None and takeover_from is None
    leases.release(picked.lease, lease)


def test_read_summary_scoped_to_this_slice(tmp_path):
    from mpi_opt_tpu_torch.service.scheduler import _read_summary

    log = tmp_path / "run.log"
    prior = json.dumps({"best_score": 0.5, "workload": "fashion_mlp"})
    log.write_text(prior + "\n")
    start = os.path.getsize(log)
    with open(log, "a") as f:
        f.write("Traceback (most recent call last):\n  boom\n")
    assert _read_summary(str(log), 0) == json.loads(prior)
    assert _read_summary(str(log), start) is None


def test_admission_tolerates_racing_cancel(tmp_path):
    spool = Spool(str(tmp_path))
    spool.submit(FUSED, tenant="alice")
    (qpath,) = spool.pending_jobs()
    os.unlink(qpath)  # a racing peer took it
    with pytest.raises(SpoolError, match="claimed by a peer"):
        spool.admit(qpath)
    job2 = spool.submit(FUSED, tenant="bob")
    spool.admit(spool.pending_jobs()[0])  # the server admits first
    assert spool.cancel(job2) == tstates.CANCELLED and spool.tenant(job2).cancel_requested()


@pytest.mark.parametrize("argv,rc,state,text", [
    # build_mesh's bare SystemExit(str): rc 1 with the message in run.log
    ([*FUSED, "--no-mesh", "--n-data", "2"], 1, tstates.FAILED, "--no-mesh contradicts"),
    # the probe parse is silent; the slice's own parse fails in run.log
    (["--workload", "fashion_mlp", "--algorithm", "nosuch"], 2, tstates.FAILED, "invalid choice"),
    # --help prints into run.log, never into the server's metrics stream
    (["--help"], 0, tstates.DONE, "--workload"),
])
def test_slice_exits_classify_and_report_in_the_tenant_log(tmp_path, capsys, argv, rc, state, text):
    spool = Spool(str(tmp_path))
    spool.submit(argv, tenant="a")
    assert _service(tmp_path).serve() == 0
    (t,) = spool.tenants()
    assert t.status["state"] == state and t.status["rc_history"] == [rc]
    with open(t.log) as f:
        assert text in f.read()
    captured = capsys.readouterr()
    assert text not in captured.out + captured.err and "usage:" not in captured.out + captured.err


def test_slice_systemexit_none_is_success(tmp_path, monkeypatch):
    spool = Spool(str(tmp_path))
    spool.submit(FUSED, tenant="a")
    monkeypatch.setattr(cli, "main", lambda argv, _workload=None: (_ for _ in ()).throw(SystemExit(None)))
    assert _service(tmp_path).serve() == 0
    (t,) = spool.tenants()
    assert t.status["state"] == tstates.DONE and t.status["rc_history"] == [0]


def test_signal_between_loop_check_and_slice_never_burns_a_quantum(tmp_path):
    spool = Spool(str(tmp_path))
    spool.submit(FUSED, tenant="a")
    svc = _service(tmp_path)
    t = spool.admit(spool.pending_jobs()[0])
    lease = leases.acquire(t.lease, svc.ident, svc.lease_ttl)
    shutdown.clear_delivered()
    try:
        with shutdown.ShutdownGuard() as g:  # the server's guard
            g._handle(signal.SIGTERM, None)  # the race: a signal before the slice
            assert svc._run_slice(t, lease) == "SIGTERM"
        assert t.status["state"] == tstates.QUEUED and int(t.status.get("slices") or 0) == 0
    finally:
        shutdown.clear_delivered()


def test_signal_during_slice_parks_at_first_boundary(tmp_path, small_mlp):
    spool = Spool(str(tmp_path))
    spool.submit([*FUSED[:8], "6", *FUSED[9:]], tenant="a")

    def fake_delivery(t, stage, n):
        if n == 1:
            shutdown._DELIVERED = "SIGTERM"  # landed on the server's guard

    try:
        assert _service(tmp_path, slice_boundaries=50, on_boundary=fake_delivery).serve() == 0
        (t,) = spool.tenants()
        assert t.status["state"] == tstates.PARKED and t.status["boundaries"] <= 2
    finally:
        shutdown.clear_delivered()


def test_traced_slice_writes_idle_frac(tmp_path, small_mlp):
    """serve --trace: each slice end writes the tenant's cumulative idle
    fraction from its own span stream (tenant-tagged spans); an untraced
    server writes none."""
    spool = Spool(str(tmp_path))
    j = spool.submit(FUSED, tenant="alice")
    assert _service(tmp_path, slice_boundaries=2, trace=True).serve() == 0
    st = spool.tenant(j).status
    assert st["state"] == tstates.DONE and 0.0 <= st["idle_frac"] <= 1.0
    with open(spool.tenant(j).metrics) as f:
        spans = [r for r in map(json.loads, f) if r.get("event") == "span"]
    assert spans and all(r.get("tenant") == "alice" for r in spans)
    assert "MPI_OPT_TPU_TRACE_TAG" not in os.environ
    j2 = spool.submit(FUSED, tenant="bob")
    assert _service(tmp_path, slice_boundaries=2).serve() == 0
    assert "idle_frac" not in spool.tenant(j2).status

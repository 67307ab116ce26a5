"""The port's host staging layer (mirrors the staging-engine cases of the
JAX package's ``tests/test_fused_waves.py``): the engine's round trip
and accounting, worker errors surfaced by ``drain``, ``stage_in``'s row
map, ``estimate_wave_size``'s budget order, a heartbeat per transfer,
the pools, the wave initialisation and ``resolve_wave_size``. The card
cases (streams, pinned pools) skip without one."""

import pytest
import torch

from mpi_opt_tpu_torch import get_workload
from mpi_opt_tpu_torch.obs import memory
from mpi_opt_tpu_torch.train import engine, staging
from mpi_opt_tpu_torch.utils import resources


@pytest.fixture(scope="module")
def trainer():
    return get_workload("fashion_mlp", n_train=256, n_val=128).make_trainer(device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the staging streams and pinned pools are the card's")
    return torch.device("cuda")


def _roundtrip(device):
    eng = staging.StagingEngine(device)
    try:
        pool = {"a": torch.zeros((8, 4)), "b": torch.zeros((8,), dtype=torch.int32)}
        scores = torch.full((8,), float("nan"))
        tree = {"state": {"a": torch.full((2, 4), 7.0, device=device),
                          "b": torch.tensor([3, 4], dtype=torch.int32, device=device)},
                "scores": torch.tensor([0.5, 0.25], device=device)}
        landed = []
        eng.stage_out(tree, {"state": staging.pool_rows(pool, 2, 2), "scores": scores[2:4]},
                      on_done=lambda: landed.append(True))
        eng.drain()
        assert landed == [True]
        assert torch.equal(pool["a"][2:4], torch.full((2, 4), 7.0))
        assert torch.equal(pool["a"][:2], torch.zeros((2, 4))) and torch.equal(pool["a"][4:], torch.zeros((4, 4)))
        assert pool["b"].tolist() == [0, 0, 3, 4, 0, 0, 0, 0]
        assert scores[2:4].tolist() == [0.5, 0.25] and torch.isnan(scores[:2]).all()
        assert eng.staged_bytes == 2 * 4 * 4 + 2 * 4 + 2 * 4  # state + int32 step + f32 scores
        assert eng.transfers == 1
        assert eng.transfer_s >= 0 and eng.wait_s >= 0 and eng.overlap_s >= 0
        back = eng.stage_in(pool, [3, 2])
        assert back["a"].device.type == torch.device(device).type
        assert back["b"].cpu().tolist() == [4, 3]
        assert eng.staged_bytes == 48 + 2 * 4 * 4 + 2 * 4
    finally:
        eng.close()


def test_staging_engine_roundtrip_and_accounting():
    _roundtrip("cpu")


@pytest.mark.cuda
def test_staging_engine_roundtrip_on_card(cuda_device):
    _roundtrip(cuda_device)


@pytest.mark.cuda
def test_staging_engine_overlaps_copies_with_compute_on_card(cuda_device):
    """Waves staged out on the copy stream land bit-exactly while the
    compute stream reuses their memory for the next wave."""
    pool = {"x": torch.zeros((64, 1 << 16), pin_memory=True)}
    eng = staging.StagingEngine(cuda_device)
    try:
        for w in range(8):
            dev = eng.stage_in(pool, list(range(8 * w, 8 * w + 8)))
            dev["x"].add_(float(w + 1))
            torch.cuda._sleep(1 << 20)  # the next wave's compute, in flight
            eng.stage_out(dev, staging.pool_rows(pool, 8 * w, 8))
            del dev
        eng.drain()
    finally:
        eng.close()
    want = torch.arange(1, 9, dtype=torch.float32).repeat_interleave(8)[:, None].expand(64, 1 << 16)
    assert torch.equal(pool["x"], want)
    assert eng.transfers == 8 and eng.staged_bytes == 2 * 64 * (1 << 16) * 4


def test_staging_engine_propagates_worker_errors():
    eng = staging.StagingEngine()
    try:
        def bad():
            raise RuntimeError("writer exploded")

        eng.stage_out({"x": torch.zeros(3)}, {"x": torch.zeros(3)}, on_done=bad)
        with pytest.raises(RuntimeError, match="writer exploded"):
            eng.drain()
        # a latched error refuses the next transfer on sight
        with pytest.raises(RuntimeError, match="writer exploded"):
            eng.stage_out({"x": torch.zeros(3)}, {"x": torch.zeros(3)})
    finally:
        eng.close()
    # a copy that cannot land (shape mismatch) is the worker's error too
    eng = staging.StagingEngine()
    try:
        eng.stage_out({"x": torch.zeros(3)}, {"x": torch.zeros(2)})
        with pytest.raises(RuntimeError):
            eng.drain()
    finally:
        eng.close()


def test_engine_rollover_carries_accounting():
    eng = staging.StagingEngine()
    eng.stage_out({"x": torch.ones(4)}, {"x": torch.zeros(4)}, on_done=lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        eng.drain()
    new = engine.engine_rollover(eng)
    try:
        assert new.transfers == eng.transfers and new.transfer_s == eng.transfer_s
        new.stage_out({"x": torch.ones(4)}, {"x": torch.zeros(4)})  # no latched error
        new.drain()
        assert new.staged_bytes == 16
    finally:
        new.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.stage_out({"x": torch.ones(1)}, {"x": torch.zeros(1)})


def test_stage_in_applies_permutation():
    pool = {"a": torch.arange(8, dtype=torch.float32).reshape(8, 1)}
    assert staging.stage_in(pool, [5, 1, 6])["a"].ravel().tolist() == [5.0, 1.0, 6.0]
    eng = staging.StagingEngine()
    try:
        assert eng.stage_in(pool, [7, 0])["a"].ravel().tolist() == [7.0, 0.0]
        assert eng.staged_bytes == 8
    finally:
        eng.close()


def test_write_rows_lands_a_wave():
    pool = {"p": {"w": torch.zeros((5, 2))}, "step": torch.zeros(5, dtype=torch.int32)}
    staging.write_rows(pool, 3, {"p": {"w": torch.ones((2, 2))}, "step": torch.tensor([1, 2], dtype=torch.int32)})
    assert pool["p"]["w"].sum().item() == 4 and pool["step"].tolist() == [0, 0, 0, 1, 2]
    assert staging.tree_bytes(pool) == 5 * 2 * 4 + 5 * 4


@pytest.mark.parametrize("momentum_dtype", [None, "bfloat16"])
def test_population_pool_matches_the_carried_state(momentum_dtype):
    """The pool has the resident ``PopState``'s names, shapes and dtypes,
    from the meta template, and its bytes are P members' state."""
    wl = get_workload("fashion_mlp", n_train=256, n_val=128)
    tr = wl.make_trainer(device="cpu", momentum_dtype=momentum_dtype)
    pool = staging.population_pool(tr, 5)
    g = torch.Generator()
    g.manual_seed(0)
    st = tr.init_population(g, 5)
    for part in ("params", "momentum"):
        got, want = pool[part], getattr(st, part)
        assert list(got) == list(want)
        assert all(got[k].shape == want[k].shape and got[k].dtype == want[k].dtype for k in want)
        assert all(not v.is_pinned() and not v.any() for v in got.values())
    assert pool["step"].dtype == torch.int32 and pool["step"].shape == (5,)
    assert staging.tree_bytes(pool) == 5 * tr.member_bytes() + 5 * 4


@pytest.mark.parametrize("name,kw", [
    ("fashion_mlp", {}),
    ("cifar10_cnn", {"n_train": 64, "n_val": 32}),
    ("cifar100_resnet18", {"n_train": 64, "n_val": 32, "width": 8}),
])
def test_init_population_into_bit_identical(name, kw):
    """The wave path's layer-by-layer pool initialisation draws what the
    resident ``init_population`` draws, in its order."""
    wl = get_workload(name, **kw)
    tr = wl.make_trainer(device="cpu")
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(7)
    g2.manual_seed(7)
    st = tr.init_population(g1, 3)
    pool = staging.population_pool(tr, 3)
    tr.init_population_into(g2, pool["params"])
    for k, v in st.params.items():
        assert torch.equal(pool["params"][k], v), k
    # the generator stands where the resident init leaves it
    assert torch.equal(g1.get_state(), g2.get_state())


def test_estimate_wave_size_respects_budget_and_population(trainer, monkeypatch):
    monkeypatch.delenv("MPI_OPT_TPU_DEVICE_BYTES", raising=False)
    assert staging.estimate_wave_size(trainer, 8, budget_bytes=1 << 40) == 8
    assert staging.estimate_wave_size(trainer, 8, budget_bytes=1) == 1
    member = trainer.member_bytes()
    assert member == 2 * sum(p.numel() * 4 for p in trainer.template.parameters())
    w = staging.estimate_wave_size(trainer, 8, budget_bytes=int(member * 2 / 0.35))
    assert 1 <= w <= 2
    # a measured all-in peak tightens the estimate, never loosens it
    budget = int(member * 6 / 0.35) + 1024
    assert staging.estimate_wave_size(trainer, 8, budget_bytes=budget) == 6
    assert staging.estimate_wave_size(trainer, 8, budget_bytes=budget,
                                      measured_peak=(budget, 2)) == 1


def test_estimate_wave_size_budget_resolution_order(trainer, monkeypatch):
    """argument > MPI_OPT_TPU_DEVICE_BYTES > the measured card > 8 GiB."""
    member = trainer.member_bytes()

    def budget_for(members):
        return int(member * members / 0.35) + 1024

    monkeypatch.delenv("MPI_OPT_TPU_DEVICE_BYTES", raising=False)
    monkeypatch.setattr(memory, "measured_budget", lambda device=None: budget_for(4))
    assert staging.estimate_wave_size(trainer, 8) == 4
    monkeypatch.setenv("MPI_OPT_TPU_DEVICE_BYTES", str(budget_for(2)))
    assert staging.estimate_wave_size(trainer, 8) == 2
    assert staging.estimate_wave_size(trainer, 8, budget_bytes=1) == 1
    monkeypatch.delenv("MPI_OPT_TPU_DEVICE_BYTES")
    monkeypatch.setattr(memory, "measured_budget", lambda device=None: None)
    assert staging.estimate_wave_size(trainer, 8) == 8  # 8 GiB fits the tiny MLP


def test_staging_engine_beats_heartbeat_per_transfer(tmp_path):
    from mpi_opt_tpu_torch.health import heartbeat

    hb_path = str(tmp_path / "rank.hb")
    heartbeat.configure(hb_path)
    try:
        eng = staging.StagingEngine()
        try:
            for _ in range(3):
                eng.stage_out({"x": torch.ones(8)}, {"x": torch.zeros(8)})
            eng.drain()
        finally:
            eng.close()
        rec = heartbeat.read_beat(hb_path)
        assert rec is not None and rec["beats"] >= 3
        assert rec["progress"] == {"stage": "staging transfer", "transfers": 3}
        assert eng.transfers == 3
    finally:
        heartbeat.deconfigure()


def test_memory_readings_are_none_on_the_cpu():
    assert memory.sample("cpu") is None
    assert memory.measured_budget("cpu") is None
    assert memory.watermark("cpu") is None
    attrs = {}
    memory.note(attrs, "cpu")
    memory.reset_peak("cpu")
    assert attrs == {}


@pytest.mark.cuda
def test_memory_readings_on_card(cuda_device):
    memory.reset_peak(cuda_device)
    x = torch.empty(1 << 20, device=cuda_device)
    m = memory.sample(cuda_device)
    assert m["source"] == "cuda_allocator" and m["peak_bytes"] >= x.numel() * 4
    assert memory.measured_budget(cuda_device) == torch.cuda.mem_get_info(cuda_device)[1]


def test_resolve_wave_size(trainer, monkeypatch):
    events = []
    resources.set_observer(lambda e, **f: events.append((e, f)))
    try:
        monkeypatch.delenv("MPI_OPT_TPU_DEVICE_BYTES", raising=False)
        assert engine.resolve_wave_size(trainer, 8, wave_size=0) == 0
        assert engine.resolve_wave_size(trainer, 8, wave_size=3) == 3
        with pytest.raises(ValueError, match=">= 0"):
            engine.resolve_wave_size(trainer, 8, wave_size=-1)
        # auto from the operator's budget: the clamp is an event
        monkeypatch.setenv("MPI_OPT_TPU_DEVICE_BYTES", str(int(trainer.member_bytes() * 2 / 0.35) + 1024))
        assert engine.resolve_wave_size(trainer, 8, wave_size="auto") == 2
        assert events[-1] == ("wave_resized", {"requested": "auto", "wave_size": 2, "population": 8})
        # an explicit cap is clamped only against a MEASURED budget, with backoff on
        assert engine.resolve_wave_size(trainer, 8, wave_size=6, oom_backoff=2) == 6
        monkeypatch.setattr(memory, "measured_budget", lambda device=None: 1)
        assert engine.resolve_wave_size(trainer, 8, wave_size=6, oom_backoff=0) == 6
        assert engine.resolve_wave_size(trainer, 8, wave_size=6, oom_backoff=2) == 2
        assert events[-1] == ("wave_resized", {"requested": 6, "wave_size": 2, "population": 8})
    finally:
        resources.clear_observer()


def test_wave_layout_and_balanced_split():
    assert engine.balanced_split(7, 3) == [3, 2, 2]
    assert engine.balanced_split(0, 3) == [0]
    assert engine.wave_layout(8, 3) == ([3, 3, 2], [0, 3, 6], 3)
    assert engine.wave_layout(8, 8) == ([8], [0], 1)
    assert engine.wave_layout(22, 16) == ([11, 11], [0, 11], 2)


@pytest.mark.parametrize("with_state", [True, False])
def test_run_interval_keeps_no_wave_past_its_stage_out(with_state):
    """The card holds at most two waves: once a wave's copy out has
    landed, nothing of the runner's keeps its state alive while the next
    wave trains, whether the state was staged out or (TPE) only the
    scores were. The scores stay: the runner returns them."""
    import gc
    import weakref

    n, cap = 6, 2
    runner = engine.WaveRunner(n, cap)
    pool = {"params": {"w": torch.zeros(n, 3)}, "momentum": {"w": torch.zeros(n, 3)},
            "step": torch.zeros(n, dtype=torch.int32)}
    scores_host = torch.full((n,), float("nan"))
    refs = []

    def run_wave(w, off, wl, eng):
        if refs:
            eng.drain()  # the previous wave's copy has landed
            gc.collect()
            assert refs[-1]() is None, "the previous wave is still referenced"
        st = engine.PopState({"w": torch.full((wl, 3), float(w))}, {"w": torch.ones(wl, 3)},
                             torch.full((wl,), w, dtype=torch.int32))
        sc = torch.full((wl,), float(w))
        refs.append(weakref.ref(st.params["w"]))
        return st, sc

    def dst(off, wl):
        d = {"scores": scores_host[off:off + wl]}
        if with_state:
            d = {"state": staging.pool_rows(pool, off, wl), **d}
        return d

    try:
        runner.run_interval(n=n, run_wave_fn=run_wave, dst_fn=dst, scores_host=scores_host,
                            stage_label=lambda w, nw: f"wave {w + 1}/{nw}")
    finally:
        runner.close()
    assert scores_host.tolist() == [0.0, 0.0, 1.0, 1.0, 2.0, 2.0]
    if with_state:
        assert pool["params"]["w"][:, 0].tolist() == [0.0, 0.0, 1.0, 1.0, 2.0, 2.0]
    else:
        assert pool["params"]["w"].eq(0).all()  # a scores-only stage-out writes no state

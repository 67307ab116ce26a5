"""One launch shape per sweep. oneDNN on the CPU (and cuDNN on the card)
picks a grouped convolution's algorithm by its group count, so with a
member chunk every launch runs exactly that many members: a short chunk
is padded with stand-ins whose results are dropped, waves hold whole
chunks, and an OOM halving never goes below one chunk. A wave sweep and
an OOM-backed-off sweep then end in the resident sweep's bits. Without
a member chunk a wave sweep launches at one fixed width, the smallest
cap its OOM budget can reach, so a backed-off sweep ends in the
unfaulted sweep's bits too."""

import json

import numpy as np
import pytest
import torch

import mpi_opt_tpu_torch.train.fused_asha as fa
import mpi_opt_tpu_torch.train.fused_pbt as fp
from mpi_opt_tpu_torch import get_workload
from mpi_opt_tpu_torch.ledger import SweepLedger, validate_ledger
from mpi_opt_tpu_torch.train import engine, population, staging
from mpi_opt_tpu_torch.utils import integrity, resources
from torch_port_small import small_workload

CNN_KW = dict(population=8, generations=2, steps_per_gen=2, seed=2, device="cpu", member_chunk=2)
FIELDS = ("trial_id", "member", "boundary", "boundary_size", "params", "status", "score", "step")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _events():
    seen = []
    resources.set_observer(lambda event, **fields: seen.append((event, fields)))
    yield seen
    resources.set_launch_fault_injector(None)
    resources.clear_observer()


@pytest.fixture(scope="module")
def cnn():
    return small_workload()


@pytest.fixture(scope="module")
def cnn_resident(cnn):
    return fp.fused_pbt(cnn, **CNN_KW)


def _digest(st):
    return integrity.tree_digest({"params": st.params, "momentum": st.momentum, "step": st.step})


def _same_sweep(got, want):
    np.testing.assert_array_equal(got["best_curve"], want["best_curve"])
    np.testing.assert_array_equal(got["mean_curve"], want["mean_curve"])
    np.testing.assert_array_equal(got["unit"], want["unit"])
    assert _digest(got["state"]) == _digest(want["state"])


def _ledger(path, space, algorithm="pbt", seed=2):
    led = SweepLedger(str(path))
    led.ensure_header({"mode": "fused", "granularity": "generation" if algorithm == "pbt" else "rung",
                       "algorithm": algorithm, "seed": seed, "space_hash": space.space_hash()})
    return led


def _records(path):
    with open(path) as f:
        return [{k: r.get(k) for k in FIELDS} for r in map(json.loads, f.read().splitlines()[1:])]


class OOMAt:
    """A synthetic CUDA OOM at the ``at``-th wave launch (1-based)."""

    def __init__(self, at: int):
        self.at, self.seen, self.fired = at, 0, 0

    def __call__(self, kind):
        if kind == "wave":
            self.seen += 1
            if self.seen == self.at:
                self.fired += 1
                raise resources.synthetic_resource_exhausted()


def test_smallcnn_wave_cap_3_at_chunk_2_equals_resident(cnn, cnn_resident, _events):
    """A cap of 3 members over chunks of 2 (waves [3, 3, 2] before: a
    chunk of one member, another digest) now runs waves of whole chunks
    and ends in the resident digest, curves and unit matrix."""
    wav = fp.fused_pbt(cnn, wave_size=3, **CNN_KW)
    _same_sweep(wav, cnn_resident)
    assert wav["wave_size"] == 2 and wav["wave_lens"] == [2, 2, 2, 2]
    assert ("wave_resized", {"requested": 3, "wave_size": 2, "population": 8,
                             "member_chunk": 2}) in _events
    assert wav["launch_width_before"] == wav["launch_width_after"] == 2
    assert wav["launch_shape_changed"] is False


def test_smallcnn_oom_at_cap_4_settles_at_the_chunk_and_equals_unfaulted(cnn, cnn_resident, tmp_path,
                                                                         _events):
    """An OOM in generation 2's first wave at cap 4 (chunk 2) halves to
    2 and re-runs the generation: digest, curves, unit matrix and ledger
    records equal the unfaulted cap-4 run's and the resident run's."""
    space = cnn.default_space()
    led = _ledger(tmp_path / "clean.jsonl", space)
    try:
        clean = fp.fused_pbt(cnn, wave_size=4, ledger=led, **CNN_KW)
    finally:
        led.close()
    inj = OOMAt(3)
    resources.set_launch_fault_injector(inj)
    led = _ledger(tmp_path / "oom.jsonl", space)
    try:
        faulted = fp.fused_pbt(cnn, wave_size=4, oom_backoff=2, ledger=led, **CNN_KW)
    finally:
        led.close()
    assert inj.fired == 1 and faulted["oom_backoffs"] == 1
    assert faulted["wave_size"] == 2 and faulted["wave_lens"] == [2, 2, 2, 2]
    (event, fields), = [e for e in _events if e[0] == "oom_backoff"]
    assert fields["gen"] == 2 and fields["wave_size"] == 2
    assert (fields["launch_width_before"], fields["launch_width_after"]) == (2, 2)
    assert fields["launch_shape_changed"] is False and faulted["launch_shape_changed"] is False
    _same_sweep(faulted, clean)
    _same_sweep(faulted, cnn_resident)
    assert validate_ledger(str(tmp_path / "oom.jsonl")) == []
    assert _records(tmp_path / "oom.jsonl") == _records(tmp_path / "clean.jsonl")


@pytest.mark.parametrize("wave_size", [2, 3])  # 3 rounds down to one chunk of 2
def test_oom_at_a_cap_of_one_chunk_propagates(cnn, wave_size):
    """Below one chunk a padded launch saves no memory: at a cap of one
    chunk the DeviceOOM propagates (the CLI's exit 74), budget or not."""
    resources.set_launch_fault_injector(OOMAt(1))
    with pytest.raises(resources.DeviceOOM) as exc:
        fp.fused_pbt(cnn, wave_size=wave_size, oom_backoff=2, **CNN_KW)
    assert exc.value.wave_size == 2


def test_halving_without_a_member_chunk_declares_the_shape_change(tmp_path, _events):
    """Without a member chunk a wave sweep that may halve its cap twice
    launches at one fixed width, cap >> 2 (waves of 4 -> launches of 1):
    an OOM halving keeps the launch shape, and the backed-off run's
    records, curves, unit matrix and state digest equal the unfaulted
    run's. (The name is the test's from before the repair, when the
    halving changed the shape and declared it.)"""
    wl = get_workload("fashion_mlp", n_train=256, n_val=128)
    kw = dict(population=8, generations=2, steps_per_gen=2, seed=2, device="cpu")
    space = wl.default_space()
    out = {}
    for tag, inj in (("clean", None), ("oom", OOMAt(1))):
        resources.set_launch_fault_injector(inj)
        led = _ledger(tmp_path / f"{tag}.jsonl", space)
        try:
            out[tag] = fp.fused_pbt(wl, wave_size=4, oom_backoff=2, ledger=led, **kw)
        finally:
            led.close()
    res, clean = out["oom"], out["clean"]
    (_, fields), = [e for e in _events if e[0] == "oom_backoff"]
    assert (fields["launch_width_before"], fields["launch_width_after"]) == (1, 1)
    assert fields["launch_shape_changed"] is False
    assert (res["launch_width_before"], res["launch_width_after"]) == (1, 1)
    assert res["launch_shape_changed"] is False and res["oom_backoffs"] == 1
    assert res["wave_size"] == 2 and clean["wave_size"] == 4
    _same_sweep(res, clean)
    assert _records(tmp_path / "oom.jsonl") == _records(tmp_path / "clean.jsonl")


def test_smallcnn_backoff_without_a_member_chunk_equals_unfaulted(cnn, _events):
    """The SmallCNN (whose oneDNN convolutions depend on the launch's
    member count) without a member chunk, 8 members in waves of 4 with
    one halving allowed: every launch runs 2 members, so an OOM halving
    to waves of 2 ends in the unfaulted run's digest, curves and unit
    matrix."""
    kw = {k: v for k, v in CNN_KW.items() if k != "member_chunk"}
    clean = fp.fused_pbt(cnn, wave_size=4, oom_backoff=1, **kw)
    inj = OOMAt(2)
    resources.set_launch_fault_injector(inj)
    faulted = fp.fused_pbt(cnn, wave_size=4, oom_backoff=1, **kw)
    assert inj.fired == 1 and faulted["oom_backoffs"] == 1 and faulted["wave_size"] == 2
    assert clean["launch_width"] == faulted["launch_width"] == 2
    assert faulted["launch_shape_changed"] is False
    _same_sweep(faulted, clean)


@pytest.mark.parametrize("n,cap,chunk,backoff,want", [
    (8, 4, 0, 2, 1),  # the smallest cap two halvings reach
    (64, 32, 0, 2, 8),
    (64, 24, 0, 2, 6),
    (8, 3, 0, 3, 1),  # never below one member
    (8, 4, 0, 0, 0),  # nothing halves: a launch is the whole wave
    (8, 8, 0, 2, 0),  # resident
    (8, 0, 0, 2, 0),
    (8, 4, 2, 2, 2),  # a member chunk is the width
])
def test_launch_chunk(n, cap, chunk, backoff, want):
    assert engine.launch_chunk(n, cap, chunk, backoff) == want


def test_result_extras_report_the_launch_width():
    """``launch_width`` is the runner's fixed width from the requested
    cap: a resume that adopts a halved cap keeps it."""
    for cap, chunk, backoff, requested, width in ((32, 0, 2, None, 8), (16, 0, 2, 32, 8),
                                                  (32, 0, 0, None, 32), (32, 8, 2, None, 8)):
        runner = engine.WaveRunner(64, cap, member_chunk=chunk, oom_backoff=backoff,
                                   requested=requested)
        try:
            extras = runner.result_extras()
        finally:
            runner.close()
        assert extras["launch_width"] == width
        assert extras["launch_width_before"] == extras["launch_width_after"] == width
        assert extras["launch_shape_changed"] is False


def test_padding_reaches_no_loss_update_or_score():
    """7 members in chunks of 2: the last chunk runs member 6 and a
    stand-in. Its losses, updates and scores equal those of 8 members
    whose member 7 is a real copy of member 6, and nothing is written
    past member 6."""
    wl = small_workload()
    tr = wl.make_trainer(member_chunk=2, device="cpu")
    d = wl.data()
    x, y = torch.from_numpy(d["train_x"]), torch.from_numpy(d["train_y"]).long()
    st7 = tr.init_population(torch.Generator().manual_seed(0), 7)
    copy8 = lambda t: torch.cat([t, t[6:7]]).clone()
    st8 = population.PopState({k: copy8(v) for k, v in st7.params.items()},
                              {k: copy8(v) for k, v in st7.momentum.items()}, copy8(st7.step))
    hp7 = population.OptHParams.defaults(7, lr=0.05)
    hp8 = population.OptHParams(*(copy8(getattr(hp7, f)) for f in ("lr", "momentum", "weight_decay",
                                                                     "flip_prob", "shift")))
    _, loss7 = tr.train_segment(st7, hp7, x, y, torch.Generator().manual_seed(1), 2)
    gen = torch.Generator().manual_seed(1)
    losses8 = []
    for _ in range(2):
        idx = population.draw_batch(gen, x.shape[0], tr.batch_size)
        aug = population.draw_augment(gen, hp7.flip_prob, hp7.shift, tr.batch_size)
        aug = tuple(copy8(a) for a in aug)
        losses8.append(tr._pop_update(st8, hp8, aug, x[idx], y[idx])[:7].mean())
    assert torch.equal(loss7, torch.stack(losses8))  # the loss mean is over the real members
    for k in st7.params:
        assert torch.equal(st7.params[k], st8.params[k][:7]), k
        assert torch.equal(st7.momentum[k], st8.momentum[k][:7]), k
    assert st7.step.shape == (7,)
    vx, vy = torch.from_numpy(d["val_x"]), torch.from_numpy(d["val_y"]).long()
    assert torch.equal(tr.eval_population(st7, vx, vy), tr.eval_population(st8, vx, vy)[:7])


def test_padded_sha_rungs_equal_the_unchunked_sweep(tmp_path):
    """fashion_mlp (member-count-invariant on the CPU) in chunks of 3
    over rung cohorts of 8, 4 and 2: every rung's last chunk is padded,
    and the sweep, its records and its journal equal the unchunked
    sweep's; the journal holds one record per real member."""
    wl = get_workload("fashion_mlp", n_train=256, n_val=128)
    kw = dict(n_trials=8, min_budget=2, max_budget=8, eta=2, seed=3, device="cpu")
    out = {}
    for chunk in (0, 3):
        led = _ledger(tmp_path / f"c{chunk}.jsonl", wl.default_space(), "asha", 3)
        try:
            out[chunk] = fa.fused_sha(wl, member_chunk=chunk, ledger=led, **kw)
        finally:
            led.close()
    assert out[3]["rung_history"] == out[0]["rung_history"]
    assert out[3]["best_params"] == out[0]["best_params"]
    recs = _records(tmp_path / "c3.jsonl")
    assert recs == _records(tmp_path / "c0.jsonl")
    assert [sum(r["boundary"] == b for r in recs) for b in range(3)] == [8, 4, 2]


@pytest.mark.parametrize("n,cap,chunk,lens", [
    (8, 3, 2, [2, 2, 2, 2]),
    (8, 6, 2, [4, 4]),  # 4 chunks in waves of at most 3: balanced, 2 and 2
    (8, 4, 0, [4, 4]),
    (8, 3, 0, [3, 3, 2]),  # no chunk: the JAX package's split
    (27, 8, 8, [8, 8, 8, 3]),  # only the cohort's last chunk is short
    (256, 48, 32, [32] * 8),
    (256, 64, 32, [64] * 4),
    (7, 4, 2, [4, 3]),
    (3, 1, 2, [2, 1]),  # below one chunk: waves of one chunk
])
def test_wave_layout_holds_whole_chunks(n, cap, chunk, lens):
    got, offs, n_waves = engine.wave_layout(n, cap, chunk)
    assert got == lens and n_waves == len(lens) and sum(got) == n
    assert offs == [sum(lens[:i]) for i in range(len(lens))]
    if chunk:
        assert all(o % chunk == 0 for o in offs)  # every member keeps its chunk and place


@pytest.mark.parametrize("cap,chunk,n,want", [
    (48, 32, 256, 32), (64, 32, 256, 64), (1, 8, 27, 8), (3, 2, 8, 2), (5, 0, 8, 5), (300, 32, 256, 300),
])
def test_whole_chunks(cap, chunk, n, want):
    assert engine.whole_chunks(cap, chunk, n) == want


def test_auto_and_the_preclamp_never_go_below_one_chunk(monkeypatch, _events):
    """A budget that fits less than one chunk's state still gives a cap
    of one chunk, through ``auto`` and the explicit cap's pre-clamp."""
    wl = get_workload("fashion_mlp", n_train=256, n_val=128)
    tr = wl.make_trainer(member_chunk=4, device="cpu")
    monkeypatch.setenv("MPI_OPT_TPU_DEVICE_BYTES", str(tr.member_bytes()))  # 0.35 of one member
    assert staging.estimate_wave_size(tr, 16) == 4
    assert engine.resolve_wave_size(tr, 16, wave_size="auto") == 4
    monkeypatch.setattr("mpi_opt_tpu_torch.obs.memory.measured_budget", lambda device=None: 1)
    assert engine.resolve_wave_size(tr, 16, wave_size=8, oom_backoff=2) == 4
    assert ("wave_resized", {"requested": 8, "wave_size": 4, "population": 16}) in _events


def test_member_flops_count_no_stand_ins():
    """The FLOP count of one member is the same in chunks of 4, where
    the one member would be padded to four."""
    wl = small_workload()
    shape = wl.data()["train_x"].shape[1:]
    assert (wl.make_trainer(member_chunk=4, device="cpu").member_flops(shape)
            == wl.make_trainer(device="cpu").member_flops(shape))


def test_the_cli_lets_the_allocator_expand_segments(monkeypatch):
    """On CUDA, unless the operator set ``PYTORCH_CUDA_ALLOC_CONF``, the
    CLI lets the caching allocator expand segments in place, so memory
    held in reserve tracks allocated memory and a run near the card's
    limit (an OOM-backed-off one) keeps cuDNN's convolution plans."""
    from mpi_opt_tpu_torch import cli

    calls = []
    monkeypatch.setattr(torch._C, "_accelerator_setAllocatorSettings", calls.append, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    assert cli._expandable_segments(None) and calls == ["expandable_segments:True"]
    assert not cli._expandable_segments("cpu")
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "max_split_size_mb:512")
    assert not cli._expandable_segments("cuda") and calls == ["expandable_segments:True"]

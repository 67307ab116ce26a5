"""Wave-scheduled fused PBT in the port (mirrors the JAX package's
``tests/test_fused_waves.py``): with ``wave_size=W < population`` each
generation trains waves of W members staged through host pools, while
the exploit ranks the whole population. On the CPU wave mode is
bit-identical to resident mode: for the MLP at every wave size, and for
the SmallCNN at wave sizes whose member chunks have the resident
shapes (oneDNN picks a convolution's weight-gradient algorithm by its
member count, as cuDNN may on the card). The window of one wave is held
against the JAX package's ``_train_segment_window`` given its draws.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_opt_tpu_torch.train.fused_pbt as fp
from mpi_opt_tpu.models.cnn import SmallCNN as FlaxSmallCNN
from mpi_opt_tpu.train.population import OptHParams as JaxOptHParams
from mpi_opt_tpu.train.population import PopulationTrainer as JaxTrainer
from mpi_opt_tpu_torch import get_workload
from mpi_opt_tpu_torch.health import ShutdownGuard, SweepInterrupted
from mpi_opt_tpu_torch.ledger import SweepLedger, validate_ledger
from mpi_opt_tpu_torch.models import SmallCNN
from mpi_opt_tpu_torch.models.convert import flax_to_torch
from mpi_opt_tpu_torch.ops.pbt import PBTConfig
from mpi_opt_tpu_torch.train import population as pop
from mpi_opt_tpu_torch.utils import integrity
from torch_port_small import small_workload

KW = dict(population=8, generations=3, steps_per_gen=4, seed=2, device="cpu")
FIELDS = ("trial_id", "member", "boundary", "boundary_size", "params", "status", "score", "step")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wl():
    return get_workload("fashion_mlp", n_train=256, n_val=128)


@pytest.fixture(scope="module")
def resident(wl):
    return fp.fused_pbt(wl, **KW)


@pytest.fixture(scope="module")
def waves3(wl):
    return fp.fused_pbt(wl, wave_size=3, **KW)


def _digest(st):
    return integrity.tree_digest({"params": st.params, "momentum": st.momentum, "step": st.step})


def _assert_same_sweep(got, want):
    np.testing.assert_array_equal(got["best_curve"], want["best_curve"])
    np.testing.assert_array_equal(got["mean_curve"], want["mean_curve"])
    np.testing.assert_array_equal(got["unit"], want["unit"])
    assert got["best_score"] == want["best_score"]
    assert got["best_params"] == want["best_params"]
    assert got["member_failures"] == want["member_failures"]
    assert _digest(got["state"]) == _digest(want["state"])


@pytest.mark.parametrize("wave_size,lens", [(1, [1] * 8), (3, [3, 3, 2]), (4, [4, 4]), (5, [4, 4])])
def test_wave_mode_bit_identical_to_resident(wl, resident, wave_size, lens):
    """Wave sizes 1, 3 (not dividing 8: waves [3, 3, 2]), P/2 and 5
    reproduce the resident sweep bit for bit: curves, unit matrix,
    winner, parameters and momentum."""
    wav = fp.fused_pbt(wl, wave_size=wave_size, **KW)
    _assert_same_sweep(wav, resident)
    assert wav["wave_lens"] == lens and wav["n_waves"] == len(lens)
    assert wav["wave_size"] == wave_size and wav["oom_backoffs"] == 0
    assert wav["waves_run"] == KW["generations"] * len(lens)
    assert wav["launch_gens"] == [1] * 3 and len(wav["launch_walls"]) == 3
    # every generation staged the population in and out
    pop_bytes = KW["population"] * wl.make_trainer(device="cpu").member_bytes()
    assert wav["staged_bytes"] >= 2 * KW["generations"] * pop_bytes
    assert wav["stage_transfer_s"] >= 0 and wav["stage_overlap_s"] >= 0 and wav["stage_wait_s"] >= 0


@pytest.mark.parametrize("wave_size", [2, 4, 6])
def test_smallcnn_waves_of_whole_member_chunks_bit_identical(wave_size):
    """The SmallCNN (narrow, 8x8 images) in member chunks of 2: waves of
    2 and 4, and a cap of 6 (waves [4, 4]), give the resident sweep."""
    wl = small_workload()
    kw = dict(population=8, generations=2, steps_per_gen=2, seed=2, device="cpu", member_chunk=2)
    res = fp.fused_pbt(wl, **kw)
    wav = fp.fused_pbt(wl, wave_size=wave_size, **kw)
    _assert_same_sweep(wav, res)


def test_wave_cap_at_or_above_population_runs_resident(wl, resident):
    for cap in (8, 9):
        res = fp.fused_pbt(wl, wave_size=cap, **KW)
        assert "wave_size" not in res and "staged_bytes" not in res
        _assert_same_sweep(res, resident)


def test_full_population_exploit_crosses_wave_boundaries(wl, monkeypatch):
    """Truncation 1/8 (one loser a generation) over waves of 2: the
    loser copies THE population's best member, from another wave through
    the host pool when the seed puts it there."""
    spy = []
    real = fp._wave_exploit

    def recording(generator, unit, scores, disc, cfg):
        out = real(generator, unit, scores, disc, cfg)
        spy.append((scores.numpy().copy(), out[1].numpy().copy()))
        return out

    monkeypatch.setattr(fp, "_wave_exploit", recording)
    wav = fp.fused_pbt(wl, wave_size=2, cfg=PBTConfig(truncation_frac=1 / 8), **KW)
    monkeypatch.undo()
    res = fp.fused_pbt(wl, cfg=PBTConfig(truncation_frac=1 / 8), **KW)
    _assert_same_sweep(wav, res)
    assert len(spy) == KW["generations"]
    crossed = 0
    for scores, src in spy:
        exploited = np.nonzero(src != np.arange(len(src)))[0]
        assert len(exploited) == 1
        for i in exploited:
            assert src[i] == int(np.argmax(scores))  # the global best
            crossed += src[i] // 2 != i // 2
    assert crossed > 0, "the pinned seed should exploit across a wave boundary"


def _crash_at(n):
    real = fp._run_wave
    calls = {"n": 0}

    def crashing(*a, **k):
        calls["n"] += 1
        if calls["n"] == n:
            raise RuntimeError("simulated worker crash")
        return real(*a, **k)

    return crashing


def test_wave_crash_resume_bit_identical(wl, waves3, tmp_path, monkeypatch):
    ckpt = str(tmp_path / "ck")
    monkeypatch.setattr(fp, "_run_wave", _crash_at(5))  # gen 0 = 3 waves; dies inside gen 1
    with pytest.raises(RuntimeError, match="simulated"):
        fp.fused_pbt(wl, wave_size=3, checkpoint_dir=ckpt, **KW)
    monkeypatch.undo()
    assert integrity._committed_steps(ckpt) == [3]
    resumed = fp.fused_pbt(wl, wave_size=3, checkpoint_dir=ckpt, **KW)
    _assert_same_sweep(resumed, waves3)
    assert len(resumed["launch_walls"]) == KW["generations"]
    assert resumed["waves_run"] == 6  # generations 1 and 2


def test_wave_preempt_between_waves_resumes_without_retraining(wl, waves3, tmp_path, monkeypatch):
    """SIGTERM in a generation's middle: the next between-waves boundary
    flushes a mid-generation snapshot (both pools, the scores so far, the
    generator at the generation's start); the resume trains only the
    remaining waves and ends with the unkilled sweep."""
    ckpt = str(tmp_path / "ck")
    real = fp._run_wave
    calls = {"n": 0}

    def preempting(*a, **k):
        calls["n"] += 1
        out = real(*a, **k)
        if calls["n"] == 4:  # gen 1 wave 1 dispatched -> drain at its boundary
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    with ShutdownGuard():
        monkeypatch.setattr(fp, "_run_wave", preempting)
        with pytest.raises(SweepInterrupted) as exc:
            fp.fused_pbt(wl, wave_size=3, checkpoint_dir=ckpt, **KW)
    assert exc.value.at == "pbt gen 2/3 wave 1/3"
    assert integrity._committed_steps(ckpt) == [3, 4]  # gen 0's boundary, then 1*3 + 1
    counting = {"n": 0}

    def counted(*a, **k):
        counting["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(fp, "_run_wave", counted)
    resumed = fp.fused_pbt(wl, wave_size=3, checkpoint_dir=ckpt, **KW)
    assert counting["n"] == 5  # 2 waves left in gen 1 + 3 in gen 2
    assert resumed["waves_run"] == 5
    _assert_same_sweep(resumed, waves3)


def test_wave_corrupt_snapshot_falls_back_bit_identical(wl, waves3, tmp_path, monkeypatch):
    """Killed in generation 2, the newest snapshot (step 6) bit-rotted:
    the restore quarantines it, walks back to generation 0's boundary,
    and the sweep still ends bit-identical."""
    ckpt = str(tmp_path / "ck")
    monkeypatch.setattr(fp, "_run_wave", _crash_at(8))
    with pytest.raises(RuntimeError, match="simulated"):
        fp.fused_pbt(wl, wave_size=3, checkpoint_dir=ckpt, **KW)
    monkeypatch.undo()
    assert integrity._committed_steps(ckpt) == [3, 6]
    path = os.path.join(ckpt, "6", integrity.SWEEP_FILE)
    raw = bytearray(open(path, "rb").read())
    raw[-2000] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    events = []
    integrity.set_observer(lambda event, **f: events.append((event, f["step"])))
    try:
        resumed = fp.fused_pbt(wl, wave_size=3, checkpoint_dir=ckpt, **KW)
    finally:
        integrity.clear_observer()
    assert events == [("snapshot_corrupt", 6)]
    assert integrity.list_quarantined(ckpt) == [os.path.join(ckpt, "6.corrupt")]
    _assert_same_sweep(resumed, waves3)


def test_wave_resume_after_completion_runs_nothing(wl, tmp_path, monkeypatch):
    ckpt = str(tmp_path / "ck")
    first = fp.fused_pbt(wl, wave_size=3, checkpoint_dir=ckpt, **KW)

    def boom(*a, **k):
        raise AssertionError("a completed sweep re-ran a wave")

    monkeypatch.setattr(fp, "_run_wave", boom)
    again = fp.fused_pbt(wl, wave_size=3, checkpoint_dir=ckpt, **KW)
    _assert_same_sweep(again, first)
    assert again["waves_run"] == 0


def test_wave_and_resident_snapshots_refuse_each_other(wl, tmp_path):
    waved, res = str(tmp_path / "waved"), str(tmp_path / "resident")
    fp.fused_pbt(wl, wave_size=3, checkpoint_dir=waved, **KW)
    with pytest.raises(ValueError, match="different sweep"):
        fp.fused_pbt(wl, checkpoint_dir=waved, **KW)
    fp.fused_pbt(wl, checkpoint_dir=res, **KW)
    with pytest.raises(ValueError, match="different sweep"):
        fp.fused_pbt(wl, wave_size=3, checkpoint_dir=res, **KW)
    # another cap is another sweep too
    with pytest.raises(ValueError, match="different sweep"):
        fp.fused_pbt(wl, wave_size=4, checkpoint_dir=waved, **KW)


@pytest.mark.parametrize("extra", [dict(step_chunk=2), dict(gen_chunk=2)])
def test_wave_rejects_launch_chunking(wl, extra):
    with pytest.raises(ValueError, match="ambiguous"):
        fp.fused_pbt(wl, wave_size=3, **extra, **KW)


def test_wave_journal_identical_to_resident(wl, tmp_path):
    """One trajectory, so one record set: a wave run's journal equals the
    resident run's record for record."""
    space = wl.default_space()
    kw = dict(population=6, generations=2, steps_per_gen=3, seed=2, device="cpu")

    def run(path, wave_size):
        led = SweepLedger(str(path))
        led.ensure_header({"mode": "fused", "granularity": "generation", "algorithm": "pbt",
                           "seed": kw["seed"], "space_hash": space.space_hash()})
        res = fp.fused_pbt(wl, wave_size=wave_size, ledger=led, **kw)
        led.close()
        return res

    r_res = run(tmp_path / "resident.jsonl", 0)
    r_wav = run(tmp_path / "waved.jsonl", 4)  # waves [3, 3]
    assert r_res["journal"]["written"] == r_wav["journal"]["written"] == 12
    assert validate_ledger(str(tmp_path / "resident.jsonl")) == []
    assert validate_ledger(str(tmp_path / "waved.jsonl")) == []

    def records(path):
        return [{k: r[k] for k in FIELDS} for r in map(json.loads, open(path).read().splitlines()[1:])]

    assert records(tmp_path / "resident.jsonl") == records(tmp_path / "waved.jsonl")


def test_train_segment_window_rows_equal_the_resident_segment(wl):
    """A wave's window from the interval's start state trains its rows
    exactly as the resident segment does, and leaves the generator where
    the resident segment leaves it."""
    tr = wl.make_trainer(device="cpu")
    space = wl.default_space()
    d = wl.data()
    tx, ty = torch.from_numpy(d["train_x"]), torch.from_numpy(d["train_y"]).long()
    g = torch.Generator()
    g.manual_seed(0)
    hp = wl.make_hparams(space.from_unit(space.sample_unit(g, 6)))
    base = tr.init_population(g, 6)
    start = g.get_state()
    full = pop.PopState({k: v.clone() for k, v in base.params.items()},
                        {k: v.clone() for k, v in base.momentum.items()}, base.step.clone())
    tr.train_segment(full, hp, tx, ty, g, 3)
    end = g.get_state()
    for off, w in ((0, 2), (2, 3), (5, 1)):
        st = pop.PopState({k: v[off:off + w].clone() for k, v in base.params.items()},
                          {k: v[off:off + w].clone() for k, v in base.momentum.items()},
                          base.step[off:off + w].clone())
        g.set_state(start)
        tr.train_segment_window(st, hp, tx, ty, g, 3, off)
        assert torch.equal(g.get_state(), end)
        for k in st.params:
            assert torch.equal(st.params[k], full.params[k][off:off + w]), (off, k)
            assert torch.equal(st.momentum[k], full.momentum[k][off:off + w]), (off, k)
        assert st.step.tolist() == [3] * w


def test_train_segment_window_matches_jax_given_its_draws(monkeypatch):
    """The window against the JAX package's ``_train_segment_window``:
    SmallCNN width 16 on 16x16 images, f32, batch 2, a wave of 2 members
    at offset 2 of 4, two steps. The port is handed JAX's draws (the
    shared batch and the WHOLE population's augmentation each step) and
    must train the same rows with the same members' draws. Tolerance:
    params atol 1e-4, momentum atol 2e-3 after two steps (one step's
    bounds in ``test_torch_cnn.py`` are 1e-5 and 1e-3)."""
    from test_torch_population import _jax_aug_draws

    hw, b, n_total, off, w, steps = 16, 2, 4, 2, 2, 2
    model = FlaxSmallCNN(n_classes=10, width=16, dtype=jnp.float32)
    jt = JaxTrainer(apply_fn=lambda p, x: model.apply({"params": p}, x),
                    init_fn=lambda r, x: model.init(r, x)["params"], batch_size=b)
    full = jt.init_population(jax.random.key(0), jnp.zeros((1, hw, hw, 3)), n_total)
    window = jax.tree.map(lambda a: a[off:off + w], full)
    rng = np.random.default_rng(3)
    tx = rng.standard_normal((16, hw, hw, 3)).astype(np.float32)
    ty = rng.integers(0, 10, 16).astype(np.int32)
    hp = {"lr": [0.1, 0.05, 0.2, 0.02], "momentum": [0.9, 0.5, 0.8, 0.0],
          "weight_decay": [1e-4, 1e-3, 0.0, 1e-2], "flip_prob": [0.5, 0.3, 0.9, 0.1],
          "shift": [2.0, 3.0, 1.0, 4.0]}
    hp = {k: np.asarray(v, np.float32) for k, v in hp.items()}
    key = jax.random.key(5)
    want, _ = jax.jit(jt._train_segment_window, static_argnames=("steps", "n_total"))(
        window, JaxOptHParams(**{k: jnp.asarray(v[off:off + w]) for k, v in hp.items()}),
        jnp.asarray(tx), jnp.asarray(ty), key, steps=steps, n_total=n_total, offset=jnp.int32(off))

    # JAX's draws, step by step, as the port's draw functions return them
    batches, augs = [], []
    k = key
    for _ in range(steps):
        k, k_batch, k_aug = jax.random.split(k, 3)
        batches.append(torch.from_numpy(np.array(jax.random.randint(k_batch, (b,), 0, 16))).long())
        draws = [_jax_aug_draws(km, hp["flip_prob"][m], hp["shift"][m], b)
                 for m, km in enumerate(jax.random.split(k_aug, n_total))]
        augs.append((torch.tensor(np.stack([d[0] for d in draws])),
                     torch.tensor([d[1] for d in draws]), torch.tensor([d[2] for d in draws])))
    monkeypatch.setattr(pop, "draw_batch", lambda g, n, bs: batches.pop(0))

    def full_population_augment(g, flip_prob, shift, bs):
        assert flip_prob.shape == (n_total,)  # the whole population's draws
        return augs.pop(0)

    monkeypatch.setattr(pop, "draw_augment", full_population_augment)
    to_port = lambda tree: flax_to_torch(jax.tree.map(np.asarray, tree), stacked=True)
    st = pop.PopState(to_port(window.params), to_port(window.momentum), torch.zeros(w, dtype=torch.int32))
    trainer = pop.PopulationTrainer(
        lambda p, dev: SmallCNN(n_classes=10, width=16, dtype=torch.float32, population=p,
                                image_size=hw, device=dev),
        batch_size=b, device="cpu")
    trainer.train_segment_window(st, pop.OptHParams(**{k: torch.from_numpy(v) for k, v in hp.items()}),
                                 torch.from_numpy(tx), torch.from_numpy(ty).long(),
                                 torch.Generator(), steps, off)
    assert not batches and not augs
    ref_p, ref_m = to_port(want.params), to_port(want.momentum)
    for name in ref_p:
        np.testing.assert_allclose(st.params[name].numpy(), ref_p[name].numpy(), atol=1e-4, err_msg=name)
        np.testing.assert_allclose(st.momentum[name].numpy(), ref_m[name].numpy(), atol=2e-3, err_msg=name)
    assert st.step.tolist() == [steps] * w

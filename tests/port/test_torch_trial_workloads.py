"""The per-trial workloads of the port against the JAX package's:

- ``quadratic`` (``workloads/synthetic.py``): scores and states bit-equal;
- ``digits`` (``DigitsLogReg``): the data split bit-equal to JAX's
  ``_data(seed)``; ``evaluate`` and ``evaluate_multi`` against the live
  JAX workload (scikit-learn's ``LogisticRegression`` here) on
  ``BASELINE.json`` config 1's 16 trials. Tolerance: the same accuracy
  on at least 15 of the 16, every trial within 2 of the 450 validation
  rows, ``params`` within 2% (the port fits with scipy's L-BFGS-B in
  scikit-learn's dtypes, without scikit-learn);
- the CLI's config 1 (``--backend cpu --workload digits``) against the
  JAX CLI, the port's random search fed JAX's draws: the same tolerance
  on each trial's score;
- ``PopulationWorkload.evaluate``, one member of the narrow SmallCNN of
  ``torch_port_small.py`` trained from scratch, against the JAX
  ``evaluate`` of the same network fed the same draws (JAX's initial
  weights and batch/augmentation draws handed to the port). Tolerance:
  the trained parameters within 1e-2 absolute (bf16 activations on two
  compilers), the update they took (trained minus initial weights)
  within 0.15 of JAX's by relative norm (measured 0.048; the same run
  with its learning rate halved reads 0.52 and must fail), the accuracy
  within 2 of the 128 validation images (a near-tie argmax may flip).
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_opt_tpu.workloads.digits as jdigits
import mpi_opt_tpu_torch.train.population as tpop
from mpi_opt_tpu.algorithms import RandomSearch as JaxRandomSearch
from mpi_opt_tpu.models.cnn import SmallCNN as FlaxSmallCNN
from mpi_opt_tpu.workloads import get_workload as jax_get_workload
from mpi_opt_tpu.workloads.vision import Cifar10CNN as JaxCifar10CNN
from mpi_opt_tpu_torch.models.convert import flax_to_torch
from mpi_opt_tpu_torch.workloads import digits as tdigits
from mpi_opt_tpu_torch.workloads import get_workload
from torch_port_small import small_workload

N_VAL = 450  # digits' validation rows (25% of 1797, rounded up)
UPDATE_RTOL = 0.15  # the per-trial update against JAX's, by relative norm


@pytest.mark.parametrize("params", [{"lr": 0.5, "reg": 0.3}, {"lr": 1.0, "reg": 0.9},
                                    {"lr": 3.7, "reg": 0.0}, {"lr": 1e-3, "reg": 0.5}])
@pytest.mark.parametrize("seed", [0, 4])
def test_quadratic_bit_equal_to_jax(params, seed):
    ours, ref = get_workload("quadratic"), jax_get_workload("quadratic")
    assert ours.stateful and ours.default_space().spec() == ref.default_space().spec()
    for budget in (0, 7, 100):
        assert ours.evaluate(params, budget, seed) == ref.evaluate(params, budget, seed)
    s, score = ours.train(ours.init_state(params, seed), params, 5, seed)
    js, jscore = ref.train(ref.init_state(params, seed), params, 5, seed)
    assert score == jscore and s.steps == js.steps and np.array_equal(s.w, js.w)


@pytest.mark.parametrize("seed", [0, 3])
def test_digits_split_bit_equal_to_jax(seed):
    for a, b in zip(tdigits._data(seed), jdigits._data(seed)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _config1_params():
    """Config 1's 16 trials: random search, seed 0, the JAX package's draws."""
    space = jax_get_workload("digits").default_space()
    return [{k: v for k, v in t.params.items() if not k.startswith("__")}
            for t in JaxRandomSearch(space, seed=0, max_trials=16, budget=100).next_batch(16)]


def _assert_scores_agree(ours, ref):
    rows = [abs(a - b) * N_VAL for a, b in zip(ours, ref)]
    assert sum(a == b for a, b in zip(ours, ref)) >= 15, (ours, ref)
    assert max(rows) <= 2 + 1e-9, rows


def test_digits_logreg_against_scikit_learn_on_config1():
    ours, ref = get_workload("digits"), jax_get_workload("digits")
    assert ours.default_space().spec() == ref.default_space().spec()
    assert ours.objective_metrics() == ref.objective_metrics()
    params = _config1_params()
    _assert_scores_agree([ours.evaluate(p, 100, 0) for p in params],
                         [ref.evaluate(p, 100, 0) for p in params])
    names = ("accuracy", "params", "latency")
    for p in params[:6]:
        got, want = ours.evaluate_multi(p, 100, 0, names), ref.evaluate_multi(p, 100, 0, names)
        assert abs(got["accuracy"] - want["accuracy"]) * N_VAL <= 2 + 1e-9
        assert got["params"] == pytest.approx(want["params"], rel=0.02)
        assert got["latency"] == pytest.approx(want["latency"], rel=0.02, abs=1e-9)
    with pytest.raises(ValueError, match="unknown digits objective"):
        ours.evaluate_multi(params[0], 5, 0, ("flops",))


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]


def test_cli_config1_against_the_jax_cli(tmp_path, monkeypatch):
    """``--backend cpu --workload digits --algorithm random --trials 16
    --budget 100 --workers 1`` through both CLIs (inline: one worker),
    the port's random search fed JAX's draws: per-trial scores agree."""
    import torch_port_jax_draws
    from mpi_opt_tpu.cli import main as jax_main
    from mpi_opt_tpu_torch.cli import main

    argv = ["--backend", "cpu", "--workload", "digits", "--algorithm", "random", "--trials", "16",
            "--budget", "100", "--workers", "1"]
    rc, jout = _run(jax_main, [*argv, "--ledger", str(tmp_path / "jax.jsonl")])
    assert rc == 0
    torch_port_jax_draws.install(monkeypatch)
    rc, out = _run(main, [*argv, "--ledger", str(tmp_path / "port.jsonl")])
    assert rc == 0
    summary = out[-1]
    assert summary["backend"] == "cpu" and summary["n_trials"] == 16
    recs = {}
    for name in ("jax", "port"):
        with open(tmp_path / f"{name}.jsonl") as f:
            lines = [json.loads(x) for x in f]
        recs[name] = sorted((r for r in lines if "trial_id" in r), key=lambda r: r["trial_id"])
    assert [r["trial_id"] for r in recs["port"]] == list(range(16))
    for a, b in zip(recs["port"], recs["jax"]):
        assert a["params"].keys() == b["params"].keys() and a["status"] == b["status"] == "ok"
        for k, v in a["params"].items():  # LogUniform's f32 exp: at most an ulp apart
            assert v == pytest.approx(b["params"][k], rel=1e-6)
    _assert_scores_agree([r["score"] for r in recs["port"]], [r["score"] for r in recs["jax"]])


class _JaxNarrowCNN(JaxCifar10CNN):
    """``torch_port_small.NarrowCNN`` in the JAX package: the SmallCNN at
    width 16 on every fourth pixel, batch 32."""

    batch_size = 32

    def data(self):
        if self._data is None:
            d = dict(super().data())
            for k in ("train_x", "val_x"):
                d[k] = np.ascontiguousarray(d[k][:, ::4, ::4, :])
            self._data = d
        return self._data

    def _model(self, n_classes):
        return FlaxSmallCNN(n_classes=n_classes, width=16)


def test_population_evaluate_against_jax_given_its_draws(monkeypatch):
    seed, budget = 5, 3
    ref = _JaxNarrowCNN(n_train=512, n_val=128)
    ours = small_workload()
    ours.set_eval_device("cpu")
    params = {"lr": 0.05, "momentum": 0.9, "weight_decay": 1e-4, "flip_prob": 0.25, "shift": 2.0}
    want = ref.evaluate(params, budget, seed)
    jtrainer, jstate, _, _ = ref._eval_state(params, budget, seed)

    # JAX's draws of _eval_state: key(seed) split into init and train keys
    k_init, k = jax.random.split(jax.random.key(seed))
    d = ref.data()
    init = jtrainer.init_population(k_init, jnp.asarray(d["train_x"][:2]), 1)
    batches, augs = [], []
    for _ in range(budget):
        k, k_batch, k_aug = jax.random.split(k, 3)
        batches.append(torch.from_numpy(np.array(
            jax.random.randint(k_batch, (ref.batch_size,), 0, d["train_x"].shape[0]))).long())
        member_key = jax.random.split(k_aug, 1)[0]
        k_flip, k_dy, k_dx = jax.random.split(member_key, 3)
        flip = jax.random.bernoulli(k_flip, params["flip_prob"], (ref.batch_size, 1, 1, 1))
        dy, dx = (jnp.round(jax.random.uniform(kk, (), minval=-params["shift"],
                                               maxval=params["shift"])).astype(jnp.int32)
                  for kk in (k_dy, k_dx))
        augs.append((torch.from_numpy(np.array(flip).reshape(1, -1)), torch.tensor([int(dy)]),
                     torch.tensor([int(dx)])))
    to_port = lambda tree: flax_to_torch(jax.tree.map(np.asarray, tree), stacked=True)

    def init_population(self, generator, n):
        assert n == 1
        p = to_port(init.params)
        return tpop.PopState(p, {k: torch.zeros_like(v) for k, v in p.items()},
                             torch.zeros(1, dtype=torch.int32))

    monkeypatch.setattr(tpop.PopulationTrainer, "init_population", init_population)

    def with_draws(fn):
        queue_b, queue_a = list(batches), list(augs)
        monkeypatch.setattr(tpop, "draw_batch", lambda g, n, b: queue_b.pop(0))
        monkeypatch.setattr(tpop, "draw_augment", lambda g, f, s, b: queue_a.pop(0))
        out = fn(params, budget, seed)
        assert not queue_b and not queue_a  # every draw consumed
        return out

    acc = with_draws(ours.evaluate)
    assert abs(acc - want) * 128 <= 2 + 1e-9, (acc, want)
    _, state, _, _ = with_draws(ours._eval_state)
    got_params = to_port(jstate.params)
    for name, v in state.params.items():
        np.testing.assert_allclose(v.float().numpy(), got_params[name].float().numpy(), atol=1e-2,
                                   err_msg=name)
    assert state.params[name].device.type == "cpu"
    p0 = to_port(init.params)
    assert _update_rel(p0, state.params, got_params) <= UPDATE_RTOL
    # a planted fault, the learning rate halved, fails the same check
    _, halved, _, _ = with_draws(lambda p, b, s: ours._eval_state({**p, "lr": p["lr"] / 2}, b, s))
    assert _update_rel(p0, halved.params, got_params) > UPDATE_RTOL


def _update_rel(init, got, want):
    """``||(got - init) - (want - init)|| / ||want - init||`` over all the
    weights at once (float64)."""
    num = sum(float((got[k].double() - want[k].double()).square().sum()) for k in want)
    den = sum(float((want[k].double() - init[k].double()).square().sum()) for k in want)
    return (num / den) ** 0.5

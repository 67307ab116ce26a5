"""The port's multi-objective pieces against the JAX package's, called live.

- ``ObjectiveSpec``: parse, the durable form and its round trip, the
  maximize-form bounds and signs, ``normalize``/``scalarize`` on numpy
  (equal to JAX's) and on torch (a tensor back, same dtype and values),
  the parse refusals, ``parse_constraint``.
- The ranking on the device: ``pareto_rank``, ``crowding_distance`` and
  ``pareto_score`` on seeded matrices (n in {1, 2, 7, 33, 64}, m in {1,
  2, 3}) with duplicate rows, ties planted in the crowding sort's
  composite key (a coarse value grid), NaN and inf rows, a ``valid`` mask
  and bounds: ranks exact, crowding and ``eff`` bit-equal (every op is
  the same IEEE f32 operation in the same order; the sort is stable, as
  ``jnp.argsort`` is).
- The host helpers ``pareto_front_mask``, ``hypervolume`` and
  ``select_best`` (feasible, least_violation, diverged) equal JAX's.
- ``pbt_exploit_explore_mo`` fed JAX's draws: ``src_idx``, ``bottom``,
  the unit matrix and ``eff`` exact; ``asha_cut_mo``: ``promote``,
  ``order`` and ``eff`` exact.
- ``member_effective_params``/``member_latency_proxy`` equal JAX's
  exactly on weights carried across (the digits MLP and the narrow
  SmallCNN of ``torch_port_small.py``), values planted at the
  thresholds' f32 neighbours; a non-finite weight gives NaN; a member
  chunk that pads counts no stand-in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_opt_tpu.objectives import ObjectiveSpec as JaxSpec
from mpi_opt_tpu.objectives import pareto as jp
from mpi_opt_tpu.objectives import parse_constraint as jax_parse_constraint
from mpi_opt_tpu.ops import PBTConfig as JaxPBTConfig
from mpi_opt_tpu.ops.asha import asha_cut_mo as jax_asha_cut_mo
from mpi_opt_tpu.ops.pbt import pbt_exploit_explore_mo as jax_pbt_mo
from mpi_opt_tpu.train.population import PopState as JaxPopState
from mpi_opt_tpu.workloads import get_workload as jax_get_workload
from mpi_opt_tpu_torch import get_workload
from mpi_opt_tpu_torch.models.convert import flax_to_torch
from mpi_opt_tpu_torch.objectives import ObjectiveSpec, parse_constraint
from mpi_opt_tpu_torch.objectives import pareto as tp
from mpi_opt_tpu_torch.ops.asha import asha_cut_mo
from mpi_opt_tpu_torch.ops.pbt import (
    PBTConfig,
    apply_exploit_explore,
    n_cut,
    pbt_exploit_explore,
    pbt_exploit_explore_mo,
)
from mpi_opt_tpu_torch.train.common import eval_population_objectives
from mpi_opt_tpu_torch.train.population import PopState, PopulationTrainer

SPECS = [
    "accuracy:max,params:min",
    "accuracy",
    "accuracy:max>=0.5,params:min<=2e4,latency:min",
    " params : min <= 100 , accuracy ",
    "latency:min<=0.01",
]


# -- the spec ------------------------------------------------------------------


@pytest.mark.parametrize("text", SPECS)
def test_spec_parse_and_durable_form_equal_jax(text):
    got, want = ObjectiveSpec.parse(text), JaxSpec.parse(text)
    assert got.spec() == want.spec()
    assert got.names == want.names and got.m == want.m and got.has_bounds == want.has_bounds
    assert ObjectiveSpec.from_spec(got.spec()) == got
    assert ObjectiveSpec.from_spec(want.spec()).spec() == want.spec()
    np.testing.assert_array_equal(got.signs(), want.signs())
    np.testing.assert_array_equal(got.norm_bounds(), want.norm_bounds())
    assert got.norm_bounds().dtype == want.norm_bounds().dtype == np.float32


@pytest.mark.parametrize("text", SPECS)
def test_spec_normalize_and_scalarize_numpy_and_torch(text):
    got, want = ObjectiveSpec.parse(text), JaxSpec.parse(text)
    raw = np.random.default_rng(0).normal(size=(5, got.m)).astype(np.float32)
    raw[1, 0] = np.nan
    for x in (raw, raw.astype(np.float64)):
        np.testing.assert_array_equal(got.normalize(x), want.normalize(x))
        np.testing.assert_array_equal(got.scalarize(x), want.scalarize(x))
        assert got.normalize(x).dtype == want.normalize(x).dtype
    t = torch.from_numpy(raw)
    norm = got.normalize(t)
    assert isinstance(norm, torch.Tensor) and norm.dtype == torch.float32 and norm.device == t.device
    np.testing.assert_array_equal(norm.numpy(), np.asarray(want.normalize(jnp.asarray(raw))))
    prim = got.scalarize(t)
    assert isinstance(prim, torch.Tensor)
    np.testing.assert_array_equal(prim.numpy(), np.asarray(want.scalarize(jnp.asarray(raw))))


@pytest.mark.parametrize("text", [
    "", "accuracy,,params", "accuracy:up", "accuracy:max<=0.5", "params:min>=3", "params:min<=abc",
    "accuracy,accuracy", "9lives", "params:min<=inf",
])
def test_spec_refuses_what_jax_refuses(text):
    with pytest.raises(ValueError):
        JaxSpec.parse(text)
    with pytest.raises(ValueError):
        ObjectiveSpec.parse(text)


@pytest.mark.parametrize("text", ["params<=2e4", " accuracy >= 0.9 ", "latency<=1"])
def test_parse_constraint_equals_jax(text):
    assert parse_constraint(text) == jax_parse_constraint(text)
    with pytest.raises(ValueError):
        parse_constraint(text.replace("=", ""))


# -- the ranking on the device ------------------------------------------------


def _matrix(n, m, seed):
    """Maximize-form scores on a quarter grid (ties in every column and in
    the crowding sort's composite key), a duplicated row, and NaN, +inf
    and -inf rows."""
    rng = np.random.default_rng(seed)
    s = (rng.integers(0, 5, (n, m)) / 4).astype(np.float32)
    if n >= 3:
        s[1] = s[0]
    if n >= 7:
        s[2, rng.integers(m)] = np.nan
        s[4, 0] = np.inf
        s[5, m - 1] = -np.inf
    return s


def _variant(kind, n, m, seed):
    rng = np.random.default_rng(seed + 1)
    valid = rng.random(n) < 0.75 if kind in ("valid", "both") else None
    bounds = (np.array([0.25, -np.inf, -0.5], np.float32)[:m] if kind in ("bounds", "both")
              else None)
    return valid, bounds


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


# the reference's ranking as its sweeps run it: compiled (one program a
# shape, where op-by-op dispatch would compile every op a shape)
_J_RANK = jax.jit(jp.pareto_rank)
_J_CROWD = jax.jit(jp.crowding_distance)
_J_SCORE = jax.jit(jp.pareto_score)


def _ranking_both_ways(s, valid, bounds):
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    j_rank = np.asarray(_J_RANK(jnp.asarray(s), jv))
    t_rank = tp.pareto_rank(torch.from_numpy(s), tv)
    np.testing.assert_array_equal(t_rank.numpy(), j_rank)
    j_crowd = _J_CROWD(jnp.asarray(s), jnp.asarray(j_rank), jv)
    t_crowd = tp.crowding_distance(torch.from_numpy(s), t_rank, tv)
    np.testing.assert_array_equal(_bits(t_crowd.numpy()), _bits(j_crowd))
    j_eff = _J_SCORE(jnp.asarray(s), jv, None if bounds is None else jnp.asarray(bounds))
    t_eff = tp.pareto_score(torch.from_numpy(s), tv, bounds)
    assert t_eff.dtype == torch.float32
    np.testing.assert_array_equal(_bits(t_eff.numpy()), _bits(j_eff))
    # the order the selection sites read: exact, ties in index order
    j_order = np.asarray(jnp.argsort(-j_eff))
    np.testing.assert_array_equal(torch.argsort(-t_eff, stable=True).numpy(), j_order)


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 2, 7, 33, 64])
def test_ranking_equals_jax(n, m):
    """A ``valid`` mask and bounds at every shape."""
    valid, bounds = _variant("both", n, m, n + m)
    _ranking_both_ways(_matrix(n, m, n * 7 + m), valid, bounds)


@pytest.mark.parametrize("kind", ["plain", "valid", "bounds"])
def test_ranking_without_mask_or_bounds_equals_jax(kind):
    n, m = 33, 2
    valid, bounds = _variant(kind, n, m, n + m)
    _ranking_both_ways(_matrix(n, m, n * 7 + m), valid, bounds)


def test_ranking_takes_bounds_as_a_device_tensor():
    s = _matrix(33, 3, 5)
    b = np.array([0.25, -np.inf, -0.5], np.float32)
    t = torch.from_numpy(s)
    np.testing.assert_array_equal(tp.pareto_score(t, norm_bounds=torch.from_numpy(b)).numpy(),
                                  tp.pareto_score(t, norm_bounds=b).numpy())


def test_pareto_score_orders_fronts_then_infeasible_then_diverged():
    s = np.array([[1, 0], [0, 1], [0.5, 0.5], [0, 0], [np.nan, 1], [0.9, -1]], np.float32)
    eff = tp.pareto_score(torch.from_numpy(s), norm_bounds=np.array([-np.inf, -0.5], np.float32))
    rank = eff.numpy()
    assert rank[:3].min() > rank[3] > -1  # front 0, then front 1 (a lone point: -1 + 0.5)
    assert rank[5] < -len(s)  # infeasible: below every feasible row
    assert rank[4] == -np.inf  # diverged


# -- host helpers ---------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_front_mask_and_hypervolume_equal_jax(m, seed):
    s = _matrix(33, m, seed)
    np.testing.assert_array_equal(tp.pareto_front_mask(s), jp.pareto_front_mask(s))
    valid = np.random.default_rng(seed).random(33) < 0.6
    np.testing.assert_array_equal(tp.pareto_front_mask(s, valid), jp.pareto_front_mask(s, valid))
    front = s[tp.pareto_front_mask(s)] + np.random.default_rng(seed).random((1, m))
    assert tp.hypervolume(front) == jp.hypervolume(front)
    ref = np.full(m, -2.0)
    assert tp.hypervolume(front, ref) == jp.hypervolume(front, ref)
    assert tp.hypervolume(np.zeros((0, m))) == jp.hypervolume(np.zeros((0, m))) == 0.0


@pytest.mark.parametrize("text,rows,kind", [
    ("accuracy:max,params:min", [[0.5, 100], [0.9, 300], [0.9, 200], [np.nan, 1]], "feasible"),
    ("accuracy:max,params:min<=150", [[0.5, 100], [0.9, 300], [0.6, 120]], "feasible"),
    ("accuracy:max,params:min<=1", [[0.5, 100], [0.9, 300], [0.7, 100]], "least_violation"),
    ("accuracy:max>=0.95,params:min<=50", [[0.5, 100], [0.9, 60], [0.8, 40]], "least_violation"),
    ("accuracy:max,params:min", [[np.nan, 100], [0.9, np.inf]], "diverged"),
])
def test_select_best_equals_jax(text, rows, kind):
    scores = np.asarray(rows, dtype=np.float64)
    got = tp.select_best(scores, ObjectiveSpec.parse(text))
    assert got == jp.select_best(scores, JaxSpec.parse(text))
    assert got["kind"] == kind


# -- the exploit and the rung cut ---------------------------------------------


def _jax_draws(key, n, d, cfg):
    """The draws of the JAX package's ``_exploit_explore``, in its key order."""
    k_src, k_noise, k_res, k_res_val = jax.random.split(key, 4)
    return (torch.from_numpy(np.array(jax.random.randint(k_src, (n,), 0, n_cut(n, cfg)))).long(),
            torch.from_numpy(np.array(jax.random.normal(k_noise, (n, d)))),
            torch.from_numpy(np.array(jax.random.uniform(k_res, (n, d)))),
            torch.from_numpy(np.array(jax.random.uniform(k_res_val, (n, d)))))


_J_CUT_MO = jax.jit(jax_asha_cut_mo, static_argnames=("eta",))


@pytest.mark.parametrize("n,m,bounded,seed", [(16, 2, False, 0), (33, 3, True, 1)])
def test_pbt_exploit_explore_mo_given_jax_draws(n, m, bounded, seed):
    d = 4
    rng = np.random.default_rng(seed)
    unit = rng.random((n, d), dtype=np.float32)
    norm = _matrix(n, m, seed)
    bounds = np.array([0.25, -np.inf, -0.5], np.float32)[:m] if bounded else None
    disc = np.array([False, True, False, True])
    key = jax.random.key(seed)
    kw = dict(truncation_frac=0.25, perturb_scale=0.3, resample_prob=0.5)
    # op by op, as the scalar exploit's parity test calls it: compiled,
    # XLA contracts the perturbation's multiply-add into one rounding
    j_unit, j_src, j_bottom, j_eff = jax_pbt_mo(key, jnp.asarray(unit), jnp.asarray(norm),
                                                jnp.asarray(disc), JaxPBTConfig(**kw),
                                                norm_bounds=bounds)
    cfg = PBTConfig(**kw)
    eff = tp.pareto_score(torch.from_numpy(norm), norm_bounds=bounds)
    np.testing.assert_array_equal(_bits(eff.numpy()), _bits(j_eff))
    new_unit, src, bottom = apply_exploit_explore(torch.from_numpy(unit), eff, disc, cfg,
                                                  _jax_draws(key, n, d, cfg))
    np.testing.assert_array_equal(src.numpy(), np.asarray(j_src))
    np.testing.assert_array_equal(bottom.numpy(), np.asarray(j_bottom))
    np.testing.assert_array_equal(new_unit.numpy(), np.asarray(j_unit))
    # the port's own entry point: the Pareto score, then the scalar
    # decision with the same draws in the same order
    g1, g2 = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
    got = pbt_exploit_explore_mo(g1, torch.from_numpy(unit), torch.from_numpy(norm), disc, cfg,
                                 norm_bounds=bounds)
    want = pbt_exploit_explore(g2, torch.from_numpy(unit), eff, disc, cfg)
    for a, b in zip(got[:3], want):
        assert torch.equal(a, b)
    assert torch.equal(got[3], eff)
    assert torch.equal(g1.get_state(), g2.get_state())


@pytest.mark.parametrize("n,m,eta,kind", [(7, 2, 3, "plain"), (33, 3, 3, "both"), (64, 2, 4, "bounds"),
                                          (2, 1, 2, "valid")])
def test_asha_cut_mo_equals_jax(n, m, eta, kind):
    norm = _matrix(n, m, n + eta)
    valid, bounds = _variant(kind, n, m, n)
    j_prom, j_order, j_eff = _J_CUT_MO(jnp.asarray(norm), eta,
                                       None if valid is None else jnp.asarray(valid),
                                       norm_bounds=None if bounds is None else jnp.asarray(bounds))
    prom, order, eff = asha_cut_mo(torch.from_numpy(norm), eta,
                                   None if valid is None else torch.from_numpy(valid),
                                   norm_bounds=bounds)
    np.testing.assert_array_equal(prom.numpy(), np.asarray(j_prom))
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    np.testing.assert_array_equal(_bits(eff.numpy()), _bits(j_eff))


# -- the member metrics --------------------------------------------------------


def _plant(params: dict, leaf_path, nan_member=None, inf_member=None):
    """Values at the thresholds and their f32 neighbours in one leaf of
    every member; a NaN and an inf weight in two members."""
    f32 = np.float32
    near = [f32(1e-3), np.nextafter(f32(1e-3), f32(1)), np.nextafter(f32(1e-3), f32(0)), -f32(1e-3),
            f32(1e-2), np.nextafter(f32(1e-2), f32(1)), -np.nextafter(f32(1e-2), f32(0)), f32(0)]
    node = params
    for k in leaf_path[:-1]:
        node = node[k]
    leaf = node[leaf_path[-1]]
    for p in range(leaf.shape[0]):
        leaf[p].flat[p:p + len(near)] = near
    if nan_member is not None:
        leaf[nan_member].flat[-1] = np.nan
    if inf_member is not None:
        leaf[inf_member].flat[-2] = -np.inf


@pytest.fixture(scope="module")
def jax_digits():
    """The JAX digits_mlp workload and trainer: ``member_effective_params``
    reads only the state, so this trainer is the oracle for any model."""
    jwl = jax_get_workload("digits_mlp")
    return jwl, jwl.make_trainer()


def _counts_both_ways(jax_trainer, params, n):
    jstate = JaxPopState(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, params),
                         jnp.zeros((n,), jnp.int32))
    want = (np.asarray(jax_trainer.member_effective_params(jstate)),
            np.asarray(jax_trainer.member_latency_proxy(jstate)))
    state = PopState(flax_to_torch(params, stacked=True), {}, torch.zeros(n, dtype=torch.int32))
    got = (PopulationTrainer.member_effective_params(state).numpy(),
           PopulationTrainer.member_latency_proxy(state).numpy())
    return got, want


def test_member_metrics_equal_jax_digits_mlp(jax_digits):
    jwl, trainer = jax_digits
    st = trainer.init_population(jax.random.key(0), jnp.asarray(jwl.data()["train_x"][:2]), 5)
    params = jax.tree.map(np.array, st.params)
    _plant(params, ("fc1", "kernel"), nan_member=2)
    params["fc2"]["bias"] += 0.004  # a leaf between the two thresholds
    got, want = _counts_both_ways(trainer, params, 5)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert np.isnan(got[0][2]) and np.isfinite(np.delete(got[0], 2)).all()


def test_member_metrics_equal_jax_small_cnn(jax_digits):
    """The narrow SmallCNN's flax leaves (one init; the other members its
    weights scaled, so counts differ), carried across to the port's
    OIHW and ``[out, in]`` layouts: the same counts."""
    from mpi_opt_tpu.models.cnn import SmallCNN as FlaxSmallCNN

    from mpi_opt_tpu_torch.models import SmallCNN

    from torch_port_small import NarrowCNN

    n = 3
    one = jax.jit(FlaxSmallCNN(n_classes=10, width=NarrowCNN.width).init)(
        jax.random.key(0), jnp.zeros((1, 8, 8, 3)))["params"]
    params = jax.tree.map(lambda x: np.stack([np.asarray(x) * f for f in (1.0, 0.05, 0.004)]), one)
    _plant(params, ("conv2", "kernel"), inf_member=1)
    params["gn1"]["scale"][0, :4] = 1e-3  # a GN scale at the threshold
    got, want = _counts_both_ways(jax_digits[1], params, n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert np.isnan(got[0][1]) and np.isnan(got[1][1]) and len(set(got[0].tolist())) == 3
    # the port's parameters are flax's leaves, member for member
    port = SmallCNN(n_classes=10, width=NarrowCNN.width, image_size=8, device="meta")
    assert sorted(p.numel() for p in port.parameters()) == sorted(
        np.asarray(x).size for x in jax.tree.leaves(one))


def test_member_chunk_stand_ins_are_not_counted():
    """Six members in launches of four (two stand-ins in the second):
    the objective columns have six rows, each member's count is its own
    (as counted alone) and equals the unchunked trainer's."""
    wl = get_workload("digits_mlp")
    chunked = wl.make_trainer(member_chunk=4, device="cpu")
    whole = wl.make_trainer(device="cpu")
    state = chunked.init_population(torch.Generator().manual_seed(0), 6)
    val_x = torch.from_numpy(wl.data()["val_x"])
    val_y = torch.from_numpy(wl.data()["val_y"]).long()
    names = ("accuracy", "params", "latency")
    mo = eval_population_objectives(chunked, state, val_x, val_y, names)
    ref = eval_population_objectives(whole, state, val_x, val_y, names)
    assert mo.shape == (6, 3)
    assert torch.equal(mo[:, 1:], ref[:, 1:])
    for i in range(6):
        one = PopState({k: v[i:i + 1] for k, v in state.params.items()}, {}, state.step[i:i + 1])
        assert float(PopulationTrainer.member_effective_params(one)[0]) == float(mo[i, 1])

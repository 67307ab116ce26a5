"""The port's ``('pop', 'data')`` mesh (``parallel/mesh.py``) against the
JAX package's, in one process: shapes and errors against the JAX
``make_mesh`` on the pytest process's 8 virtual CPU devices (one port
rank a device), the rank layout, row slicing, the replication warning's
text, the world-of-one identities, the backend choice, and the SHA rung
rounding (``round_to``). The collectives themselves run in
``test_torch_multiprocess.py`` (2 gloo ranks)."""

import warnings

import jax
import numpy as np
import pytest
import torch

from mpi_opt_tpu.parallel import mesh as jmesh
from mpi_opt_tpu.train.fused_asha import sha_cohort_sizes as jax_sha_cohort_sizes
from mpi_opt_tpu_torch.parallel import mesh as tmesh
from mpi_opt_tpu_torch.train.fused_asha import sha_cohort_sizes

WORLD = 8  # tests/conftest.py's virtual CPU devices


@pytest.mark.parametrize("n_pop,n_data", [(4, 2), (None, 2), (None, 1), (8, 1), (2, 4), (1, 8),
                                          (None, 3), (16, 1), (None, 5), (3, 3)])
def test_make_mesh_shape_and_errors_as_jax(n_pop, n_data):
    assert len(jax.devices()) == WORLD
    try:
        want = dict(jmesh.make_mesh(n_pop=n_pop, n_data=n_data).shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.mesh_shape(WORLD, n_pop, n_data)
        assert str(got.value) == str(e)
        return
    got = tmesh.mesh_shape(WORLD, n_pop, n_data)
    assert {"pop": got[0], "data": got[1]} == want


def test_a_rank_outside_the_mesh_is_refused():
    # a JAX mesh may leave devices out; a port rank outside the mesh
    # would have no rows, so every rank must be in it
    assert dict(jmesh.make_mesh(n_pop=2, n_data=2).shape) == {"pop": 2, "data": 2}
    with pytest.raises(ValueError, match="uses 4 of 8 ranks"):
        tmesh.mesh_shape(WORLD, 2, 2)


@pytest.mark.parametrize("n_pop,n_data", [(4, 2), (2, 4), (8, 1), (1, 8)])
def test_rank_layout_keeps_data_innermost_as_jax(n_pop, n_data):
    grid = jmesh.make_mesh(n_pop=n_pop, n_data=n_data).devices
    for p in range(n_pop):
        for d in range(n_data):
            rank = grid[p][d].id  # one port rank a device, in device order
            m = tmesh.Mesh(n_pop, n_data, rank=rank, world=WORLD)
            assert (m.pop_index, m.data_index) == (p, d)
            assert m.pop_ranks == [grid[q][d].id for q in range(n_pop)]


@pytest.mark.parametrize("n,n_pop", [(16, 2), (16, 4), (8, 8), (6, 2), (12, 4)])
def test_rows_are_contiguous_slices_in_pop_order(n, n_pop):
    ms = [tmesh.Mesh(n_pop, 1, rank=r, world=n_pop) for r in range(n_pop)]
    rows = [m.rows(n) for m in ms]
    assert rows[0][0] == 0 and rows[-1][1] == n
    assert all(rows[i][1] == rows[i + 1][0] for i in range(n_pop - 1))
    assert all(b - a == n // n_pop for a, b in rows)
    x = torch.arange(n)
    parts = [x[slice(*m.rows(n))] for m in ms]
    assert torch.equal(torch.cat(parts), x)
    for i in range(n):
        assert rows[ms[0].owner(i, n)][0] <= i < rows[ms[0].owner(i, n)][1]


@pytest.mark.parametrize("n,n_pop", [(9, 8), (3, 2), (5, 4), (1, 2), (10, 4)])
def test_replication_warning_text_is_the_jax_text(n, n_pop):
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jmesh._warn_replicated(n, n_pop)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        assert tmesh.Mesh(n_pop, 1, rank=0, world=n_pop).rows(n) == (0, n)  # replicated
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert tw[0].category is RuntimeWarning


def test_world_of_one_identities():
    m = tmesh.Mesh(1)
    assert m.shape == {"pop": 1, "data": 1} and m.world == 1 and m.pop_group is None
    x = torch.arange(6.0).reshape(3, 2)
    assert m.gather(x) is x and m.gather(x, 3) is x
    tree = {"a": x, "b": {"c": x[:, 0]}}
    assert m.gather_tree(tree, 3) is tree and m.gather_tree(tree, 3, root=0) is tree
    m.data_mean_([x])  # no data peers: unchanged
    np.testing.assert_array_equal(x.numpy(), np.arange(6.0).reshape(3, 2))
    # no process group: the fault check-in is the local flag, no collective
    assert tmesh.check_in() is False and tmesh.check_in(True) is True
    got = m.exchange({"a": x, "b": {"c": x[:, 1].long()}}, torch.tensor([2, 2, 0]), 3)
    np.testing.assert_array_equal(got["a"].numpy(), x.numpy()[[2, 2, 0]])
    np.testing.assert_array_equal(got["b"]["c"].numpy(), x[:, 1].long().numpy()[[2, 2, 0]])
    # the scatter form: a negative source keeps the base row
    base = {"a": torch.zeros(3, 2), "b": {"c": torch.zeros(3, dtype=torch.long)}}
    got = m.exchange({"a": x, "b": {"c": x[:, 1].long()}}, np.array([-1, 0, -1]), 3, base=base)
    np.testing.assert_array_equal(got["a"].numpy(), [[0, 0], [0, 1], [0, 0]])


def test_pack_round_trips_mixed_dtypes():
    # an odd count of bf16 values ahead of 4-byte ones: unaligned offsets
    leaves = [torch.randn(1, 3).bfloat16(), torch.randn(1, 3), torch.randn(2, 5).bfloat16(),
              torch.arange(2, dtype=torch.int32)]
    buf = tmesh._pack(leaves)
    assert buf.dtype == torch.uint8 and buf.numel() == tmesh._packed_bytes(leaves)
    for a, b in zip(tmesh._unpack(buf, leaves), leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("device_type,local_ranks,cards,want", [
    ("cuda", 1, 1, "nccl"),
    ("cuda", 2, 1, "gloo"),  # two ranks on one card: NCCL refuses a duplicate GPU
    ("cuda", 4, 4, "nccl"),
    ("cuda", 4, 8, "nccl"),
    ("cuda", 8, 4, "gloo"),
    ("cpu", 2, 0, "gloo"),
    ("cpu", 2, 8, "gloo"),
])
def test_backend_is_chosen_from_counts(device_type, local_ranks, cards, want):
    assert tmesh.choose_backend(device_type, local_ranks, cards) == want


def test_bring_up_without_a_world_is_one_process(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.initialize_multihost(device="cpu") == 0
    assert not torch.distributed.is_initialized()
    assert tmesh.world_info()["world"] == 1
    # asked for a world it cannot find: an error, never a silent shrink
    with pytest.raises(RuntimeError, match="no world was given"):
        tmesh.initialize_multihost(require=True, device="cpu")
    with pytest.raises(ValueError, match="--num-processes"):
        tmesh.initialize_multihost("127.0.0.1:1", device="cpu")


def test_data_axis_splits_the_batch_or_refuses():
    m = tmesh.Mesh(1, 2, rank=1, world=2)
    assert m.batch_rows(32) == (16, 32)
    with pytest.raises(ValueError, match="not divisible by the mesh 'data' axis"):
        m.batch_rows(33)
    from torch_port_small import small_workload

    trainer = small_workload().make_trainer(device="cpu")  # batch 32
    assert trainer.on_mesh(m).mesh is m and trainer.mesh is None
    with pytest.raises(ValueError, match="batch_size 32 not divisible"):
        trainer.on_mesh(tmesh.Mesh(1, 3, rank=0, world=3))


@pytest.mark.parametrize("n", [9, 10, 16, 27, 81, 100])
@pytest.mark.parametrize("eta", [2, 3, 4])
@pytest.mark.parametrize("round_to", [1, 2, 4, 8])
def test_sha_cohort_sizes_against_jax(n, eta, round_to):
    for n_rungs in (1, 3, 5):
        assert sha_cohort_sizes(n, n_rungs, eta, round_to) == jax_sha_cohort_sizes(
            n, n_rungs, eta, round_to)


_FUSED = ["--workload", "fashion_mlp", "--algorithm", "pbt", "--fused", "--population", "4",
          "--generations", "1", "--steps-per-generation", "1"]


@pytest.mark.parametrize("extra,message", [
    (["--platform", "gpu", "--device", "cpu"], "--platform gpu contradicts --device cpu"),
    (["--local-devices", "2", "--device", "cpu"], "a port rank owns one device"),
    (["--coordinator", "127.0.0.1:1", "--device", "cpu"], "must be given together"),
    (["--coord-timeout", "0", "--device", "cpu"], "--coord-timeout must be > 0"),
    (["--n-data", "0", "--device", "cpu"], "--n-data must be >= 1"),
    (["--n-pop", "-1", "--device", "cpu"], "--n-pop must be >= 0"),
    (["--rank-kill", "rank=1,when=2", "--device", "cpu"], "unknown rank-kill key 'when'"),
    (["--multihost", "--device", "cpu"], "no world was given"),
    (["--n-data", "2", "--device", "cpu"], "mesh: 1 devices not divisible by n_data=2"),
])
def test_cli_multiprocess_usage_errors(extra, message, capsys, monkeypatch):
    from mpi_opt_tpu_torch import cli

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    try:
        cli.main([*_FUSED, *extra])
    except SystemExit as e:
        assert e.code == 2
    else:
        raise AssertionError("no usage error")
    assert message in capsys.readouterr().err


def test_cli_no_mesh_contradicts_a_mesh_shape():
    from mpi_opt_tpu_torch import cli

    with pytest.raises(SystemExit, match="--no-mesh contradicts --n-data/--n-pop"):
        cli.main([*_FUSED, "--no-mesh", "--n-pop", "1", "--device", "cpu"])


def test_cli_platform_cpu_is_device_cpu_and_a_world_of_one_has_no_mesh(capsys):
    import json

    from mpi_opt_tpu_torch import cli

    assert cli.main([*_FUSED, "--platform", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["mesh"] is None and summary["n_chips"] == 1
    # an explicit 1 x 1 mesh in a world of one: the one-process sweep
    assert cli.main([*_FUSED, "--platform", "cpu", "--n-pop", "1"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["mesh"] == {"pop": 1, "data": 1} and summary["n_chips"] == 1

"""Rank programs for the port's multi-process CPU tests (not a test
module: ``test_torch_multiprocess.py`` imports it). ``spawn_world``
starts ``world`` ranks with ``torch.multiprocessing``, each bringing up
a gloo process group on ``127.0.0.1`` with one torch thread, running one
job of ``JOBS`` over its mesh, and pickling what the job returns; the
caller reads every rank's result back."""

import os
import pickle
import socket
import warnings

import numpy as np
import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ledger(path, rank, space, seed):
    """Rank 0 writes the fused header; the other ranks read the shared
    journal once rank 0 committed it."""
    import torch.distributed as dist

    from mpi_opt_tpu_torch.ledger import SweepLedger

    header = {"mode": "fused", "seed": seed, "space_hash": space.space_hash()}
    if rank == 0:
        led = SweepLedger(path, read_only=False)
        led.ensure_header(header)
    dist.barrier()
    if rank != 0:
        led = SweepLedger(path, read_only=True)
        led.ensure_header(header)
    return led


def _params(state):
    return {k: v.detach().numpy().copy() for k, v in state.params.items()}


def job_pop(rank, mesh, out_dir):
    """A 2 x 1 mesh: the narrow SmallCNN PBT (bit identity), a ledgered
    fashion_mlp PBT (against the JAX package), an SHA with rounded rungs
    and the gpu slot pool over the mesh."""
    from torch_port_small import KW, small_workload

    from mpi_opt_tpu_torch.backends import get_backend
    from mpi_opt_tpu_torch.driver import run_search
    from mpi_opt_tpu_torch.algorithms import get_algorithm
    from mpi_opt_tpu_torch.train.fused_asha import fused_sha
    from mpi_opt_tpu_torch.train.fused_pbt import fused_pbt
    from mpi_opt_tpu_torch.workloads import get_workload

    out = {}
    cnn = fused_pbt(small_workload(), mesh=mesh, **KW)
    out["cnn"] = {k: cnn[k] for k in ("best_curve", "mean_curve", "unit", "best_score")}
    out["cnn"]["params"] = _params(cnn["state"])
    out["cnn"]["rows"] = cnn["state"].step.shape[0]

    wl = get_workload("fashion_mlp", n_train=256, n_val=128)
    led = _ledger(os.path.join(out_dir, "pbt.jsonl"), rank, wl.default_space(), 0)
    try:
        pbt = fused_pbt(wl, mesh=mesh, ledger=led, device="cpu", population=4, generations=2,
                        steps_per_gen=2, seed=0, gen_chunk=1)
    finally:
        led.close()
    out["pbt"] = {k: pbt[k] for k in pbt if k != "state"}

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sha = fused_sha(get_workload("fashion_mlp", n_train=256, n_val=128), n_trials=9,
                        min_budget=2, max_budget=18, eta=3, seed=3, device="cpu", mesh=mesh)
    out["sha"] = {k: sha[k] for k in ("rung_sizes", "rung_history", "best_score", "best_trial")}
    out["sha"]["warnings"] = sorted({str(w.message) for w in caught
                                     if "does not divide the mesh" in str(w.message)})

    mlp = lambda: get_workload("fashion_mlp", n_train=256, n_val=128)
    waves = fused_pbt(mlp(), mesh=mesh, device="cpu", population=8, generations=2, steps_per_gen=2,
                      seed=1, wave_size=4)
    out["pbt_waves"] = {k: waves[k] for k in ("best_curve", "mean_curve", "unit", "waves_run")}

    from mpi_opt_tpu_torch.train.fused_asha import fused_hyperband
    from mpi_opt_tpu_torch.train.fused_bohb import fused_bohb
    from mpi_opt_tpu_torch.train.fused_tpe import fused_tpe

    tpe = fused_tpe(get_workload("tabular_mlp"), n_trials=8, batch=4, budget=2, seed=0, device="cpu",
                    mesh=mesh)
    out["tpe"] = {k: tpe[k] for k in ("obs_scores", "obs_unit", "best_curve")}
    hb = fused_hyperband(mlp(), max_budget=9, eta=3, seed=0, device="cpu", mesh=mesh)
    out["hyperband"] = [{k: b[k] for k in ("rung_sizes", "best_score")} for b in hb["brackets"]]
    bohb = fused_bohb(mlp(), max_budget=9, eta=3, seed=0, device="cpu", mesh=mesh,
                      checkpoint_dir=os.path.join(out_dir, "bohb_ck"))
    out["bohb"] = [{k: b[k] for k in ("rung_sizes", "best_score", "n_model_sampled")}
                   for b in bohb["brackets"]]
    out["drain_at"] = _drain_drill(rank, mesh, out_dir)
    out["oom"] = _oom_drill(rank, mesh, out_dir, "pop", mlp, population=8, generations=2,
                            steps_per_gen=2, seed=1, wave_size=4)

    backend = get_backend("gpu", get_workload("fashion_mlp", n_train=256, n_val=128),
                          population=4, seed=1, device="cpu", mesh=mesh)
    try:
        algo = get_algorithm("random")(wl.default_space(), seed=1, max_trials=8, budget=4)
        res = run_search(algo, backend)
        out["driver"] = {"scores": sorted((t.trial_id, t.score) for t in algo.trials.values()),
                         "pool_size": backend.pool_size,
                         "best": None if res.best is None else res.best.score}
    finally:
        backend.close()
    return out


def _drain_drill(rank, mesh, out_dir):
    """A shutdown request that only rank 0 sees (at its 2nd boundary,
    ahead of that boundary's vote): through the coord plane rank 1,
    which saw nothing, drains with it. Returns where this rank
    drained."""
    from mpi_opt_tpu_torch.health import shutdown
    from mpi_opt_tpu_torch.parallel import coord
    from mpi_opt_tpu_torch.train.fused_pbt import fused_pbt
    from mpi_opt_tpu_torch.utils import resources
    from mpi_opt_tpu_torch.workloads import get_workload

    plane = coord.CoordPlane(os.path.join(out_dir, "coord"), rank, mesh.world, timeout_s=60)
    uninstall = coord.install_hook(plane)
    seen = {"n": 0}

    def fault(stage):
        seen["n"] += 1
        if rank == 0 and seen["n"] == 2:
            shutdown.request("SIGTERM")

    resources.set_boundary_fault_injector(fault)
    try:
        with shutdown.ShutdownGuard():
            fused_pbt(get_workload("fashion_mlp", n_train=256, n_val=128), mesh=mesh, device="cpu",
                      population=4, generations=4, steps_per_gen=1, seed=0, gen_chunk=1)
    except shutdown.SweepInterrupted as e:
        return e.at
    finally:
        resources.set_boundary_fault_injector(None)
        uninstall()
    return None


def _oom_drill(rank, mesh, out_dir, name, workload, **kw):
    """Fused PBT in waves over the mesh with an OOM budget of one halving,
    clean, then with a device OOM planted on rank 1 alone at its 2nd wave
    launch (the engine's seam, ahead of the wave's collectives). Returns
    both runs' curves, units and wave fields."""
    from mpi_opt_tpu_torch.parallel import coord
    from mpi_opt_tpu_torch.train.fused_pbt import fused_pbt
    from mpi_opt_tpu_torch.utils import resources

    seen = {"n": 0}

    def fault(kind):
        if kind == "wave" and rank == 1:
            seen["n"] += 1
            if seen["n"] == 2:
                raise resources.synthetic_resource_exhausted()

    plane = coord.CoordPlane(os.path.join(out_dir, f"coord_oom_{name}"), rank, mesh.world, timeout_s=60)
    uninstall = coord.install_hook(plane)
    out = {}
    try:
        for label, injector in (("clean", None), ("faulted", fault)):
            resources.set_launch_fault_injector(injector)
            res = fused_pbt(workload(), mesh=mesh, device="cpu", oom_backoff=1, **kw)
            out[label] = {k: res[k] for k in ("best_curve", "mean_curve", "unit", "oom_backoffs",
                                              "wave_size", "waves_run")}
    finally:
        resources.set_launch_fault_injector(None)
        uninstall()
    return out


def _pop_update_halves(rank, mesh, out_dir):
    """One population step of the tiny ResNet on this rank's half of the
    batch that ``pop_update.pt`` holds: with the gradients averaged over
    ``data`` (the trainer on the mesh), and alone (the average dropped)."""
    from mpi_opt_tpu_torch.models.resnet import ResNet
    from mpi_opt_tpu_torch.train.population import OptHParams, PopState, PopulationTrainer

    case = torch.load(os.path.join(out_dir, "pop_update.pt"))
    n, batch = case["aug"][1].shape[0], case["bx"].shape[0]
    trainer = PopulationTrainer(
        lambda p, dev: ResNet(**case["kw"], dtype=torch.float32, population=p, device=dev),
        batch_size=batch, device="cpu")
    c, d = mesh.batch_rows(batch)
    flip, dy, dx = case["aug"]
    args = (OptHParams(**case["hp"]), (flip[:, c:d], dy, dx), case["bx"][c:d], case["by"][c:d])
    out = {}
    for name, tr in (("averaged", trainer.on_mesh(mesh)), ("alone", trainer)):
        st = PopState({k: v.clone() for k, v in case["params"].items()},
                      {k: v.clone() for k, v in case["momentum"].items()}, torch.zeros(n, dtype=torch.int32))
        loss = tr._pop_update(st, *args)
        out[name] = {"params": _params(st), "loss": loss.numpy(),
                     "momentum": {k: v.numpy().copy() for k, v in st.momentum.items()}}
    return out


def job_data(rank, mesh, out_dir):
    """A 1 x 2 mesh: the JAX package's sharded-vs-unsharded PBT
    (``tests/test_parallel.py``) with each batch split over ``data``,
    one step of the tiny ResNet on half batches, and the OOM drill."""
    from mpi_opt_tpu_torch.train.fused_pbt import fused_pbt
    from mpi_opt_tpu_torch.workloads import get_workload

    def wl():
        w = get_workload("fashion_mlp", n_train=512, n_val=256)
        w.batch_size = 32
        return w

    res = fused_pbt(wl(), mesh=mesh, device="cpu", population=8, generations=2, steps_per_gen=10,
                    seed=3)
    out = {k: res[k] for k in ("best_curve", "mean_curve", "best_score", "unit")}
    out["pop_update"] = _pop_update_halves(rank, mesh, out_dir)
    out["oom"] = _oom_drill(rank, mesh, out_dir, "data", wl, population=8, generations=2,
                            steps_per_gen=2, seed=3, wave_size=4)
    return out


JOBS = {"pop": (job_pop, 2, 1), "data": (job_data, 1, 2)}


def _rank_main(rank, world, port, job, out_dir):
    torch.set_num_threads(1)
    from mpi_opt_tpu_torch.parallel import mesh as pmesh

    fn, n_pop, n_data = JOBS[job]
    pmesh.initialize_multihost(f"127.0.0.1:{port}", world, rank, device="cpu", timeout_s=120)
    try:
        mesh = pmesh.make_mesh(n_pop=n_pop, n_data=n_data)
        res = fn(rank, mesh, out_dir)
        with open(os.path.join(out_dir, f"{job}.{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        pmesh.shutdown_multihost()


def spawn_world(job: str, out_dir: str, world: int = 2) -> list:
    """Run ``job`` on ``world`` gloo ranks; every rank's result."""
    import torch.multiprocessing as mp

    # the group's address is pinned to 127.0.0.1 (tcp://127.0.0.1:PORT):
    # loopback works here where the host's name does not resolve
    mp.spawn(_rank_main, args=(world, free_port(), job, out_dir), nprocs=world)
    got = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{job}.{r}.pkl"), "rb") as f:
            got.append(pickle.load(f))
    return got


def concat_params(parts) -> dict:
    """The whole population's parameters from the ranks' rows, in pop order."""
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

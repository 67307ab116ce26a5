"""The port's boundary-agreement plane (``parallel/coord.py``) against the
JAX package's: the same file format, so a port rank and a JAX rank vote
in one directory and reach the same decisions; the pure reducers on
drawn votes; the protocol's refusals (a reused epoch, a missing peer);
and the drain agreement through ``launch_boundary``."""

import errno
import os
import threading

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from mpi_opt_tpu.parallel import coord as jcoord
from mpi_opt_tpu.service import spool as jspool
from mpi_opt_tpu_torch.health import shutdown
from mpi_opt_tpu_torch.parallel import coord as tcoord
from mpi_opt_tpu_torch.service import spool as tspool
from mpi_opt_tpu_torch.train.common import launch_boundary

PACKAGES = {"port": tcoord, "jax": jcoord}
SPOOLS = {"port": tspool, "jax": jspool}


def _vote_together(root, first, second, script):
    """Rank 0 from package ``first``, rank 1 from ``second``, both on
    ``root``; ``script(plane, rank)`` runs on each in its own thread.
    Returns each rank's list of results."""
    out = [None, None]
    errors = []

    def run(rank, mod):
        try:
            plane = mod.CoordPlane(root, rank, 2, epoch=0, timeout_s=20.0, poll_s=0.002)
            out[rank] = script(plane, rank)
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(0, PACKAGES[first])),
               threading.Thread(target=run, args=(1, PACKAGES[second]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    return out


def _agreements(plane, rank):
    got = []
    for caps in ((0, 0), (16, 0), (0, 8), (16, 4)):
        got.append(plane.agree_cap("wave_cap", caps[rank]))
    votes = [({"drain": False}, {"drain": False}),
             ({"drain": False}, {"drain": True, "signal": "SIGTERM"}),
             ({"drain": True, "signal": "SIGINT"}, {"drain": True, "signal": "SIGTERM"})]
    for v in votes:
        got.append(plane.agree("drain", v[rank], jcoord._decide_drain if rank == 0 and isinstance(
            plane, jcoord.CoordPlane) else tcoord._decide_drain))
    return got


@pytest.mark.parametrize("first,second", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_port_and_jax_ranks_agree_in_one_directory(tmp_path, first, second):
    got = _vote_together(str(tmp_path / "coord"), first, second, _agreements)
    want = [0, 16, 8, 4, {"drain": False, "signal": None}, {"drain": True, "signal": "SIGTERM"},
            {"drain": True, "signal": "SIGINT"}]
    assert got[0] == got[1] == want
    names = sorted(os.listdir(tmp_path / "coord" / "e0000"))
    assert "READY.json" in names
    assert "wave_cap.000000.r1.vote.json" in names and "drain.000002.decision.json" in names


_votes = st.lists(st.fixed_dictionaries({}, optional={
    "drain": st.booleans(),
    "signal": st.one_of(st.none(), st.sampled_from(["SIGTERM", "SIGINT", "SLICE"])),
    "cap": st.integers(min_value=0, max_value=4096),
    "stage": st.text(max_size=8),
}), min_size=1, max_size=8)


@settings(max_examples=200, deadline=None)
@given(votes=_votes)
def test_reducers_equal_the_jax_reducers(votes):
    assert tcoord._decide_drain(votes) == jcoord._decide_drain(votes)
    assert tcoord._decide_min_cap(votes) == jcoord._decide_min_cap(votes)


def test_a_reused_epoch_is_refused(tmp_path):
    root = str(tmp_path / "coord")
    tcoord.CoordPlane(root, 0, 1, epoch=3)
    with pytest.raises(tcoord.CoordError, match="fresh --coord-epoch"):
        tcoord.CoordPlane(root, 0, 1, epoch=3)
    tcoord.CoordPlane(root, 0, 1, epoch=4)  # a fresh epoch is fine
    tcoord.reset_dir(root)
    assert not os.path.exists(root)
    tcoord.CoordPlane(root, 0, 1, epoch=3)  # after the between-jobs wipe


def test_a_missing_peer_raises_coord_wedged(tmp_path):
    notes = []
    from mpi_opt_tpu_torch.utils import resources

    resources.set_observer(lambda event, **f: notes.append((event, f)))
    try:
        plane = tcoord.CoordPlane(str(tmp_path / "coord"), 0, 2, timeout_s=0.2, poll_s=0.01)
        with pytest.raises(tcoord.CoordWedged, match="no all 2 votes for drain#0"):
            plane.agree("drain", {"drain": False}, tcoord._decide_drain)
        # a rank that waits for rank 0's READY wedges the same way
        with pytest.raises(tcoord.CoordWedged, match="READY.json"):
            tcoord.CoordPlane(str(tmp_path / "other"), 1, 2, timeout_s=0.2, poll_s=0.01)
    finally:
        resources.clear_observer()
    assert [e for e, _ in notes] == ["rank_wedge", "rank_wedge"]
    assert notes[0][1]["rank"] == 0 and notes[0][1]["world"] == 2


def test_drain_agreement_through_launch_boundary(tmp_path):
    """A world-of-one plane agrees with itself: the boundary votes, the
    locally seen request drains (labelled as a boundary phase), and the
    hook and plane are gone after uninstall."""
    plane = tcoord.CoordPlane(str(tmp_path / "coord"), 0, 1, poll_s=0.001)
    uninstall = tcoord.install_hook(plane)
    try:
        with shutdown.ShutdownGuard():
            launch_boundary("pbt launch 1/3", final=False)  # no request: carries on
            assert not plane.drain_agreed
            shutdown.request("SIGTERM")
            with pytest.raises(shutdown.SweepInterrupted) as e:
                launch_boundary("pbt launch 2/3", final=False)
            assert e.value.at == "boundary:pbt launch 2/3" and plane.drain_agreed
    finally:
        uninstall()
    assert tcoord.active_plane() is None and shutdown.get_slice_hook() is None
    assert tcoord.drain_allowed()
    assert sorted(f for f in os.listdir(tmp_path / "coord" / "e0000") if "decision" in f) == [
        "drain.000000.decision.json", "drain.000001.decision.json"]


def test_a_signal_after_the_vote_waits_for_the_next_boundary(tmp_path):
    """A request that lands after this boundary's vote (here: raised by
    another hook after the plane voted no) must not drain alone."""
    plane = tcoord.CoordPlane(str(tmp_path / "coord"), 0, 1, poll_s=0.001)
    uninstall = tcoord.install_hook(plane)
    tick = shutdown.get_slice_hook()
    shutdown.set_slice_hook(lambda stage: (tick(stage), shutdown.request("SIGTERM")))
    try:
        with shutdown.ShutdownGuard():
            launch_boundary("sha rung 1/3", final=False)  # voted no, then the signal: no drain
            assert not plane.drain_agreed and shutdown.requested()
            with pytest.raises(shutdown.SweepInterrupted):
                launch_boundary("sha rung 2/3", final=False)
    finally:
        shutdown.set_slice_hook(tick)
        uninstall()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_the_spool_fault_seam_reaches_the_plane(tmp_path, pkg):
    """The plane's reads are the spool's own primitives: a transient
    fault the spool's injector plants on a control-plane read is seen
    and retried, in both packages alike."""
    seen = []

    def fault(op, path):
        seen.append((op, os.path.basename(path)))
        if len(seen) == 1:
            raise OSError(errno.EIO, "injected")

    SPOOLS[pkg].set_fault_injector(fault)
    try:
        plane = PACKAGES[pkg].CoordPlane(str(tmp_path), 0, 1, epoch=0, timeout_s=5.0, poll_s=0.002)
        cap = plane.agree_cap("wave_cap", 8)
    finally:
        SPOOLS[pkg].set_fault_injector(None)
    # the faulted read (rank 0's own vote, read back) was tried again
    assert seen[:2] == [("read", "wave_cap.000000.r0.vote.json")] * 2
    assert cap == 8

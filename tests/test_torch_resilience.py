"""The port's resilience layer (``tpusppy_torch/resilience/``) against the
reference's, float64 on the CPU.

Each case of ``tests/test_resilience.py`` that needs neither the TCP
window service nor the autotuner, run on the port: the checkpoint file
format and its version guard, the manager's cadence, prune, flush and
``fresh_start``, the decline on an opt without PH state, hub-only
kill-resume parity (rtol 1e-5, atol 1e-4 against the uninterrupted run)
with captures that fetch nothing, a dead spoke and strict mode, stale
write-ids, dead and wedged spokes, the load-adaptive grace, the crash
report, the corrupt-shard and corrupt-file fallbacks, ``verify``, the
W/xbar csv golden, ``seed_resume``, and the npz and csv mixes of the
W/xbar interchange.  The reference's ``jax`` transfer guard has no twin:
the zero-fetch contract here is ``checkpoint.capture_fetches`` (the
capture's own thread's fetches) and a capture refusing a tensor.  Then
the cross-package cases: a checkpoint written by either package loads in
the other field for field, and both packages resume the same checkpoint
to the same W, xbars and eobj (1e-7).  Counters are read as deltas
(:func:`tpusppy_torch.obs.metrics.window`): the port's registry is never
reset.
"""

import dataclasses
import glob
import os
import time

import numpy as np
import pytest
import torch

from tpusppy.cylinders import PHHub as JPHHub
from tpusppy.models import farmer as jfarmer
from tpusppy.opt.ph import PH as JPH
from tpusppy.resilience import checkpoint as jcheckpoint
from tpusppy.spin_the_wheel import WheelSpinner as JWheelSpinner
from tpusppy_torch.cylinders import (InnerBoundSpoke, LagrangianOuterBound,
                                     Mailbox, PHHub, XhatShuffleInnerBound)
from tpusppy_torch.cylinders.spcommunicator import WindowFabric
from tpusppy_torch.models import farmer
from tpusppy_torch.obs import metrics
from tpusppy_torch.opt.ph import PH
from tpusppy_torch.phbase import PHBase
from tpusppy_torch.resilience import checkpoint, faults, supervisor
from tpusppy_torch.solvers import hostsync
from tpusppy_torch.spin_the_wheel import WheelSpinner
from tpusppy_torch.xhat_eval import Xhat_Eval

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    yield
    faults.disarm()


def _farmer_opt_kwargs(n=3, iters=8, **opts):
    return {
        "options": {"defaultPHrho": 1.0, "PHIterLimit": iters,
                    "convthresh": -1.0, "device": "cpu",
                    "xhat_looper_options": {"scen_limit": 3}, **opts},
        "all_scenario_names": farmer.scenario_names_creator(n),
        "scenario_creator": farmer.scenario_creator,
        "scenario_creator_kwargs": {"num_scens": n},
    }


def _hub_only(iters, hub_options=None, **opts):
    return {
        "hub_class": PHHub,
        "hub_kwargs": {"options": dict(hub_options or {})},
        "opt_class": PH,
        "opt_kwargs": _farmer_opt_kwargs(iters=iters, **opts),
    }


# ---- the checkpoint engine ---------------------------------------------------

def test_checkpoint_save_load_roundtrip(tmp_path):
    ck = checkpoint.WheelCheckpoint(
        iteration=7,
        W=np.arange(12.0).reshape(3, 4),
        xbars=np.ones((3, 4)) * 2.5,
        xsqbars=np.ones((3, 4)) * 6.25,
        rho=np.full((3, 4), 5.0),
        best_inner=-108390.0, best_outer=-108500.0,
        spoke_bounds={"1": -108500.0, "2": -108390.0},
        tune_state={"version": 1, "jax": "none", "fused": {},
                    "pipeline": {}},
        meta={"S": 3, "K": 4})
    path = checkpoint.checkpoint_path(str(tmp_path), 7)
    checkpoint.save(ck, path)
    # atomic: no tempfile left beside the file
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(path)]
    back = checkpoint.load(path)
    assert back.iteration == 7
    np.testing.assert_array_equal(back.W, ck.W)
    np.testing.assert_array_equal(back.rho, ck.rho)
    np.testing.assert_array_equal(back.xsqbars, ck.xsqbars)
    assert back.best_inner == ck.best_inner
    assert back.spoke_bounds == {"1": -108500.0, "2": -108390.0}
    # a tune state a file holds is carried, not acted on
    assert back.tune_state["version"] == 1
    assert back.version == checkpoint.CHECKPOINT_VERSION


def test_checkpoint_latest_and_version_guard(tmp_path):
    for it in (3, 12, 7):
        checkpoint.save(checkpoint.WheelCheckpoint(iteration=it,
                                                   W=np.zeros((2, 2))),
                        checkpoint.checkpoint_path(str(tmp_path), it))
    assert checkpoint.latest(str(tmp_path)).endswith("00000012.npz")
    assert checkpoint.latest_iteration(str(tmp_path)) == 12
    assert checkpoint.load_latest(str(tmp_path)).iteration == 12
    # no checkpoint (and a missing path) is a clean cold start
    assert checkpoint.load_latest(str(tmp_path / "empty")) is None
    # a later version is refused, not half read
    bad = checkpoint.WheelCheckpoint(
        iteration=1, W=np.zeros((2, 2)),
        version=checkpoint.CHECKPOINT_VERSION + 1)
    p = checkpoint.checkpoint_path(str(tmp_path), 99)
    checkpoint.save(bad, p)
    with pytest.raises(RuntimeError, match="version"):
        checkpoint.load(p)


def test_checkpoint_manager_cadence_prune_and_flush(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), every_secs=None,
                                       every_iters=2, keep=2)
    snaps = 0

    def snap(i):
        return checkpoint.WheelCheckpoint(iteration=i,
                                          W=np.full((2, 3), float(i)))

    for i in range(1, 9):
        if mgr.maybe_capture(i, lambda i=i: snap(i)):
            snaps += 1
    assert snaps == 4                       # iterations 1, 3, 5, 7
    assert not mgr.maybe_capture(7, lambda: snap(7))   # the same again
    assert mgr.flush(timeout=30.0)
    assert len(glob.glob(str(tmp_path / "ckpt_*.npz"))) <= 2   # keep=2
    assert checkpoint.load_latest(str(tmp_path)).iteration == 7
    # an explicit capture (the final bank) ignores the cadence
    assert mgr.capture(8, lambda: snap(8))
    assert mgr.flush(timeout=30.0)
    assert checkpoint.load_latest(str(tmp_path)).iteration == 8
    mgr.close()


def test_checkpoint_manager_fresh_start_clears_stale_runs(tmp_path):
    """A cold run in a reused directory clears the old run's snapshots;
    a resuming manager keeps them."""
    checkpoint.save(checkpoint.WheelCheckpoint(iteration=40,
                                               W=np.zeros((2, 2))),
                    checkpoint.checkpoint_path(str(tmp_path), 40))
    mgr = checkpoint.CheckpointManager(str(tmp_path), every_iters=1,
                                       every_secs=None, fresh_start=True)
    assert checkpoint.latest(str(tmp_path)) is None
    mgr.capture(1, lambda: checkpoint.WheelCheckpoint(
        iteration=1, W=np.ones((2, 2))))
    assert mgr.flush()
    assert checkpoint.load_latest(str(tmp_path)).iteration == 1
    mgr.close()
    checkpoint.CheckpointManager(str(tmp_path), fresh_start=False)
    assert checkpoint.load_latest(str(tmp_path)).iteration == 1


def test_capture_ph_declines_non_ph_objects():
    class NotPH:
        pass

    assert checkpoint.capture_ph(NotPH()) is None


def test_capture_refuses_a_tensor_field():
    """The zero-fetch contract's second half: a tensor where a host
    mirror belongs raises instead of being copied off the device."""
    class Opt:
        W = np.zeros((2, 2))
        xbars = torch.zeros((2, 2), dtype=torch.float64)

    with pytest.raises(TypeError, match="host numpy"):
        checkpoint.capture_ph(Opt())
    Opt.xbars = np.zeros((2, 2))
    assert checkpoint.capture_ph(Opt()).xbars.shape == (2, 2)


def test_restore_sharded_array_waits_for_the_distributed_port():
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        checkpoint.restore_sharded_array("x", "W", None, (2, 2))


# ---- kill and resume ---------------------------------------------------------

def test_hub_only_kill_resume_parity_and_zero_fetch_capture(tmp_path):
    """A hub checkpointed at iteration k and resumed lands where the
    uninterrupted run lands at the same total iteration count, and every
    capture fetched nothing (its thread's fetches billed to
    ``checkpoint.capture_fetches``)."""
    N, k = 6, 3
    ws_ref = WheelSpinner(_hub_only(N), []).spin()
    W_ref = np.array(ws_ref.opt.W)

    ckdir = str(tmp_path / "ck")
    with metrics.window() as w:
        ws_killed = WheelSpinner(_hub_only(k, {
            "checkpoint_dir": ckdir, "checkpoint_every_iters": 1,
            "checkpoint_every_secs": None}), []).spin()
        assert w.delta("checkpoint.captures") >= k
        assert w.delta("checkpoint.capture_fetches") == 0
        assert w.delta("checkpoint.write_errors") == 0
    ck = checkpoint.load_latest(ckdir)
    assert ck is not None and ck.iteration == k
    np.testing.assert_allclose(ck.W, np.array(ws_killed.opt.W), atol=1e-9)

    with metrics.window() as w:
        ws_res = WheelSpinner(_hub_only(N), [], resume=ckdir).spin()
        assert w.delta("checkpoint.restores") >= 1
    assert ws_res.resumed_from == k
    assert ws_res.opt._iter == N            # the total, not k + N
    np.testing.assert_allclose(np.array(ws_res.opt.W), W_ref,
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.array(ws_res.opt.xbars),
                               np.array(ws_ref.opt.xbars),
                               rtol=1e-5, atol=1e-4)
    # the direct call fetches nothing either
    with hostsync.track() as tr:
        ck2 = checkpoint.capture_ph(ws_res.opt, hub=ws_res.spcomm)
    assert tr.count == 0
    assert ck2 is not None and ck2.W.shape == ws_res.opt.W.shape


def test_lean_windows_refresh_the_mirrors_before_a_due_capture(tmp_path):
    """With ``ph_device_state`` the windows leave the host mirrors stale;
    a due capture follows the window's one boundary fetch (the opt asks
    ``checkpoint_due`` before syncing), reads current mirrors and fetches
    nothing itself."""
    ckdir = str(tmp_path / "ck")
    with metrics.window() as w:
        ws = WheelSpinner(_hub_only(20, {
            "checkpoint_dir": ckdir, "checkpoint_every_iters": 1,
            "checkpoint_every_secs": None}, ph_device_state=True),
            []).spin()
        assert w.delta("dispatch.megasteps") > 0
        assert w.delta("phstate.boundary_fetches") > 0
        assert w.delta("checkpoint.capture_fetches") == 0
    ck = checkpoint.load_latest(ckdir)
    assert ck.iteration == ws.opt._iter == 20
    np.testing.assert_allclose(ck.W, ws.opt.W, atol=1e-12)
    np.testing.assert_allclose(ck.xbars, ws.opt.xbars, atol=1e-12)


@pytest.mark.slow
def test_wheel_kill_resume_certified_gap(tmp_path):
    """The hub with a Lagrangian and an XhatShuffle spoke, cut at
    iteration k with checkpoints and resumed to the same total budget:
    the bounds are monotone across the restart, and the resumed run
    certifies no worse than the uninterrupted one."""
    def wheel(iters, hub_extra=None, resume=None):
        hub = {
            "hub_class": PHHub,
            "hub_kwargs": {"options": {
                "rel_gap": 1e-3, "abs_gap": 1.0, "linger_secs": 60.0,
                **(hub_extra or {})}},
            "opt_class": PH,
            "opt_kwargs": _farmer_opt_kwargs(iters=iters),
        }
        spokes = [
            {"spoke_class": LagrangianOuterBound, "opt_class": PHBase,
             "opt_kwargs": _farmer_opt_kwargs(iters=40)},
            {"spoke_class": XhatShuffleInnerBound, "opt_class": Xhat_Eval,
             "opt_kwargs": _farmer_opt_kwargs(iters=40)},
        ]
        return WheelSpinner(hub, spokes, resume=resume).spin()

    def rel_gap(ws):
        return ((ws.BestInnerBound - ws.BestOuterBound)
                / abs(ws.BestOuterBound))

    N, k = 40, 4
    gap_ref = rel_gap(wheel(N))
    ckdir = str(tmp_path / "ck")
    wheel(k, hub_extra={"checkpoint_dir": ckdir,
                        "checkpoint_every_iters": 1,
                        "checkpoint_every_secs": None,
                        "linger_secs": 0.0})
    ck = checkpoint.load_latest(ckdir)
    assert ck is not None and ck.iteration >= k
    ws_res = wheel(N, resume=ckdir)
    assert ws_res.resumed_from == ck.iteration
    assert ws_res.BestOuterBound >= ck.best_outer - 1e-9
    assert ws_res.BestInnerBound <= ck.best_inner + 1e-9
    assert rel_gap(ws_res) <= max(gap_ref, 1e-3) + 1e-9
    assert ws_res.BestOuterBound <= ws_res.BestInnerBound + 1e-6


# ---- injected faults: a dead spoke, stale write-ids --------------------------

def test_dead_spoke_graceful_degradation():
    """A spoke killed at its second payload neither hangs nor fails the
    wheel: it is marked lost, its finalize skipped, and the hub goes on
    certifying with the remaining bounders."""
    hub = {
        "hub_class": PHHub,
        "hub_kwargs": {"options": {"rel_gap": 1e-3, "linger_secs": 1.0}},
        "opt_class": PH,
        "opt_kwargs": _farmer_opt_kwargs(iters=6),
    }
    spokes = [
        {"spoke_class": LagrangianOuterBound, "opt_class": PHBase,
         "opt_kwargs": _farmer_opt_kwargs(iters=20)},
        {"spoke_class": XhatShuffleInnerBound, "opt_class": Xhat_Eval,
         "opt_kwargs": _farmer_opt_kwargs(iters=20)},
    ]
    plan = faults.FaultPlan(kill_spoke={"LagrangianOuterBound": 2})
    with metrics.window() as w:
        with faults.inject(plan):
            ws = WheelSpinner(hub, spokes).spin()
        assert w.delta("supervisor.spokes_lost") == 1
    assert faults.injected_counts().get("spoke_kills") == 1
    assert ws.spun
    assert any("LagrangianOuterBound" in s for s in ws.lost_spokes)
    assert len(ws.spoke_errors) == 1
    assert isinstance(ws.spoke_errors[0][1], faults.SpokeKilled)
    assert np.isfinite(ws.BestInnerBound)
    assert ws.BestOuterBound <= ws.BestInnerBound + 1e-6


def test_dead_spoke_strict_mode_raises():
    hub = {
        "hub_class": PHHub,
        "hub_kwargs": {"options": {"strict_spokes": True,
                                   "linger_secs": 0.0}},
        "opt_class": PH,
        "opt_kwargs": _farmer_opt_kwargs(iters=4),
    }
    spokes = [{"spoke_class": LagrangianOuterBound, "opt_class": PHBase,
               "opt_kwargs": _farmer_opt_kwargs(iters=20)}]
    with faults.inject(faults.FaultPlan(
            kill_spoke={"LagrangianOuterBound": 1})):
        with pytest.raises(RuntimeError, match="Spoke failures"):
            WheelSpinner(hub, spokes).spin()


def test_stale_mailbox_write_ids():
    """A stale window generation reads as nothing new, and the kill
    sentinel stays visible through it."""
    mb = Mailbox(2, name="spoke1->hub")
    mb.put(np.array([1.0, 2.0]))
    with faults.inject(faults.FaultPlan(stale_mailbox={"spoke1->hub": 2})):
        assert mb.get()[1] == 0
        assert mb.get()[1] == 0
        assert mb.get()[1] == 1             # the budget of 2 is spent
    assert faults.injected_counts()["stale_reads"] == 2
    mb.kill()
    with faults.inject(faults.FaultPlan(stale_mailbox={"spoke1->hub": 5})):
        assert mb.get()[1] == -1            # the sentinel is never masked


class _DeadThread:
    @staticmethod
    def is_alive():
        return False


class _LiveThread:
    @staticmethod
    def is_alive():
        return True


def test_supervisor_marks_dead_and_wedged_spokes():
    fabric = WindowFabric()
    fabric.add_spoke(1, 2, 1)
    fabric.add_spoke(2, 2, 1)
    # grace_factor 0: the fixed window (the adaptive grace is tested below)
    sup = supervisor.SpokeSupervisor(
        fabric, {1: "DeadSpoke", 2: "WedgedSpoke"}, timeout_secs=1e-6,
        grace_factor=0.0)
    sup.note_thread(1, _DeadThread())
    sup.note_thread(2, _LiveThread())
    fabric.to_hub[2].put(np.array([1.0]))   # spoke 2 made progress once
    sup.observe()
    assert not sup.is_lost(2)
    sup.observe()                           # 1 died, 2 wedged
    assert sup.is_lost(1) and sup.lost()[1][1] == "died"
    assert sup.is_lost(2) and sup.lost()[2][1] == "wedged"
    assert sup.all_lost()
    # a heartbeat is progress: the same stale mailbox stays alive while
    # the spoke provably polls
    sup2 = supervisor.SpokeSupervisor(fabric, {2: "Spoke"},
                                      timeout_secs=1e-6, grace_factor=0.0)
    sup2.note_thread(2, _LiveThread())
    supervisor.heartbeat("spoke2")
    sup2.observe()
    assert not sup2.is_lost(2)
    sup2.observe()                          # the heartbeat is stale now
    assert sup2.is_lost(2)


def test_supervisor_never_times_out_a_spoke_in_its_warm_up():
    """A spoke that has posted no bound yet (building its kernels,
    capturing its graphs, in its first solve) is never judged wedged,
    however short the timeout; a dead one still is lost."""
    fabric = WindowFabric()
    fabric.add_spoke(1, 2, 1)
    fabric.add_spoke(2, 2, 1)
    sup = supervisor.SpokeSupervisor(fabric, {1: "Warming", 2: "Dead"},
                                     timeout_secs=1e-6, grace_factor=0.0)
    sup.note_thread(1, _LiveThread())
    sup.note_thread(2, _DeadThread())
    for _ in range(3):
        sup.observe()
    assert not sup.is_lost(1)
    assert sup.lost()[2][1] == "died"
    fabric.to_hub[1].put(np.array([1.0]))   # its first bound: warm now
    sup.observe()
    assert not sup.is_lost(1)
    sup.observe()
    assert sup.lost()[1][1] == "wedged"


def test_supervisor_times_out_a_warm_spoke_that_never_posts():
    """Warm-up ends at the spoke's first poll after it worked on a hub
    payload, bound or no bound: a spoke that never posts is judged wedged
    once its heartbeats stop after that."""
    fabric = WindowFabric()
    fabric.add_spoke(1, 2, 1)
    sup = supervisor.SpokeSupervisor(fabric, {1: "NeverPosts"},
                                     timeout_secs=1e-6, grace_factor=0.0)
    sup.note_thread(1, _LiveThread())
    supervisor.heartbeat("spoke1")
    sup.observe()                           # a fresh beat is progress
    sup.observe()                           # a stale beat, still warming up
    assert not sup.is_lost(1)
    supervisor.mark_warm("spoke1")
    sup.observe()
    assert sup.lost()[1] == ("NeverPosts", "wedged")
    # a mark left by an earlier wheel does not end a new one's warm-up
    sup2 = supervisor.SpokeSupervisor(fabric, {1: "NeverPosts"},
                                      timeout_secs=1e-6, grace_factor=0.0)
    sup2.note_thread(1, _LiveThread())
    sup2.observe()
    sup2.observe()
    assert not sup2.is_lost(1)


class _WedgesWithoutPosting(InnerBoundSpoke):
    """Takes its first hub payload, comes back to the mailbox once (its
    warm-up is over), then hangs without polling or posting until the
    kill sentinel."""

    def main(self):
        while not self.got_kill_signal():
            if self._new_locals:
                break
        self.got_kill_signal()
        while not self.peek_kill_signal():
            time.sleep(0.01)


def test_wheel_marks_a_spoke_that_never_posts_wedged():
    """In a live wheel the spoke above is lost to the timeout, and the
    hub's linger harvest ends on that loss, not on its own budget."""
    hub = {
        "hub_class": PHHub,
        "hub_kwargs": {"options": {"linger_secs": 120.0,
                                   "spoke_timeout_secs": 1.0}},
        "opt_class": PH,
        "opt_kwargs": _farmer_opt_kwargs(iters=4),
    }
    spokes = [{"spoke_class": _WedgesWithoutPosting, "opt_class": PHBase,
               "opt_kwargs": _farmer_opt_kwargs(iters=4)}]
    t0 = time.monotonic()
    with metrics.window() as w:
        ws = WheelSpinner(hub, spokes).spin()
        assert w.delta("supervisor.spokes_lost") == 1
    assert time.monotonic() - t0 < 60.0
    assert ws.lost_spokes == ["_WedgesWithoutPosting (wedged)"]
    assert ws.spoke_errors == [] and ws.hung_spokes == []


def test_supervisor_load_adaptive_grace():
    """A starved sync loop (gaps between observations far above the
    timeout) widens the window by grace_factor times the loop's latency;
    a wedged spoke under a healthy loop is still lost."""
    import time

    fabric = WindowFabric()
    fabric.add_spoke(1, 2, 1)
    sup = supervisor.SpokeSupervisor(fabric, {1: "Spoke"},
                                     timeout_secs=0.05, grace_factor=8.0)
    sup.note_thread(1, _LiveThread())
    fabric.to_hub[1].put(np.array([1.0]))
    sup.observe()
    time.sleep(0.2)                          # the loop starved
    sup.observe()
    assert not sup.is_lost(1)
    assert sup.effective_timeout() >= 8.0 * 0.2 - 1e-3
    for _ in range(60):
        time.sleep(0.005)
        sup.observe()
        if sup.is_lost(1):
            break
    assert sup.is_lost(1) and sup.lost()[1][1] == "wedged"


def test_supervisor_crash_report():
    fabric = WindowFabric()
    fabric.add_spoke(1, 2, 1)
    sup = supervisor.SpokeSupervisor(fabric, {1: "Spoke"})
    err = RuntimeError("boom")
    sup.note_error(1, err)
    assert sup.is_lost(1)
    assert sup.lost()[1] == ("Spoke", "crashed")
    assert sup.errors() == [("Spoke", err)]
    assert sup.lost_names() == ["Spoke (crashed)"]


# ---- corrupt checkpoints -----------------------------------------------------

def test_corrupt_shard_falls_back_to_previous_complete_set(tmp_path):
    W = np.arange(10.0).reshape(5, 2)

    def save_set(it):
        ck = checkpoint.WheelCheckpoint(iteration=it, W=W)
        for k, (lo, hi) in enumerate([(0, 3), (3, 5)]):
            shard = dataclasses.replace(ck, W=W[lo:hi].copy())
            checkpoint.save_shard(shard, str(tmp_path), k, 2, (lo, hi), 5)

    save_set(3)
    save_set(7)
    newest = checkpoint.latest(str(tmp_path))
    assert "00000007" in newest
    bad = newest.replace(".s000of", ".s001of")
    with open(bad, "r+b") as f:              # truncate a shard mid-file
        f.truncate(os.path.getsize(bad) // 2)
    with metrics.window() as w:
        got = checkpoint.load_latest(str(tmp_path))
        assert w.delta("checkpoint.corrupt_skipped") >= 1
    assert got is not None and got.iteration == 3
    assert np.array_equal(got.W, W)
    reader = checkpoint.ShardedCheckpointReader(
        checkpoint.latest(str(tmp_path)))
    np.testing.assert_array_equal(reader.read_rows("W", 2, 5), W[2:5])


def test_corrupt_single_file_checkpoint_skipped(tmp_path):
    checkpoint.save(checkpoint.WheelCheckpoint(iteration=1,
                                               W=np.ones((3, 2))),
                    checkpoint.checkpoint_path(str(tmp_path), 1))
    p2 = checkpoint.save(checkpoint.WheelCheckpoint(iteration=2,
                                                    W=np.ones((3, 2))),
                         checkpoint.checkpoint_path(str(tmp_path), 2))
    with open(p2, "r+b") as f:
        f.truncate(80)
    with metrics.window() as w:
        assert checkpoint.load_latest(str(tmp_path)).iteration == 1
        assert w.delta("checkpoint.corrupt_skipped") >= 1
    # a corrupt file named explicitly still fails loud
    with pytest.raises(Exception):
        checkpoint.load(p2)


def test_verify_accepts_healthy_artifacts(tmp_path):
    ck = checkpoint.WheelCheckpoint(
        iteration=4, W=np.ones((4, 2)), xbars=np.zeros((4, 2)),
        rho=np.full((4, 2), 2.0))
    p = checkpoint.save(ck, checkpoint.checkpoint_path(str(tmp_path), 4))
    assert checkpoint.verify(p)
    for k, (lo, hi) in enumerate([(0, 2), (2, 4)]):
        shard = dataclasses.replace(ck, W=ck.W[lo:hi], xbars=None, rho=None)
        checkpoint.save_shard(shard, str(tmp_path), k, 2, (lo, hi), 4)
    with metrics.window() as w:
        assert checkpoint.verify(checkpoint.latest(str(tmp_path)))
        assert w.delta("checkpoint.corrupt_skipped") == 0


# ---- the W/xbar interchange through the checkpoint engine --------------------

def _ph(n=3, iters=3, **opts):
    return PH({"defaultPHrho": 1.0, "PHIterLimit": iters,
               "convthresh": -1.0, "device": "cpu", **opts},
              farmer.scenario_names_creator(n), farmer.scenario_creator,
              scenario_creator_kwargs={"num_scens": n})


def test_wxbar_golden_csv_format(tmp_path):
    """The csv is mpi-sppy's wxbarutils format: ``scenario,varname,value``
    rows a scenario and nonant slot, read raw, then round-tripped."""
    import csv as _csv

    wf = str(tmp_path / "w.csv")
    ph = _ph(iters=3)
    ph.ph_main(finalize=False)
    checkpoint.write_wxbar(ph, w_fname=wf)
    with open(wf) as f:
        rows = list(_csv.reader(f))
    names = ph.nonant_var_names
    S, K = ph.W.shape
    assert len(rows) == S * K
    for s, sname in enumerate(ph.all_scenario_names):
        for k in range(K):
            row = rows[s * K + k]
            assert row[0] == sname and row[1] == names[k]
            assert float(row[2]) == pytest.approx(ph.W[s, k], abs=0)
    ph2 = _ph(iters=1)
    ph2.W = np.zeros_like(ph.W)
    checkpoint.read_wxbar(ph2, w_fname=wf)
    np.testing.assert_allclose(ph2.W, ph.W, atol=1e-15)


def test_seed_resume_reapplies_spoke_bounds():
    """Resume re-seeds each spoke's bound by its stored kind, never by the
    resumed wheel's slot."""
    from tpusppy_torch.cylinders.hub import Hub

    class _Opt:
        is_minimizing = True

    def bare_hub(outer, inner):
        h = Hub.__new__(Hub)
        h.options = {}
        h.opt = _Opt()
        h.outerbound_spoke_indices = set(outer)
        h.innerbound_spoke_indices = set(inner)
        h.outerbound_spoke_chars = {i: 'L' for i in outer}
        h.innerbound_spoke_chars = {i: 'I' for i in inner}
        h.latest_spoke_bounds = {}
        h.latest_ib_char = h.latest_ob_char = None
        h.initialize_bound_values()
        return h

    h = bare_hub({1}, {2})
    h.seed_resume(checkpoint.WheelCheckpoint(
        iteration=5, W=np.zeros((1, 1)),
        best_inner=-100.0, best_outer=-130.0,
        spoke_bounds={"1": ["outer", -120.0], "2": ["inner", -105.0],
                      "9": ["outer", -125.0],   # the slot is gone: valid
                      "7": -1.0}))               # kind-less: skipped
    assert h.BestOuterBound == -120.0
    assert h.BestInnerBound == -105.0
    assert h.latest_spoke_bounds[1] == -120.0
    assert h.resumed_from_iteration == 5
    h2 = bare_hub({2}, {1})                 # the roles swapped
    h2.seed_resume(checkpoint.WheelCheckpoint(
        iteration=1, W=np.zeros((1, 1)),
        spoke_bounds={"1": ["outer", -120.0]}))
    assert h2.BestOuterBound == -120.0      # applied by its kind
    assert h2.BestInnerBound == np.inf      # never as an incumbent


def test_read_wxbar_mixed_csv_and_npz_respects_slots(tmp_path):
    """A csv W beside an npz xbar: the npz restores the xbar fields only,
    never the W the caller took from the csv."""
    wf = str(tmp_path / "w.csv")
    ckf = str(tmp_path / "state.npz")
    ph = _ph(iters=3)
    ph.ph_main(finalize=False)
    checkpoint.write_wxbar(ph, w_fname=wf)
    ck = checkpoint.capture_ph(ph)
    ck.W = ck.W + 1000.0                   # what a clobber would leak
    checkpoint.save(ck, ckf)
    ph2 = _ph(iters=1)
    ph2.W = np.zeros_like(ph.W)
    checkpoint.read_wxbar(ph2, w_fname=wf, xbar_fname=ckf)
    np.testing.assert_allclose(ph2.W, ph.W, atol=1e-12)
    np.testing.assert_allclose(ph2.xbars, ph.xbars, atol=1e-12)


def test_write_wxbar_npz_w_plus_csv_xbar_writes_both(tmp_path):
    ckf = str(tmp_path / "state.npz")
    xf = str(tmp_path / "xbar.csv")
    ph = _ph(iters=2)
    ph.ph_main(finalize=False)
    checkpoint.write_wxbar(ph, w_fname=ckf, xbar_fname=xf)
    assert os.path.exists(ckf) and os.path.exists(xf)
    ph2 = _ph(iters=1)
    ph2.xbars = np.zeros_like(ph.xbars)
    checkpoint.read_wxbar(ph2, xbar_fname=xf)
    np.testing.assert_allclose(ph2.xbars[0], ph.xbars[0], atol=1e-12)


def test_wxbar_npz_checkpoint_restores_everything(tmp_path):
    """An npz target of the extensions is a checkpoint: W, xbar and rho
    restore at once, and the csv written from the same state agrees."""
    from tpusppy_torch.extensions.wxbarreader import WXBarReader
    from tpusppy_torch.extensions.wxbarwriter import WXBarWriter

    ckf = str(tmp_path / "state.npz")
    wf = str(tmp_path / "w.csv")
    ph = _ph(iters=4, W_fname=ckf)
    ph.extobject = WXBarWriter(ph)
    ph.ph_main(finalize=False)
    checkpoint.write_wxbar(ph, w_fname=wf)
    ph2 = _ph(iters=1, init_W_fname=ckf)
    ph2.extobject = WXBarReader(ph2)
    ph2.Iter0()
    np.testing.assert_allclose(ph2.W, ph.W, atol=1e-12)
    np.testing.assert_allclose(ph2.xbars, ph.xbars, atol=1e-12)
    np.testing.assert_allclose(ph2.rho, ph.rho, atol=1e-12)
    ph3 = _ph(iters=1)
    ph3.W = np.zeros_like(ph.W)
    checkpoint.read_wxbar(ph3, w_fname=wf)
    np.testing.assert_allclose(ph3.W, ph2.W, atol=1e-12)


# ---- across the two packages -------------------------------------------------

def _rich_checkpoint(pkg):
    rng = np.random.default_rng(13)
    return pkg.WheelCheckpoint(
        iteration=11, W=rng.normal(size=(3, 4)), xbars=rng.normal(size=(3, 4)),
        xsqbars=rng.random((3, 4)), rho=np.full((3, 4), 2.0),
        best_inner=-108390.0, best_outer=-108512.5,
        spoke_bounds={"1": ["outer", -108512.5], "2": ["inner", -108390.0]},
        meta={"S": 3, "K": 4, "opt_class": "PH"})


@pytest.mark.parametrize("writer,reader", [(jcheckpoint, checkpoint),
                                           (checkpoint, jcheckpoint)],
                         ids=["reference_to_port", "port_to_reference"])
def test_checkpoint_files_load_in_the_other_package(tmp_path, writer,
                                                    reader):
    assert writer.CHECKPOINT_VERSION == reader.CHECKPOINT_VERSION
    ck = _rich_checkpoint(writer)
    path = writer.save(ck, writer.checkpoint_path(str(tmp_path), 11))
    assert reader.verify(path)
    assert reader.latest_iteration(str(tmp_path)) == 11
    back = reader.load_latest(str(tmp_path))
    for f in ("W", "xbars", "xsqbars", "rho"):
        np.testing.assert_array_equal(getattr(back, f), getattr(ck, f))
    for f in ("iteration", "best_inner", "best_outer", "spoke_bounds",
              "meta", "version"):
        assert getattr(back, f) == getattr(ck, f), f
    # the shard-set files too
    for k, (lo, hi) in enumerate([(0, 2), (2, 3)]):
        writer.save_shard(dataclasses.replace(ck, iteration=12,
                                              W=ck.W[lo:hi], xbars=None,
                                              xsqbars=None, rho=None),
                          str(tmp_path), k, 2, (lo, hi), 3)
    got = reader.load_latest(str(tmp_path))
    assert got.iteration == 12
    np.testing.assert_array_equal(got.W, ck.W)


def test_both_packages_resume_one_checkpoint_alike(tmp_path):
    """farmer S=3 in f64: a checkpoint the port wrote at iteration 3,
    resumed by both packages to 6 iterations in all (the legacy loop, as
    the PH comparisons run): W, xbars and eobj agree to 1e-7."""
    N, k = 6, 3
    legacy = {"solver_options": {"megastep": 1}}
    ckdir = str(tmp_path / "ck")
    WheelSpinner(_hub_only(k, {"checkpoint_dir": ckdir,
                               "checkpoint_every_iters": 1,
                               "checkpoint_every_secs": None},
                           **legacy), []).spin()
    assert checkpoint.latest_iteration(ckdir) == k
    ws = WheelSpinner(_hub_only(N, **legacy), [], resume=ckdir).spin()
    okw = _farmer_opt_kwargs(iters=N, **legacy)
    okw["options"].pop("device")
    okw["scenario_creator"] = jfarmer.scenario_creator
    jws = JWheelSpinner({"hub_class": JPHHub, "hub_kwargs": {"options": {}},
                         "opt_class": JPH, "opt_kwargs": okw}, [],
                        resume=ckdir).spin()
    assert ws.resumed_from == jws.resumed_from == k
    assert ws.opt._iter == jws.opt._iter == N
    np.testing.assert_allclose(ws.opt.W, np.asarray(jws.opt.W), rtol=1e-7,
                               atol=1e-7)
    np.testing.assert_allclose(ws.opt.xbars, np.asarray(jws.opt.xbars),
                               rtol=1e-7, atol=1e-7)
    e, je = ws.opt.Eobjective(), float(jws.opt.Eobjective())
    assert abs(e - je) <= 1e-7 * abs(je)

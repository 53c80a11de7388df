"""Continuous batching in the port (tpusppy_torch.parallel.sharded's tenant
window, tpusppy_torch.service.batching and the batched SolveServer) against
the reference's, in float64 on the CPU.

Device level: the reference's ``sharded.make_tenant_megastep`` and the
port's take the same K same-family tenants (farmer with each slot's costs
scaled, so every slot has its own trajectory), carried over from the
reference's refreshes (``tpusppy_torch.convert``), and agree per slot to
1e-9 (eobj, conv, residuals, W, xbars and the bound packs, relative to each
block's largest entry floored at 1), with equal executed counts and flags;
each slot also equals the port's solo window on its own state.  A ghost
slot's state passes through bit for bit.

Runner and server: joins, evictions and banking through the checkpoint
seam; ``SolveServer(batch_slots=2)`` end to end, with warm followers that
capture nothing and a deadline that evicts one slot only.
"""

import time

import numpy as np
import pytest
import torch

from tpusppy.ir import ScenarioBatch as JBatch
from tpusppy.models import farmer as jfarmer
from tpusppy.parallel import sharded as jsharded
from tpusppy.solvers.admm import ADMMSettings as JSettings
from tpusppy_torch import convert
from tpusppy_torch.models import farmer as tfarmer
from tpusppy_torch.obs import metrics
from tpusppy_torch.parallel import sharded as tsharded
from tpusppy_torch.resilience import checkpoint as ck
from tpusppy_torch.service import SolveRequest, SolveServer
from tpusppy_torch.service import canonical as canonical_mod
from tpusppy_torch.service import server as server_mod
from tpusppy_torch.service.batching import (METERED, BatchedFamilyRunner,
                                            BoundTracker, qos_rank)
from tpusppy_torch.solvers import cuda_kernels
from tpusppy_torch.solvers.admm import ADMMSettings as TSettings

torch.set_num_threads(1)

SETTINGS = dict(max_iter=120, restarts=2, check_every=4)
SCALES = (1.0, 1.07, 0.93)


def _close(got, ref, tol, what=""):
    """Within ``tol`` of ``ref``'s largest finite entry (floored at 1);
    non-finite entries must sit at the same places with the same values."""
    got = np.asarray(got, dtype=float)
    ref = np.asarray(ref, dtype=float)
    assert got.shape == ref.shape, what
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(got[~fin], ref[~fin], err_msg=what)
    got, ref = got[fin], ref[fin]
    scale = max(1.0, float(np.max(np.abs(ref))) if ref.size else 1.0)
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} * {scale:.3g}"


def _t(v):
    return torch.tensor(np.asarray(v), dtype=torch.float64)


class _Tenants:
    """K farmer tenants of one family (costs scaled per slot): the
    reference's arrays, refreshed states and factors, and their twins in
    the port."""

    def __init__(self, S, K):
        names = jfarmer.scenario_names_creator(S)
        batch = JBatch.from_problems(
            [jfarmer.scenario_creator(nm, num_scens=S) for nm in names])
        self.S, self.K = S, K
        self.idx = batch.tree.nonant_indices
        mesh = jsharded.make_mesh(1)
        st = JSettings(**SETTINGS)
        refresh, _ = jsharded.make_ph_step_pair(self.idx, st, mesh)
        arr0 = jsharded.shard_batch(batch, mesh)
        self.jarrs, self.jstates, self.jfactors = [], [], []
        self.tarrs, self.tstates, self.tfactors = [], [], []
        for k in range(K):
            ja = arr0._replace(c=arr0.c * SCALES[k])
            state = jsharded.init_state(ja, 1.0, st)
            state, _, _ = refresh(state, ja, 0.0)
            jst, _, jf = refresh(state, ja, 1.0)
            self.jarrs.append(ja)
            self.jstates.append(jst)
            self.jfactors.append(jf)
            self.tarrs.append(tsharded.PHArrays(
                c=_t(ja.c), q2=_t(ja.q2), A=_t(ja.A), cl=_t(ja.cl),
                cu=_t(ja.cu), lb=_t(ja.lb), ub=_t(ja.ub),
                const=_t(ja.const), probs=_t(ja.probs),
                onehot=_t(ja.onehot),
                nid_sk=torch.tensor(np.asarray(ja.nid_sk),
                                    dtype=torch.int64)))
            self.tstates.append(tsharded.PHState(*(_t(v) for v in jst)))
            self.tfactors.append(convert.factors_from_arrays(
                {k2: np.asarray(v) for k2, v in jf._asdict().items()},
                "cpu"))


_CACHE = {}


def _tenants(S, K):
    if (S, K) not in _CACHE:
        _CACHE[(S, K)] = _Tenants(S, K)
    return _CACHE[(S, K)]


@pytest.mark.parametrize("S,K,ghost,bounds,N", [
    (3, 3, False, False, 5), (3, 2, True, True, 4),
    (5, 3, True, False, 4), (5, 2, False, True, 3)],
    ids=["S3-K3", "S3-K2-ghost-bounds", "S5-K3-ghost", "S5-K2-bounds"])
def test_tenant_window_matches_reference_and_solo(S, K, ghost, bounds, N):
    ts = _tenants(S, K)
    live = np.ones(K, bool)
    if ghost:
        live[-1] = False
    bl = np.ones(K, bool)
    if bounds and K > 1 and not ghost:
        bl[1] = False               # a live slot with its pass off
    jst = JSettings(**SETTINGS)
    tst = TSettings(**SETTINGS)
    jm = jsharded.make_tenant_megastep(ts.idx, jst, n_iters=N,
                                       donate=False, bounds=bounds)
    tm = tsharded.make_tenant_megastep(ts.idx, tst, n_iters=N,
                                       bounds=bounds)
    extra = (bl, 1e-3) if bounds else ()
    jstates, jp = jm(tuple(ts.jstates), tuple(ts.jarrs), 1.0,
                     tuple(ts.jfactors), np.full(K, -1.0), np.full(K, N),
                     np.inf, live, *extra)
    launches = [{} for _ in range(K)]
    metered = [{"device_loop.replays": 0.0} for _ in range(K)]
    with metrics.window() as w:
        tstates, tp = tm(tuple(ts.tstates), tuple(ts.tarrs), 1.0,
                         tuple(ts.tfactors), np.full(K, -1.0),
                         np.full(K, N), np.inf, live, *extra,
                         slot_launches=launches, slot_metrics=metered)
    # each slot's sweep-loop replays are metered to it, the ghost's none
    assert sum(m["device_loop.replays"] for m in metered) \
        == w.delta("device_loop.replays")
    for t in range(K):
        assert (metered[t]["device_loop.replays"] > 0) == bool(live[t])
    assert tp.numel() == tsharded.tenant_megastep_measure_len(
        N, S, K, bounds=bounds)
    jmeas = jsharded.tenant_megastep_unpack(np.asarray(jp), N, S, K,
                                            bounds=bounds)
    tmeas = tsharded.tenant_megastep_unpack(tp.numpy(), N, S, K,
                                            bounds=bounds)
    for t in range(K):
        for k in ("executed", "refresh_hit"):
            assert tmeas[k][t] == jmeas[k][t], (k, t)
        np.testing.assert_array_equal(tmeas["iters"][t], jmeas["iters"][t])
        np.testing.assert_array_equal(tmeas["done"][t], jmeas["done"][t])
        for k in ("conv", "eobj", "pri_max", "dua_max", "pri", "dua"):
            _close(tmeas[k][t], jmeas[k][t], 1e-9, f"{k}[{t}]")
        for k in ("W", "xbars", "x"):
            _close(getattr(tstates[t], k).numpy(),
                   np.asarray(getattr(jstates[t], k)), 1e-9, f"{k}[{t}]")
        if bounds:
            assert tmeas["bound_computed"][t] == jmeas["bound_computed"][t]
            for k in ("bound_outer", "bound_inner_obj", "bound_inner_feas",
                      "bound_sweeps"):
                _close(tmeas[k][t], jmeas[k][t], 1e-9, f"{k}[{t}]")
        if not live[t]:
            # a ghost runs nothing: its state passes through bit for bit
            assert tmeas["executed"][t] == 0 and not launches[t]
            for k in tsharded.PHState._fields:
                assert torch.equal(getattr(tstates[t], k),
                                   getattr(ts.tstates[t], k)), k
            continue
        # the plain versions' sweeps stand in for the kernel here
        assert launches[t].get(("plain_calls", "fused_sweeps"), 0) > 0
        # each live slot is its solo window on its own state
        solo = tsharded.make_wheel_megastep(ts.idx, tst, n_iters=N,
                                            pack="lean", bounds=bounds)
        kw = (dict(bound_live=bool(bl[t]), feas_tol=1e-3) if bounds
              else {})
        sst, sp = solo(ts.tstates[t], ts.tarrs[t], 1.0, ts.tfactors[t],
                       -1.0, N, np.inf, **kw)
        sm = tsharded.megastep_unpack(sp.numpy(), N, S, 0, 0, pack="lean",
                                      bounds=bounds)
        assert sm["executed"] == tmeas["executed"][t]
        _close(tmeas["eobj"][t], sm["eobj"], 1e-9, "solo eobj")
        for k in ("W", "xbars"):
            _close(getattr(tstates[t], k).numpy(),
                   getattr(sst, k).numpy(), 1e-9, f"solo {k}")
        if bounds:
            _close(tmeas["bound_outer"][t], sm["bound_outer"], 1e-9,
                   "solo bound_outer")
    # the population really is mixed: live trajectories differ
    assert float((tstates[0].xbars - tstates[1].xbars).abs().max()) > 1e-6 \
        or not live[1]


# ---- the runner ---------------------------------------------------------------
OPT = {"defaultPHrho": 1.0, "PHIterLimit": 60, "convthresh": -1.0,
       "in_wheel_bounds": True, "device": "cpu",
       "xhat_looper_options": {"scen_limit": 3}}


def _ingest(opt, n=3):
    names = tfarmer.scenario_names_creator(n)
    kw = tfarmer.kw_creator(num_scens=n)
    return canonical_mod.ingest(names, tfarmer.scenario_creator, kw,
                                options=opt)


def test_runner_certifies_attributes_and_counts(tmp_path):
    canon = _ingest(OPT)
    runner = BatchedFamilyRunner(canon, OPT, k_slots=3)
    with metrics.window() as w:
        runner.admit("a", canon, str(tmp_path / "a"), 60, resume=False)
        runner.admit("b", canon, str(tmp_path / "b"), 60, resume=False)
        assert runner.free_slots() == 1
        gaps = {}
        for _ in range(20):
            reps = runner.window()
            for rid, rep in reps.items():
                assert rep["wall_s"] >= 0.0 and rep["flops"] > 0.0
                if rep["rel_gap"] <= 1e-3:
                    gaps[rid] = rep["rel_gap"]
                    runner.complete(rid)
            if not runner.live_rids():
                break
        assert set(gaps) == {"a", "b"}
        assert w.delta("batching.joins") == 2
        assert w.delta("batching.windows") > 0
        # the third slot rode as a ghost
        assert w.delta("batching.ghost_rows") > 0
    # equal tenants, equal gaps; each slot's windows launched its sweeps
    assert gaps["a"] == pytest.approx(gaps["b"], rel=1e-12)
    assert all(sl.get(("plain_calls", "fused_sweeps"), 0) > 0
               for sl in runner.slot_launches[:2])
    assert not runner.slot_launches[2]
    runner.close()


def test_runner_evict_bank_readmit_resumes(tmp_path):
    canon = _ingest(OPT)
    runner = BatchedFamilyRunner(canon, OPT, k_slots=2)
    d = str(tmp_path / "t")
    runner.admit("t", canon, d, 60, resume=False)
    for _ in range(2):
        reps = runner.window()
    pre = reps["t"]
    with metrics.window() as w:
        banked_iter = runner.evict("t", bank=True)
        assert w.delta("batching.evictions") == 1
    assert banked_iter == pre["iters"]
    assert ck.latest_iteration(d) == banked_iter
    banked = ck.load_latest(d)
    assert banked.meta["source"] == "B" and banked.W.shape == (3, 3)
    assert not runner.has("t") and runner.free_slots() == 2
    info = runner.admit("t", canon, d, 60, resume=True)
    assert info["resumed"] and info["iteration"] == banked_iter
    assert runner.tracker("t").best_outer >= pre["outer"] - 1e-9
    for _ in range(20):
        reps = runner.window()
        if reps["t"]["rel_gap"] <= 1e-3:
            break
    assert reps["t"]["rel_gap"] <= 1e-3
    assert reps["t"]["iters"] > banked_iter
    # a mid-run bank keeps the slot live
    assert runner.bank("t") == reps["t"]["iters"] and runner.has("t")


def test_bound_tracker_and_qos():
    tr = BoundTracker()
    assert tr.gaps() == (float("inf"), float("inf"))
    tr.outer_update(-110.0)
    tr.outer_update(-120.0)
    tr.inner_update(-100.0)
    tr.inner_update(-90.0)
    tr.outer_update(float("nan"))
    abs_gap, rel_gap = tr.gaps()
    assert abs_gap == pytest.approx(10.0)
    assert rel_gap == pytest.approx(10.0 / 110.0)
    assert qos_rank("interactive") < qos_rank("standard") < qos_rank("batch")
    assert qos_rank(None) == qos_rank("nonsense") == qos_rank("standard")


# ---- the server ---------------------------------------------------------------
def _req(rid, n=3, iters=60, deadline=None, **opts):
    return SolveRequest(model="farmer", num_scens=n, request_id=rid,
                        deadline_secs=deadline,
                        options=dict({"PHIterLimit": iters, "device": "cpu"},
                                     **opts))


def test_server_batched_end_to_end_warm_and_deadline(tmp_path):
    with SolveServer(work_dir=str(tmp_path), batch_slots=2,
                     in_wheel_bounds=True, quantum_secs=300.0,
                     linger_secs=0.0) as srv:
        with metrics.window() as w:
            rids = [srv.submit(_req(f"r{i}")) for i in range(2)]
            time.sleep(0.2)
            rids.append(srv.submit(_req("r2")))
            recs = [srv.result(r, timeout=300) for r in rids]
            assert w.delta("batching.joins") >= 3
            replays = w.delta("device_loop.replays")
        for rec in recs:
            assert rec["status"] == "done" and rec["batched"] is True
            assert rec["certified"], rec
            assert rec["rel_gap"] <= 1e-3 + 1e-12
            assert rec["attributed_flops"] > 0.0
        assert not recs[0]["warm_hit"]
        for rec in recs[1:]:
            assert rec["warm_hit"] and rec["aot_misses"] == 0
        # each member's record holds its own sweep-loop replays, and every
        # replay of the run is billed to one of them
        assert all(rec["aot_hits"] > 0 for rec in recs)
        assert sum(rec["aot_hits"] for rec in recs) == replays
        assert recs[1]["rel_gap"] == pytest.approx(recs[0]["rel_gap"],
                                                   rel=1e-9)
        assert srv.submit(_req("r0")) == "r0"          # idempotent
        # a deadline evicts its own slot only; the sibling certifies
        doomed = srv.submit(_req("doomed", iters=100000, rel_gap=1e-12,
                                 deadline=3.0))
        ok = srv.submit(_req("ok"))
        rec_ok = srv.result(ok, timeout=300)
        rec_dl = srv.result(doomed, timeout=300)
        assert rec_ok["status"] == "done" and rec_ok["certified"]
        assert rec_ok["batched"] is True
        assert rec_dl["status"] == "failed"
        assert rec_dl["error_code"] == "deadline"
        assert not rec_dl["certified"] and rec_dl["iters"] > 0
        assert ck.latest_iteration(srv._tenants[doomed].dir) is not None
    # kernel launches of the batched windows are the plain sweeps here
    assert cuda_kernels.plain_calls["fused_sweeps"] > 0


def test_server_batched_bills_each_member_its_own_captures(tmp_path,
                                                           monkeypatch):
    """A graph capture made by a member's admission or its slot's refresh
    is billed to that member's record, not the leader's: the card's
    warm-follower check reads these records.  Every refresh here counts
    one capture (the CPU captures none)."""
    names = {nm for _, nms in server_mod._WARM_KEYS for nm in nms}
    assert names <= set(METERED)
    make_pair = tsharded.make_ph_step_pair

    def counting_pair(*args, **kwargs):
        refresh, frozen = make_pair(*args, **kwargs)

        def counted(*a, **kw):
            metrics.inc("device_loop.captures")
            return refresh(*a, **kw)
        return counted, frozen

    monkeypatch.setattr(tsharded, "make_ph_step_pair", counting_pair)
    with SolveServer(work_dir=str(tmp_path), batch_slots=2,
                     in_wheel_bounds=True, quantum_secs=300.0,
                     linger_secs=0.0) as srv:
        with metrics.window() as w:
            rids = [srv.submit(_req(f"c{i}", iters=20, rel_gap=1e-12))
                    for i in range(2)]
            recs = [srv.result(r, timeout=300) for r in rids]
            total = w.delta("device_loop.captures")
            joins = w.delta("batching.joins")
    assert joins == 2
    for rec in recs:
        # Iter0 at admission and at least one window refresh each
        assert rec["batched"] and rec["iters"] == 20
        assert rec["aot_misses"] >= 2, rec
    assert sum(rec["aot_misses"] for rec in recs) == total

"""The port's in-wheel certification against the reference's, float64 on the
CPU: the megastep window's fused bound pass (tpusppy_torch.parallel.sharded
._bound_pass_terms) and PHBase's consumption of it.

The reference runs Iter0 and three legacy iterations; its state (W, xbars,
rho, warm start, refresh factors) is carried into a port PH
(``tpusppy_torch.convert.load_ph_state``), and both run ONE bound-pass
window with ``n_live=0``, which evaluates exactly the carried state.  The
outer bound (the W-augmented weak-duality assembly), the inner bound (the
xhat-at-xbar frozen evaluation) and its feasible mass agree with the
reference's to 1e-9 and with the port's host twins
(``lagrangian_bounder.in_wheel_outer_bound``,
``xhatxbar_bounder.in_wheel_inner_bound``) to 1e-9, on the dense engine
(farmer S=3) and the shared-A engine (uc_lite, 3 generators x 6 hours,
S=4).  Then: a hub-only farmer S=3 wheel certifies with no spoke (full and
lean pack), an infeasible evaluation never offers an inner bound,
``in_wheel_bound_every``, maximization declines, the cap reservation never
kills the megastep, the host rescue is exact and keeps its cadence.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpusppy.models import farmer as jfarmer
from tpusppy.models import uc_lite as juc_lite
from tpusppy.opt.ph import PH as JPH
from tpusppy.solvers import scipy_backend as jscipy
from tpusppy_torch import convert
from tpusppy_torch.cylinders import PHHub
from tpusppy_torch.cylinders.lagrangian_bounder import in_wheel_outer_bound
from tpusppy_torch.cylinders.xhatxbar_bounder import in_wheel_inner_bound
from tpusppy_torch.models import farmer as tfarmer
from tpusppy_torch.models import uc_lite as tuc_lite
from tpusppy_torch.obs import metrics
from tpusppy_torch.opt.ph import PH as TPH
from tpusppy_torch.spin_the_wheel import WheelSpinner

torch.set_num_threads(1)

FARMER_EF = -108390.0
UC_KW = {"num_gens": 3, "horizon": 6, "relax_integers": True}
INFEASIBLE = {"bound_computed": True, "bound_outer": -np.inf,
              "bound_inner_obj": 0.0, "bound_inner_feas": 0.0,
              "bound_sweeps": 1.0}


def _options(rho, iters, **extra):
    return {"defaultPHrho": rho, "PHIterLimit": iters, "convthresh": -1.0,
            "in_wheel_bounds": True, **extra}


def _carried(model_j, model_t, kw, rho, iters=3):
    """(reference PH, port PH) at the reference's state after Iter0 and
    ``iters`` legacy iterations."""
    S = kw["num_scens"]
    names = model_j.scenario_names_creator(S)
    jph = JPH(_options(rho, 40, solver_options={"megastep": 1}), names,
              model_j.scenario_creator, scenario_creator_kwargs=kw)
    jph.Iter0()
    for k in range(1, iters + 1):
        jph._iterk_one(k, -1.0)
    tph = TPH(_options(rho, 40, device="cpu"), names,
              model_t.scenario_creator, scenario_creator_kwargs=kw)
    convert.load_ph_state(
        tph, jph.W, jph.xbars, jph.rho,
        warm=tuple(np.asarray(v) for v in jph._warm),
        factors=(jph._factors._asdict() if jph.batch.A_shared is not None
                 else {k: np.asarray(v)
                       for k, v in jph._factors._asdict().items()}),
        factors_age=jph._factors_age, iteration=jph._iter)
    tph.pri_res, tph.dua_res = (np.asarray(jph.pri_res),
                                np.asarray(jph.dua_res))
    return jph, tph


def _bound_scalars(ph):
    """ONE bound-pass window with ``n_live=0``: no iteration runs, so the
    pass evaluates exactly the current state."""
    meas = ph._megastep_solve(4, 0, -1.0, ph.W, ph.xbars, ph.rho,
                              bound_live=True)
    assert meas["executed"] == 0 and meas["bound_computed"]
    return meas


def _same_bounds(tm, jm, tph):
    scale = max(1.0, abs(jm["bound_outer"]), abs(jm["bound_inner_obj"]))
    for k in ("bound_outer", "bound_inner_obj"):
        assert abs(tm[k] - jm[k]) <= 1e-9 * scale, k
    assert tm["bound_inner_feas"] == pytest.approx(jm["bound_inner_feas"],
                                                   abs=1e-12)
    assert tm["bound_sweeps"] == jm["bound_sweeps"]
    ob = in_wheel_outer_bound(tph)
    assert abs(tm["bound_outer"] - ob) <= 1e-9 * scale
    ib, feas = in_wheel_inner_bound(tph)
    assert abs(tm["bound_inner_obj"] - ib) <= 1e-9 * scale
    assert tm["bound_inner_feas"] == pytest.approx(feas, abs=1e-12)


@pytest.fixture(scope="module")
def farmer_pair():
    return _carried(jfarmer, tfarmer, {"num_scens": 3}, 1.0)


@pytest.fixture(scope="module")
def uc_pair():
    return _carried(juc_lite, tuc_lite, dict(UC_KW, num_scens=4), 500.0)


def test_dense_bounds_match_reference_and_host_twins(farmer_pair):
    jph, tph = farmer_pair
    _same_bounds(_bound_scalars(tph), _bound_scalars(jph), tph)


def test_shared_bounds_match_reference_and_host_twins(uc_pair):
    jph, tph = uc_pair
    assert tph.batch.A_shared is not None
    _same_bounds(_bound_scalars(tph), _bound_scalars(jph), tph)


def test_device_pass_clips_the_candidate_like_the_host_twin(farmer_pair):
    """xbars eps outside the nonant box (ADMM tolerance noise) are clipped
    by the device candidate as by the host rule."""
    _, tph = farmer_pair
    nid = tph.tree.nonant_indices
    held = tph.xbars
    tph.xbars = np.array(held, dtype=float)
    tph.xbars[:, 0] = np.asarray(tph.batch.lb)[:, nid][:, 0] - 4e-8
    try:
        meas = _bound_scalars(tph)
        ib, feas = in_wheel_inner_bound(tph)
    finally:
        tph.xbars = held
    assert abs(meas["bound_inner_obj"] - ib) <= 1e-9 * max(1.0, abs(ib))
    assert meas["bound_inner_feas"] == pytest.approx(feas, abs=1e-12)


class _Hub:
    """The typed bound updates a hub offers, recorded."""

    def __init__(self):
        self.inner, self.outer = [], []

    def OuterBoundUpdate(self, b, idx=None, char='*'):
        self.outer.append((b, char))

    def InnerBoundUpdate(self, b, idx=None, char='*'):
        self.inner.append((b, char))


def test_infeasible_evaluation_never_offers_an_inner_bound(farmer_pair):
    _, tph = farmer_pair
    hub = tph.spcomm = _Hub()
    try:
        with metrics.window() as w:
            tph._consume_inwheel_bounds(dict(
                INFEASIBLE, bound_outer=-1e6, bound_inner_obj=-1.0,
                bound_inner_feas=0.5))
            assert w.delta("megastep.bound_pass_infeasible") == 1
        assert hub.outer == [(-1e6, 'M')]
        # the rescue may certify the host candidate, never the device value
        assert (-1.0, 'M') not in hub.inner
        hub.inner.clear()
        tph._consume_inwheel_bounds(dict(
            INFEASIBLE, bound_outer=-1e6, bound_inner_obj=-1.0,
            bound_inner_feas=1.0))
        assert hub.inner == [(-1.0, 'M')]
    finally:
        tph.spcomm = None


def test_host_rescue_is_exact_and_posts_as_M(uc_pair):
    """A gate miss runs the host rescue on the SAME candidate: per-scenario
    HiGHS LPs on the clamped batch, checked against the reference's host
    LPs of that batch."""
    jph, tph = uc_pair
    hub = tph.spcomm = _Hub()
    try:
        with metrics.window() as w:
            tph._consume_inwheel_bounds(dict(INFEASIBLE))
            assert w.delta("megastep.bound_rescues") == 1
    finally:
        tph.spcomm = None
    assert len(hub.inner) == 1 and hub.inner[0][1] == 'M'
    nid = tph.tree.nonant_indices
    b = jph.batch
    cand = np.clip(np.array(tph.xbars, dtype=float),
                   np.asarray(b.lb)[:, nid], np.asarray(b.ub)[:, nid])
    lb = np.array(b.lb, copy=True)
    ub = np.array(b.ub, copy=True)
    lb[:, nid] = cand
    ub[:, nid] = cand
    res = jscipy.solve_batch(dataclasses.replace(b, lb=lb, ub=ub), mip=False)
    ref = float(np.asarray(jph.probs, float) @ np.array([r.obj for r in res]))
    assert hub.inner[0][0] == pytest.approx(ref, rel=1e-9)


def test_rescue_cadence_backoff_and_disable(farmer_pair, monkeypatch):
    _, tph = farmer_pair
    tph.options["in_wheel_rescue_every"] = 3
    tph._inwheel_gate_misses = tph._inwheel_next_rescue = 0
    tph._inwheel_rescue_declines = 0
    calls = []
    try:
        monkeypatch.setattr(type(tph), "_inwheel_host_rescue",
                            lambda self: calls.append(1) or -1.0)
        for _ in range(6):
            tph._consume_inwheel_bounds(dict(INFEASIBLE))
        # misses 0 and 3 rescue; 1, 2, 4, 5 wait out the cadence
        assert len(calls) == 2
        # a declined rescue retries after a growing backoff: misses 6, 7, 9
        monkeypatch.setattr(type(tph), "_inwheel_host_rescue",
                            lambda self: calls.append(1) and None)
        tph._inwheel_next_rescue = 6
        calls.clear()
        for _ in range(6):
            tph._consume_inwheel_bounds(dict(INFEASIBLE))
        assert len(calls) == 3
        tph.options["in_wheel_host_rescue"] = False
        calls.clear()
        tph._consume_inwheel_bounds(dict(INFEASIBLE))
        assert not calls
    finally:
        for k in ("in_wheel_rescue_every", "in_wheel_host_rescue"):
            tph.options.pop(k, None)


def test_maximization_and_the_cap_reservation_decline(farmer_pair,
                                                      monkeypatch):
    _, tph = farmer_pair
    assert tph._inwheel_on()
    assert tph._megastep_cap_with_bounds(lambda bp: 1 if bp else 2) == 2
    assert not tph._inwheel_on()        # declined for this family
    del tph._inwheel_cap_declined
    monkeypatch.setattr(type(tph), "is_minimizing",
                        property(lambda self: False))
    assert not tph._inwheel_on()


def test_bound_every_skips_windows():
    ph = TPH(_options(1.0, 8, device="cpu", solver_refresh_every=4,
                      in_wheel_bound_every=2),
             tfarmer.scenario_names_creator(3), tfarmer.scenario_creator,
             scenario_creator_kwargs={"num_scens": 3})
    with metrics.window() as w:
        ph.ph_main(finalize=False)
        # windows 2-4 (its pass runs) and 6-8 (skipped)
        assert w.delta("dispatch.megasteps") == 2
        assert w.delta("megastep.bound_passes") == 1


@pytest.mark.parametrize("lean", [False, True], ids=["full", "lean"])
def test_hub_only_wheel_certifies(lean):
    """A PHHub and no spoke: the windows' own bounds certify the farmer
    with outer <= EF <= inner."""
    opt_kwargs = {
        "options": _options(1.0, 60, device="cpu", ph_device_state=lean),
        "all_scenario_names": tfarmer.scenario_names_creator(3),
        "scenario_creator": tfarmer.scenario_creator,
        "scenario_creator_kwargs": {"num_scens": 3}}
    hub = {"hub_class": PHHub,
           "hub_kwargs": {"options": {"rel_gap": 5e-3}},
           "opt_class": TPH, "opt_kwargs": opt_kwargs}
    with metrics.window() as w:
        ws = WheelSpinner(hub, []).spin()
        assert w.delta("megastep.bound_passes") >= 1
        if lean:
            assert w.delta("phstate.boundary_fetches") >= 1
    assert not ws.spoke_comms
    assert ws.spcomm.stop_reason == "rel_gap" and ws.opt._iter < 60
    assert np.isfinite(ws.BestInnerBound)
    assert ws.BestOuterBound <= FARMER_EF + 1e-6
    assert ws.BestInnerBound >= FARMER_EF - 1e-6
    gap = ws.BestInnerBound - ws.BestOuterBound
    assert 0 <= gap <= 5e-3 * abs(ws.BestOuterBound)


def test_host_rescue_takes_a_consensus_at_the_solvers_tolerance():
    """The candidate is a consensus of eps-accurate solutions: a row that
    couples nonant columns alone (farmer's land row) can carry that noise.
    The host rescue runs HiGHS at its default tolerances, as the
    reference's does (tpusppy/phbase.py:710-719), so a land row 2e-6 over
    (an f32 consensus) declines, as does 1e-3 over, and the land met
    certifies (tests/test_torch_inwheel_sparse.py holds both packages'
    rescues to each other)."""
    ph = TPH(_options(1.0, 2, device="cpu", solver_options={
        "eps_abs": 1e-5, "eps_rel": 1e-5}),
        tfarmer.scenario_names_creator(3), tfarmer.scenario_creator,
        scenario_creator_kwargs={"num_scens": 3})
    acres = np.array([170.0, 80.0, 250.0])       # the EF's, land 500
    for over, certified in ((0.0, True), (2e-6, False), (1e-3, False)):
        ph.xbars = np.tile(acres + over / 3.0, (3, 1))
        ib = ph._inwheel_host_rescue()
        assert (ib is not None) == certified, over
        if certified:
            assert ib == pytest.approx(FARMER_EF, rel=1e-9)

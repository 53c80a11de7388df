"""The bucketed in-wheel bound pass (plain and integer) and the bucketed
integer evaluation: the port against the reference, float64 on the CPU.

farmer 7 scenarios in 3 bundles at bucket quantum 1 (two buckets) runs
PH with ``in_wheel_bounds`` in both packages, then one window with the
bound pass on each opt's own state: the outer bound, the inner bound and
its feasible mass agree to 1e-7 and bracket the HiGHS EF.  netdes 7
scenarios in 3 bundles runs the integer pass (the ladder without the
SLAM slams, the best candidate chosen across buckets, reduced-cost
fixing per bucket): the feasible-candidate count, the best candidate's
index, the tightened and the untightened outer bound are the reference's,
and the outer bound lies below the EF MIP optimum.  ``Xhat_Eval`` on
bundled sizes S=3 (every column integer, so each bucket dives, retries and
solves its residue by host MILPs; HiGHS at a time limit that never binds)
gives the reference's objective and feasibility at one candidate.
"""

import numpy as np
import pytest
import torch

from tpusppy.models import farmer as jfarmer
from tpusppy.models import netdes as jnetdes
from tpusppy.models import sizes as jsizes
from tpusppy.opt.ph import PH as JPH
from tpusppy.xhat_eval import Xhat_Eval as JXhat
from tpusppy_torch import ir as tir
from tpusppy_torch.ef import solve_ef
from tpusppy_torch.models import farmer as tfarmer
from tpusppy_torch.models import netdes as tnetdes
from tpusppy_torch.models import sizes as tsizes
from tpusppy_torch.obs import metrics
from tpusppy_torch.opt.ph import PH as TPH
from tpusppy_torch.parallel import sharded as tsharded
from tpusppy_torch.spbase import build_batch
from tpusppy_torch.xhat_eval import Xhat_Eval as TXhat

torch.set_num_threads(1)

N = 7
BUCKETED = {"bundles_per_rank": 3, "shape_buckets": True,
            "shape_bucket_quantum": 1}
BOUND_KEYS = ("bound_outer", "bound_inner_obj", "bound_inner_feas")


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


def _ph_pair(jmod, tmod, kw, **extra):
    opts = dict(BUCKETED, defaultPHrho=1.0, PHIterLimit=2, convthresh=-1.0,
                solver_refresh_every=6, in_wheel_bounds=True, **extra)
    names = tmod.scenario_names_creator(N)
    jph = JPH(dict(opts), names, jmod.scenario_creator,
              scenario_creator_kwargs=kw)
    tph = TPH(dict(opts, device="cpu"), names, tmod.scenario_creator,
              scenario_creator_kwargs=kw)
    jph.ph_main(finalize=False)
    tph.ph_main(finalize=False)
    assert isinstance(tph.batch, tir.BucketedBatch)
    assert len(tph.batch.buckets) == 2
    return jph, tph


def _ef(tmod, kw, mip):
    b, _ = build_batch(tmod.scenario_names_creator(N), tmod.scenario_creator,
                       kw)
    return solve_ef(b, solver="highs", mip=mip, time_limit=600.0)[0]


def test_bucketed_plain_bound_pass_matches_reference_and_brackets_ef():
    kw = {"num_scens": N}
    jph, tph = _ph_pair(jfarmer, tfarmer, kw)
    assert not tph._inwheel_int_sweep_on()
    jm = jph._megastep_solve_bucketed(3, 3, -1.0, jph.W, jph.xbars, jph.rho,
                                      bound_live=True)
    with metrics.window() as w:
        tm = tph._megastep_solve_bucketed(3, 3, -1.0, tph.W, tph.xbars,
                                          tph.rho, bound_live=True)
        assert w.delta("megastep.bound_passes") == 1
    assert tm["bound_computed"] and jm["bound_computed"]
    for k in BOUND_KEYS:
        assert _rel(tm[k], jm[k]) <= 1e-7, k
    assert tm["bound_sweeps"] > 0
    ef = _ef(tfarmer, kw, mip=False)
    assert tm["bound_outer"] <= ef + 1e-6 * abs(ef)
    assert tm["bound_inner_feas"] == pytest.approx(1.0, abs=1e-9)
    assert tm["bound_inner_obj"] >= ef - 1e-6 * abs(ef)
    # one evaluation a bucket, each through fused_sweeps' plain version
    assert [len(r) for r in tph.bound_pass_launches] == [1, 1]
    for rec in tph.bound_pass_launches:
        assert rec[0].get(("plain_calls", "fused_sweeps"), 0) > 0
    # the tail is off where bound_live is False: zeros, computed False
    off = tph._megastep_solve_bucketed(3, 3, -1.0, tph.W, tph.xbars,
                                       tph.rho, bound_live=False)
    assert not off["bound_computed"] and off["bound_outer"] == 0.0


def test_bucketed_integer_bound_pass_matches_reference():
    kw = {"num_scens": N, "relax_integers": False}
    jph, tph = _ph_pair(jnetdes, tnetdes, kw, integer_escalation=False)
    assert tph._inwheel_int_sweep_on()
    # the bucketed pass drops the slams: the ladder and the re-certification
    assert tph._inwheel_pass_evals() == jph._inwheel_pass_evals() == 4
    jm = jph._megastep_solve_bucketed(3, 0, -1.0, jph.W, jph.xbars, jph.rho,
                                      bound_live=True)
    tm = tph._megastep_solve_bucketed(3, 0, -1.0, tph.W, tph.xbars, tph.rho,
                                      bound_live=True)
    assert tm["bound_computed"]
    for k in ("int_feas_cands", "int_best_idx", "int_rcfix_slots"):
        assert tm[k] == jm[k], k
    for k in BOUND_KEYS + ("bound_outer_base",):
        assert _rel(tm[k], jm[k]) <= 1e-7, k
    assert tm["bound_outer"] >= tm["bound_outer_base"] - 1e-9
    mip = _ef(tnetdes, kw, mip=True)
    assert tm["bound_outer"] <= mip + 1e-6 * abs(mip)
    # launches by bucket, then by evaluation: three candidates and the
    # re-certification in each bucket
    assert [len(r) for r in tph.bound_pass_launches] == [4, 4]
    for rec in tph.bound_pass_launches:
        assert all(r.get(("plain_calls", "fused_sweeps"), 0) > 0 for r in rec)


def test_bucketed_window_builds_with_bounds_and_integer_rounding():
    """The window function takes the bound pass and its integer branch
    (they raised before the bucketed pass was ported); a family whose
    buckets carry no integer nonant keeps the plain tail."""
    from tpusppy_torch.solvers.admm import ADMMSettings

    st = ADMMSettings()
    assert callable(tsharded.make_bucketed_wheel_megastep(
        np.arange(3), st, 4, bounds=True))
    assert callable(tsharded.make_bucketed_wheel_megastep(
        np.arange(3), st, 4, bounds=True, int_rounding=(0.5,),
        int_nonants=(np.array([True, False, True]), None)))
    assert tsharded.bucketed_megastep_measure_len(
        2, [(2, 5), (1, 7)], 3, bounds=True, int_sweep=True) == \
        tsharded.bucketed_megastep_measure_len(
            2, [(2, 5), (1, 7)], 3, bounds=True) + 4


def test_bucketed_integer_evaluation_matches_reference():
    """sizes S=3 in 2 bundles: two buckets (a single scenario and a bundle
    of two), every column integer; the candidate (the LP EF's first stage)
    leaves the second stage free, so each bucket dives, retries and solves
    its residue by host MILPs."""
    kw = {"scenario_count": 3, "relax_integers": False}
    opts = {"xhat_dive_rounds": 1, "xhat_dive_retries": 1,
            "xhat_mip_time_limit": 600.0, "xhat_mip_rel_gap": 1e-2,
            "bundles_per_rank": 2, "shape_buckets": True,
            "shape_bucket_quantum": 1}
    names = tsizes.scenario_names_creator(3)
    jev = JXhat(dict(opts), names, jsizes.scenario_creator,
                scenario_creator_kwargs=kw)
    ev = TXhat(dict(opts, device="cpu"), names, tsizes.scenario_creator,
               scenario_creator_kwargs=kw)
    assert isinstance(ev.batch, tir.BucketedBatch)
    assert all(np.asarray(sub.is_int).any() for _, sub in ev.batch.buckets)
    b, _ = build_batch(names, tsizes.scenario_creator,
                       {"scenario_count": 3, "relax_integers": False})
    lp, xlp = solve_ef(b, solver="highs", mip=False)
    cand = np.asarray(xlp[0])[b.tree.nonant_indices]
    saved = (ev.batch, ev._factors, ev._warm)
    z, jz = ev.evaluate(cand), jev.evaluate(cand)
    assert np.isfinite(z) and _rel(z, jz) <= 1e-6
    np.testing.assert_allclose(ev.pri_res, np.asarray(jev.pri_res),
                               atol=1e-9)
    assert z >= lp - 1.0
    # each bucket's solution is integral, scattered into the padded layout
    for idx, sub in ev.batch.buckets:
        x = np.asarray(ev.local_x)[idx, :sub.num_vars]
        ints = np.asarray(sub.is_int, bool)
        assert np.abs(x[:, ints] - np.round(x[:, ints])).max() < 1e-6
    # nothing keyed to a bucket outlives the evaluation
    assert (ev.batch, ev._factors, ev._warm) == saved
    assert ev._fixed_lb is None and ev._fixed_ub is None

"""The port's xhat machinery (tpusppy_torch) against the reference's (tpusppy).

Both packages on the same inputs, made from a seed with numpy, in float64 on
the CPU.  The candidate rules (``donor_cache``, ``slam_cache``,
``candidate_rule``, ``clamp_candidate``, ``xbar_candidate``) are host numpy
and agree exactly.  ``Xhat_Eval`` evaluations (one cold batched solve of
the clamped problem, HiGHS rescues where ADMM stalls) agree to 1e-7
relative, the level of the PH trajectories' parity, as do the in-hub
``XhatXbar`` and ``XhatLooper`` incumbents of a PH run.
"""

import numpy as np
import pytest
import torch

from tpusppy.cylinders import xhatxbar_bounder as jxb
from tpusppy.ef import solve_ef as jsolve_ef
from tpusppy.extensions import xhatbase as jxhb
from tpusppy.extensions.xhatlooper import XhatLooper as JLooper
from tpusppy.extensions.xhatxbar import XhatXbar as JXbar
from tpusppy.models import farmer as jfarmer
from tpusppy.models import hydro as jhydro
from tpusppy.opt.ph import PH as JPH
from tpusppy.xhat_eval import Xhat_Eval as JEval
from tpusppy_torch.cylinders import xhatxbar_bounder as txb
from tpusppy_torch.extensions import xhatbase as txhb
from tpusppy_torch.extensions.xhatlooper import XhatLooper as TLooper
from tpusppy_torch.extensions.xhatxbar import XhatXbar as TXbar
from tpusppy_torch.models import farmer as tfarmer
from tpusppy_torch.models import hydro as thydro
from tpusppy_torch.opt.ph import PH as TPH
from tpusppy_torch.xhat_eval import Xhat_Eval as TEval

torch.set_num_threads(1)

EVAL_TOL = 1e-7
OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 1,
        "solver_options": {"megastep": 1}}
HYDRO_KW = {"branching_factors": [3, 3]}


def _pair(cls_j, cls_t, family, n=3, **kw):
    """(reference object, port object) of the same family."""
    if family == "hydro":
        names = jhydro.scenario_names_creator(9)
        jc, tc, kw = jhydro.scenario_creator, thydro.scenario_creator, \
            dict(HYDRO_KW)
    else:
        names = jfarmer.scenario_names_creator(n)
        jc, tc = jfarmer.scenario_creator, tfarmer.scenario_creator
        kw = dict(kw, num_scens=n)
    j = cls_j(dict(OPTS), names, jc, scenario_creator_kwargs=kw)
    t = cls_t(dict(OPTS, device="cpu"), names, tc,
              scenario_creator_kwargs=kw)
    return j, t


def _xk(opt, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 300.0, (opt.batch.num_scenarios,
                                    opt.nonant_length))


# ---- candidate rules: exact -------------------------------------------------

@pytest.mark.parametrize("family", ["farmer", "hydro"])
@pytest.mark.parametrize("donors", ["int", "array", "dict"])
def test_donor_cache_matches_reference(family, donors):
    j, t = _pair(JEval, TEval, family)
    xk = _xk(t, 1)
    # an array: each node's last member scenario donates
    member = t.tree.membership_matrix()
    d = {"int": 2,
         "array": np.array([np.flatnonzero(row > 0)[-1] for row in member]),
         "dict": {t.tree.node_names[0]: 1}}[donors]
    got = txhb.donor_cache(t, xk, d)
    assert np.array_equal(got, jxhb.donor_cache(j, xk, d))
    if family == "hydro":
        # nonanticipative: stage-1 slots identical, stage-2 per node
        assert np.all(got[:, :4] == got[0, :4])
        for g in range(3):
            assert np.all(got[3 * g:3 * g + 3, 4:] == got[3 * g, 4:])


@pytest.mark.parametrize("family", ["farmer", "hydro"])
@pytest.mark.parametrize("how", ["max", "min"])
def test_slam_cache_matches_reference(family, how):
    j, t = _pair(JEval, TEval, family)
    xk = _xk(t, 3)
    assert np.array_equal(txhb.slam_cache(t, xk, how),
                          jxhb.slam_cache(j, xk, how))


@pytest.mark.parametrize("family,integer", [("farmer", False),
                                            ("farmer", True),
                                            ("hydro", False)])
@pytest.mark.parametrize("threshold", [0.5, 0.25])
def test_xbar_candidate_rules_match_reference(family, integer, threshold):
    kw = {"use_integer": True} if integer else {}
    j, t = _pair(JEval, TEval, family, **kw)
    xk = _xk(t, 4) * 2.0 - 100.0     # also outside the nonant box
    nid = t.tree.nonant_indices
    got = txb.xbar_candidate(t, xk, threshold)
    assert np.array_equal(got, jxb.xbar_candidate(j, xk, threshold))
    assert np.array_equal(txb.candidate_rule(t.batch, nid, xk, threshold),
                          jxb.candidate_rule(j.batch, nid, xk, threshold))
    for a, b in zip(txb.clamp_candidate(t.batch, nid, xk, threshold),
                    jxb.clamp_candidate(j.batch, nid, xk, threshold)):
        assert np.array_equal(a, b)
    if integer:
        assert np.all(got == np.round(got))


# ---- Xhat_Eval: 1e-7 --------------------------------------------------------

def _same(got, want, tol=EVAL_TOL):
    """Equal to ``tol`` relative (1e-6 absolute near zero), or both +inf
    (an infeasible candidate)."""
    if not np.isfinite(want):
        return got == want
    return got == pytest.approx(want, rel=tol, abs=1e-6)


def _ef_cache(j):
    """The reference EF's nonants: a nonanticipative (S, K) candidate."""
    _, xs = jsolve_ef(j.batch, solver="highs")
    return np.asarray(xs)[:, j.tree.nonant_indices]


@pytest.mark.parametrize("family,n,kw", [("farmer", 3, {}),
                                         ("farmer", 9, {"crops_multiplier":
                                                        2}),
                                         ("hydro", 9, {})])
def test_xhat_eval_matches_reference(family, n, kw):
    j, t = _pair(JEval, TEval, family, n=n, **kw)
    cache = _ef_cache(j)
    # another candidate: the EF's nonants scaled down (infeasible for
    # hydro, whose reservoir rows then break: +inf in both)
    worse = cache * 0.9
    for cand in (cache, worse):
        assert _same(t.evaluate(cand), j.evaluate(cand))
        np.testing.assert_allclose(t.objective_values(cand),
                                   j.objective_values(cand),
                                   rtol=EVAL_TOL, atol=1e-6)
        for s in (0, t.batch.num_scenarios - 1):
            assert _same(t.evaluate_one(cand, s), j.evaluate_one(cand, s))
        assert t._fixed_lb is None and t._fixed_ub is None
    ef, _ = jsolve_ef(j.batch, solver="highs")
    assert t.evaluate(cache) == pytest.approx(ef, rel=1e-6)
    assert t.evaluate(worse) >= ef - 1e-6 * abs(ef)
    assert np.isfinite(t.evaluate(worse)) == (family == "farmer")


def test_xhat_eval_with_a_model_repair_matches_reference():
    """A batch that carries a repair: the straggler rescue is off and the
    repaired point is verified against the rows exactly."""
    j, t = _pair(JEval, TEval, "farmer")
    for o in (j, t):
        o.batch.repair_fn = lambda x, b: np.maximum(x, b.lb)
    cache = _ef_cache(j)
    assert t.evaluate(cache) == pytest.approx(j.evaluate(cache),
                                              rel=EVAL_TOL)
    np.testing.assert_array_equal(t.pri_res, j.pri_res)
    assert t.options.get("straggler_rescue", True)


def test_fixing_reaches_the_solve_and_the_certified_bound():
    """The fixed bounds reach the solve's device bounds and the certified
    dual evaluation: with nonants fixed at the EF's first stage the
    certified bound is the fixed problem's, and it matches the
    reference's."""
    j, t = _pair(JEval, TEval, "farmer")
    cache = _ef_cache(j)
    for o in (j, t):
        o.fix_nonants(cache)
        o.solve_loop(warm=False)
    tb, jb = t.Edualbound(), j.Edualbound()
    assert tb == pytest.approx(jb, rel=EVAL_TOL)
    nid = t.tree.nonant_indices
    assert np.allclose(t.local_x[:, nid], cache, atol=1e-6)
    for o in (j, t):
        o.restore_nonants()
    assert t._fixed_lb is None


def lp_census(cls, model, S, dtype, cm=4):
    """Residuals of an f32 or f64 evaluation at the EF's first stage
    (farmer-``S``, ``cm``; eps 1e-5, no straggler rescue), with ``cls`` an
    ``Xhat_Eval`` and ``model`` the farmer module of one package: (pri,
    dua) per scenario."""
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 1,
            "straggler_rescue": False,
            "solver_options": {"dtype": dtype, "eps_abs": 1e-5,
                               "eps_rel": 1e-5, "megastep": 1}}
    if cls is TEval:
        opts["device"] = "cpu"
    ev = cls(opts, model.scenario_names_creator(S), model.scenario_creator,
             scenario_creator_kwargs={"num_scens": S, "crops_multiplier": cm})
    ev.evaluate(_ef_cache(ev))
    return np.asarray(ev.pri_res, float), np.asarray(ev.dua_res, float)


def test_lp_evaluation_residuals_park_as_the_reference_does():
    """The fixed-first-stage LP at farmer cm=4 in f32 parks above the 1e-3
    feasibility gate in most scenarios, in the reference as in the port,
    so it is f32 ADMM, not the port, that parks there: the census of the
    two packages agrees to 15% of S above 1e-4 and 1e-3, and their
    largest residuals within 30%.  In f64 the primal residuals agree to
    1e-6 (1e-9 absolute) and stay below the gate."""
    S = 40
    tp, _ = lp_census(TEval, tfarmer, S, "float32")
    jp, _ = lp_census(JEval, jfarmer, S, "float32")
    for cut in (1e-4, 1e-3):
        assert abs(int((tp > cut).sum()) - int((jp > cut).sum())) \
            <= 0.15 * S, (cut, tp, jp)
    assert (tp > 1e-3).sum() > S // 2 and (jp > 1e-3).sum() > S // 2
    assert tp.max() == pytest.approx(jp.max(), rel=0.3)
    tp, _ = lp_census(TEval, tfarmer, S, "float64")
    jp, _ = lp_census(JEval, jfarmer, S, "float64")
    np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-9)
    assert tp.max() < 1e-3


# ---- in-hub xhat extensions on PH: 1e-7 -------------------------------------

@pytest.mark.parametrize("ext,iters,extra", [
    ("xbar", 30, {}),
    ("looper", 8, {"xhat_looper_options": {"scen_limit": 3}})])
def test_inhub_xhat_matches_reference(ext, iters, extra):
    opts = {"defaultPHrho": 1.0, "PHIterLimit": iters, "convthresh": 1e-6,
            "solver_options": {"megastep": 1}, **extra}
    jext, text = (JXbar, TXbar) if ext == "xbar" else (JLooper, TLooper)
    names = jfarmer.scenario_names_creator(3)
    jph = JPH(dict(opts), names, jfarmer.scenario_creator,
              scenario_creator_kwargs={"num_scens": 3}, extensions=jext)
    tph = TPH(dict(opts, device="cpu"), names, tfarmer.scenario_creator,
              scenario_creator_kwargs={"num_scens": 3}, extensions=text)
    jph.ph_main()
    tph.ph_main()
    assert np.isfinite(tph.best_inner_bound)
    assert tph.best_inner_bound == pytest.approx(jph.best_inner_bound,
                                                 rel=EVAL_TOL)
    np.testing.assert_allclose(tph.best_xhat_cache, jph.best_xhat_cache,
                               rtol=1e-6, atol=1e-6)
    assert tph.best_inner_bound >= -108390.0 - 1.0

"""The port's host MILP tier against the reference's, float64 on the CPU.

``tpusppy_torch.solvers.milp_bound`` (the MILP lift and the integer dual
ascent) on uc_lite (3 generators x 6 hours, S=5, integer commitments, the
setup of ``tests/test_milp_bound.py``): the lift tightens the LP
certificates and stays below the HiGHS EF MIP, a zero budget lifts
nothing, every ascent iterate certifies and the best is kept, and both
agree with ``tpusppy.solvers.milp_bound`` on the same inputs (HiGHS solves
the same problems); a time-limited best bound below the LP certificate is
never installed.  The Lagrangian spoke's ``lagrangian_milp_lift`` (with
``every``) and ``lagrangian_milp_ascent`` give the reference spoke's
bounds, and XhatShuffle's donor MILPs (uc_lite S=4) the reference's
candidates and values.  Then the host half of
``tpusppy_torch.solvers.integer`` on netdes S=3 from the reference's
carried state (``tests/test_torch_integer.py``):
the escalation budget under a fake clock, the gap-ranked order, the outer
and inner escalations and the restricted-EF incumbent, and the host
rescue's ladder, each against the reference's.
"""

import numpy as np
import pytest
import torch

from test_torch_integer import N, MIP_EF, NETDES_KW, _carried, _rel
from tpusppy.cylinders.lagrangian_bounder import \
    LagrangianOuterBound as JLagrangian
from tpusppy.ir import ScenarioBatch as JBatch
from tpusppy.models import netdes as jnetdes
from tpusppy.models import uc_lite as juc_lite
from tpusppy.phbase import PHBase as JPHBase
from tpusppy.solvers import integer as JI
from tpusppy.solvers import milp_bound as jmb
from tpusppy_torch.cylinders.lagrangian_bounder import LagrangianOuterBound
from tpusppy_torch.ef import solve_ef
from tpusppy_torch.models import netdes as tnetdes
from tpusppy_torch.models import uc_lite as tuc_lite
from tpusppy_torch.obs import metrics
from tpusppy_torch.phbase import PHBase
from tpusppy_torch.solvers import integer as TI
from tpusppy_torch.solvers import milp_bound, scipy_backend
from tpusppy_torch.spbase import build_batch

torch.set_num_threads(1)

S_UC = 5
UC_KW = {"num_gens": 3, "horizon": 6, "num_scens": S_UC,
         "relax_integers": False}
SO = {"eps_abs": 1e-8, "eps_rel": 1e-8, "max_iter": 400, "restarts": 3}


@pytest.fixture(scope="module")
def uc_batch():
    names = tuc_lite.scenario_names_creator(S_UC)
    batch, _ = build_batch(names, tuc_lite.scenario_creator, UC_KW)
    return names, batch


@pytest.fixture(scope="module")
def ef_mip(uc_batch):
    return solve_ef(uc_batch[1], solver="highs", mip=True)[0]


def _phbases(W):
    """(reference, port) PHBase on uc_lite in the Lagrangian mode (W on,
    prox off) at the weights ``W``."""
    names = tuc_lite.scenario_names_creator(S_UC)
    opts = {"defaultPHrho": 10.0, "PHIterLimit": 1, "solver_options": SO}
    jb = JPHBase(opts, names, juc_lite.scenario_creator,
                 scenario_creator_kwargs=UC_KW)
    tb = PHBase(dict(opts, device="cpu"), names, tuc_lite.scenario_creator,
                scenario_creator_kwargs=UC_KW)
    for ph in (jb, tb):
        ph.W_on, ph.prox_on = True, False
        ph.W = np.array(W, dtype=float)
    return jb, tb


def _zero_mean_W(ph, seed=0):
    W = np.random.RandomState(seed).randn(S_UC, ph.nonant_length) * 20.0
    return W - (ph.probs @ W)[None, :]


def _base_fn(ph):
    def base_fn(W):
        ph.W = np.asarray(W, dtype=float)
        q, q2 = ph._augmented_q()
        ph.solve_loop(q=q, q2=q2)
        return q, ph.Edualbound_perscen(q=q, q2=q2)
    return base_fn


def test_milp_lift_tightens_validly_and_matches_reference(uc_batch, ef_mip):
    names, batch = uc_batch
    jb, tb = _phbases(np.zeros((S_UC, 18)))
    q, base = _base_fn(tb)(tb.W)
    lifted, n, X = milp_bound.milp_lift(batch, q, base, budget_s=120,
                                        want_x=True)
    jbatch = JBatch.from_problems([juc_lite.scenario_creator(nm, **UC_KW)
                                   for nm in names])
    jlifted, jn, jX = jmb.milp_lift(jbatch, q, base, budget_s=120,
                                    want_x=True)
    assert n == jn == S_UC
    np.testing.assert_allclose(lifted, jlifted, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(X, jX, atol=1e-6)
    lp = float(tb.probs @ base)
    mip = float(tb.probs @ lifted)
    assert lp - 1e-9 <= mip <= ef_mip + 1e-6 * abs(ef_mip)
    # W = 0: the integer wait-and-see bound, strictly above the LP one
    assert mip > lp + 1e-6 * abs(lp)
    ints = np.asarray(batch.is_int, bool)
    np.testing.assert_allclose(X[:, ints], np.round(X[:, ints]), atol=1e-6)
    # a zero budget lifts nothing, and the certificates stay
    lifted0, n0 = milp_bound.milp_lift(batch, q, base, budget_s=0.0)
    assert n0 == 0 and np.array_equal(lifted0, base)


def test_milp_dual_ascent_keeps_the_best_valid_iterate(uc_batch, ef_mip):
    names, batch = uc_batch
    jb, tb = _phbases(np.zeros((S_UC, 18)))
    W0 = _zero_mean_W(tb)
    fn = _base_fn(tb)
    q0, base0 = fn(W0)
    start = float(tb.probs @ milp_bound.milp_lift(batch, q0, base0,
                                                  budget_s=60)[0])
    best, bestW = milp_bound.milp_dual_ascent(batch, W0, fn, steps=3,
                                              budget_s=120)
    jbest, jW = jmb.milp_dual_ascent(jb.batch, W0, _base_fn(jb), steps=3,
                                     budget_s=120)
    assert _rel(best, jbest) <= 1e-7
    np.testing.assert_allclose(bestW, jW, atol=1e-6)
    assert start - 1e-9 <= best <= ef_mip + 1e-6 * abs(ef_mip)
    assert np.abs(tb.probs @ bestW).max() < 1e-8


def test_worsening_best_bound_never_installed(monkeypatch):
    """A time-limited HiGHS best bound BELOW a scenario's LP certificate
    never replaces it, and no minimizer is claimed from it."""
    names = tnetdes.scenario_names_creator(N)
    batch, _ = build_batch(names, tnetdes.scenario_creator, NETDES_KW)
    base = np.array([50.0, 60.0, 70.0])

    def fake_solve(c, A, cl, cu, lb, ub, is_int=None, q2=None, const=0.0,
                   mip_rel_gap=None, time_limit=None):
        return scipy_backend.SolveResult(
            x=np.zeros(c.shape[0]), obj=1e9, duals=None, status="1",
            feasible=True, dual_bound=-1e6)

    monkeypatch.setattr(milp_bound.scipy_backend, "solve_lp", fake_solve)
    lifted, n, X = milp_bound.milp_lift(batch, np.asarray(batch.c), base,
                                        budget_s=5.0, time_limit=0.01,
                                        want_x=True)
    np.testing.assert_array_equal(lifted, base)
    assert n == N and np.isnan(X).all()


def _xhat_pair(kw, options, S):
    from tpusppy.xhat_eval import Xhat_Eval as JXhat
    from tpusppy_torch.xhat_eval import Xhat_Eval

    names = tuc_lite.scenario_names_creator(S)
    return (JXhat(dict(options), names, juc_lite.scenario_creator,
                  scenario_creator_kwargs=kw),
            Xhat_Eval(dict(options, device="cpu"), names,
                      tuc_lite.scenario_creator, scenario_creator_kwargs=kw))


def _spoke(cls, opt, W, hub_bounds=(-np.inf, np.inf)):
    """A Lagrangian spoke on ``opt`` outside a wheel: the hub's payload is
    ``W`` and its bounds, posting goes nowhere."""
    sp = cls.__new__(cls)
    sp.opt = opt
    sp._locals = np.concatenate([np.ravel(W), hub_bounds])
    sp._bound, sp.bounds_posted, sp.trace_filen = 0.0, 0, None
    sp.spoke_to_hub = lambda values: None
    sp.lagrangian_prep()
    return sp


@pytest.mark.parametrize("dk_iter", [1, 2], ids=["skipped", "lifted"])
def test_lagrangian_milp_lift_every(dk_iter):
    """``lagrangian_milp_lift`` with ``every`` 2: no lift on the first
    pass, the lifted bound on the second, as the reference spoke's."""
    jb, tb = _phbases(np.zeros((S_UC, 18)))
    W = _zero_mean_W(tb, seed=1)
    lift = {"budget_s": 60, "every": 2}
    out = []
    for cls, ph in ((LagrangianOuterBound, tb), (JLagrangian, jb)):
        ph.options["lagrangian_milp_lift"] = lift
        sp = _spoke(cls, ph, W)
        sp.dk_iter = dk_iter
        out.append((sp._set_weights_and_solve(), sp))
    (bound, sp), (jbound, jsp) = out
    assert _rel(bound, jbound) <= 1e-7
    q, q2 = tb._augmented_q()
    lp = tb.Edualbound(q=q, q2=q2)
    if dk_iter == 1:
        assert bound == lp and not hasattr(sp, "last_milp_lift_count")
    else:
        assert sp.last_milp_lift_count == jsp.last_milp_lift_count == S_UC
        assert bound > lp and sp.milp_secs > 0.0


def test_lagrangian_milp_ascent_polishes_the_final_bound(ef_mip):
    jb, tb = _phbases(np.zeros((S_UC, 18)))
    W = _zero_mean_W(tb, seed=2)
    cfg = {"steps": 2, "budget_s": 120}
    out = []
    for cls, ph in ((LagrangianOuterBound, tb), (JLagrangian, jb)):
        ph.options["lagrangian_milp_ascent"] = cfg
        sp = _spoke(cls, ph, W)
        out.append((sp.finalize(), sp))
    (final, sp), (jfinal, _) = out
    assert _rel(final, jfinal) <= 1e-7
    q, q2 = tb._augmented_q()
    assert final >= tb.Edualbound(q=q, q2=q2) - 1e-9
    assert final <= ef_mip + 1e-6 * abs(ef_mip)
    assert sp.bound == final and sp.milp_secs > 0.0
    # a hub gap already at the target skips the ascent
    tb.options["lagrangian_milp_ascent"] = dict(cfg, skip_if_gap_at=0.5)
    sp = _spoke(LagrangianOuterBound, tb, W, hub_bounds=(100.0, 101.0))
    skipped = sp.finalize()
    q, q2 = tb._augmented_q()
    assert skipped == pytest.approx(tb.Edualbound(q=q, q2=q2), rel=1e-12)


def test_donor_milp_candidates_match_reference():
    from tpusppy.cylinders.xhatshufflelooper_bounder import \
        XhatShuffleInnerBound as JShuffle
    from tpusppy_torch.cylinders.xhatshufflelooper_bounder import \
        XhatShuffleInnerBound

    S = 4
    kw = tuc_lite.kw_creator(num_scens=S)
    opts = {"xhat_looper_options": {"donor_milp": True, "scen_limit": 3}}
    jev, ev = _xhat_pair(kw, opts, S)
    spokes = []
    for cls, opt in ((XhatShuffleInnerBound, ev), (JShuffle, jev)):
        sp = cls.__new__(cls)
        sp.opt = opt
        sp.xhatbase_prep()
        assert sp.donor_milp
        spokes.append(sp)
    sp, jsp = spokes
    ef = solve_ef(ev.batch, solver="highs", mip=False)[0]
    ints = np.asarray(ev.batch.is_int, bool)[ev.tree.nonant_indices]
    seen = []
    for donor in range(2):
        cand = sp._donor_milp_candidate(donor)
        jcand = jsp._donor_milp_candidate(donor)
        np.testing.assert_allclose(cand, jcand, atol=1e-9)
        np.testing.assert_array_equal(cand[ints], np.round(cand[ints]))
        obj, jobj = ev.evaluate(cand), jev.evaluate(jcand)
        assert _rel(obj, jobj) <= 1e-6
        seen.append(obj)
    assert np.isfinite(seen).any() and min(seen) >= ef - 1e-6
    assert sp._donor_milp_candidate(0) is sp._milp_donor_cache[0]
    assert sp.milp_secs > 0.0


@pytest.fixture(scope="module")
def netdes_pair():
    return _carried(jnetdes, tnetdes, NETDES_KW)


class _Clock:
    def __init__(self, times):
        self.it, self.last = iter(times), 0.0

    def __call__(self):
        v = next(self.it, None)
        if v is not None:
            self.last = v
        return self.last


def test_escalation_budget_under_a_fake_clock():
    b = TI.EscalationBudget(10.0, clock=_Clock([0.0, 3.0, 3.0, 10.0]))
    assert b.take(4.0) == 4.0
    with metrics.window() as w:
        with b.timed():
            pass                      # 0 -> 3
        assert b.spent_s == pytest.approx(3.0)
        assert b.take(None) == pytest.approx(7.0)
        with b.timed():
            pass                      # 3 -> 10
    assert w.delta("integer.escalation_secs") == pytest.approx(10.0)
    assert b.remaining == 0.0 and b.take(5.0) == 0.0


def test_gap_ranked_order_matches_reference():
    rng = np.random.RandomState(0)
    probs = rng.rand(12)
    lp = rng.randn(12)
    up = lp + rng.rand(12) - 0.2
    up[[2, 7]] = np.inf
    np.testing.assert_array_equal(TI.gap_ranked_order(probs, lp, up),
                                  JI.gap_ranked_order(probs, lp, up))
    assert list(TI.gap_ranked_order([0.2, 0.5, 0.3], [10.0] * 3,
                                    [12.0, 11.0, np.inf])) == [1, 0, 2]


def test_escalations_match_reference(netdes_pair):
    """The outer escalation (the MILP lift) and the inner one (host MIPs
    at a candidate) on the same state, budgets that never bind: HiGHS
    solves the same problems, so the bounds agree."""
    jph, tph = netdes_pair
    cand = TI.host_candidates(tph)[0]
    u, ok = TI.candidate_upper_perscen(tph, cand)
    ju, jok = JI.candidate_upper_perscen(jph, cand)
    assert _rel(u, ju) <= 1e-7
    np.testing.assert_array_equal(ok, jok)
    with metrics.window() as w:
        ob, X = TI.escalate_outer(tph, TI.EscalationBudget(600.0),
                                  upper_perscen=np.where(ok, u, np.inf),
                                  want_x=True)
    job, jX = JI.escalate_outer(jph, JI.EscalationBudget(600.0),
                                upper_perscen=np.where(jok, ju, np.inf),
                                want_x=True)
    assert w.delta("integer.escalations") == 1
    assert w.delta("integer.escalation_lifts") == N
    assert _rel(ob, job) <= 1e-7
    qL = TI._waug_q(tph)
    base = float(tph.probs @ tph.Edualbound_perscen(q=qL,
                                                    q2=tph.batch.q2))
    assert ob >= base - 1e-9
    assert not np.isnan(X).any()
    np.testing.assert_allclose(X, jX, atol=1e-6)
    certified = []
    for c in TI.host_candidates(tph):
        ib = TI.escalate_inner(tph, TI.EscalationBudget(600.0), c)
        jib = JI.escalate_inner(jph, JI.EscalationBudget(600.0), c)
        assert (ib is None) == (jib is None)
        if ib is not None:
            assert _rel(ib, jib) <= 1e-9 and ib >= MIP_EF - 1e-3
            certified.append(ib)
    assert certified
    ef = TI.restricted_ef_incumbent(tph, X, TI.EscalationBudget(600.0))
    jef = JI.restricted_ef_incumbent(jph, jX, JI.EscalationBudget(600.0))
    assert _rel(ef, jef) <= 1e-9 and ef >= MIP_EF - 1e-3
    # an exhausted budget escalates nothing
    assert TI.escalate_outer(tph, TI.EscalationBudget(0.0)) is None
    assert TI.escalate_inner(tph, TI.EscalationBudget(0.0), cand) is None


def test_escalate_outer_hands_the_lift_the_ranked_order(netdes_pair,
                                                        monkeypatch):
    from tpusppy_torch.solvers import milp_bound

    _, tph = netdes_pair
    grants = []

    def fake_lift(batch, q, base, budget_s=None, order=None,
                  time_limit=None, mip_rel_gap=None, want_x=False):
        grants.append((budget_s, None if order is None else list(order)))
        out = (np.asarray(base, float), 0)
        return out + (None,) if want_x else out

    monkeypatch.setattr(milp_bound, "milp_lift", fake_lift)
    upper = np.array([100.0, 50.0, 400.0])
    base = np.asarray(tph.Edualbound_perscen(q=TI._waug_q(tph),
                                             q2=tph.batch.q2))
    budget = TI.EscalationBudget(10.0, clock=_Clock([0.0, 2.0, 2.0, 3.0]))
    TI.escalate_outer(tph, budget, upper_perscen=upper)
    TI.escalate_outer(tph, budget)
    assert grants[0] == (pytest.approx(10.0),
                         list(TI.gap_ranked_order(tph.probs, base, upper)))
    assert grants[1] == (pytest.approx(8.0), None)   # 10 - 2 spent
    assert budget.spent_s == pytest.approx(3.0)


def test_host_rescue_sweeps_the_ladder(netdes_pair):
    """The host rescue under the integer sweep certifies the first feasible
    ladder candidate exactly and counts it; the reference picks the same
    one."""
    jph, tph = netdes_pair
    with metrics.window() as w:
        ib = tph._inwheel_host_rescue()
    jib = jph._inwheel_host_rescue()
    assert ib is not None and _rel(ib, jib) <= 1e-9
    assert w.delta("integer.feasible_hits") == 1
    vals = [tph._inwheel_eval_candidate_host(c)
            for c in TI.host_candidates(tph)]
    assert any(v is not None and abs(ib - v) <= 1e-9 * abs(v) for v in vals)



"""Integer incumbents and the integer wheels: the port against the
reference, float64 on the CPU.

``Xhat_Eval``'s integer evaluation (``tpusppy_torch/xhat_eval.py``: the
round-and-dive over cold batched solves, the batched randomized-rounding
retries, the host MILPs) gives the reference's values on integer farmer
S=3 and on sizes S=3 (second-stage integers; the dive cut to 2 rounds and
2 retries, each cold solve at n=150 costing seconds on a CPU), and the
retries unwedge a cardinality row without the host MILP as the
reference's do.  XhatXbar's default integer ladder (netdes) evaluates the
reference's candidates to the reference's values.  XhatShuffle's donor
MILPs are held in ``tests/test_torch_milp_bound.py``, the integer wheels
in ``tests/test_torch_integer_wheel.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_integer import N, NETDES_KW, _rel
from tpusppy.models import farmer as jfarmer
from tpusppy.models import netdes as jnetdes
from tpusppy.models import sizes as jsizes
from tpusppy.xhat_eval import Xhat_Eval as JXhat
from tpusppy_torch.ef import solve_ef
from tpusppy_torch.ir import LinearModelBuilder
from tpusppy_torch.models import farmer as tfarmer
from tpusppy_torch.models import netdes as tnetdes
from tpusppy_torch.models import sizes as tsizes
from tpusppy_torch.scenario_tree import ScenarioNode, extract_num
from tpusppy_torch.solvers import integer as TI
from tpusppy_torch.xhat_eval import Xhat_Eval

torch.set_num_threads(1)

SIZES_KW = {"scenario_count": N, "relax_integers": False}


def _pair(jmod, tmod, kw, options, S=N):
    names = tmod.scenario_names_creator(S)
    return (JXhat(dict(options), names, jmod.scenario_creator,
                  scenario_creator_kwargs=kw),
            Xhat_Eval(dict(options, device="cpu"), names,
                      tmod.scenario_creator, scenario_creator_kwargs=kw))


def _integral(ev):
    ints = np.asarray(ev.batch.is_int, bool)
    x = np.asarray(ev.local_x)
    return float(np.abs(x[:, ints] - np.round(x[:, ints])).max())


def test_integer_farmer_evaluation_matches_reference():
    kw = {"num_scens": N, "use_integer": True}
    jev, ev = _pair(jfarmer, tfarmer, kw, {})
    mip = solve_ef(ev.batch, solver="highs", mip=True)[0]
    cand = np.array([170.0, 80.0, 250.0])
    z, jz = ev.evaluate(cand), jev.evaluate(cand)
    assert _rel(z, jz) <= 1e-6
    assert _integral(ev) < 1e-5
    assert z >= mip - 1.0 and z == pytest.approx(mip, rel=2e-2)


def test_sizes_dive_matches_reference():
    """sizes' second stage is integer: the candidate (the LP EF's first
    stage, its integer slots rounded) leaves them free, so the evaluation
    dives, retries the wedged scenarios, and solves the rest by host
    MILPs, in both packages alike (HiGHS at a time limit that never binds:
    a binding one makes the host MILPs' incumbents depend on the host's
    speed)."""
    opts = {"xhat_dive_rounds": 1, "xhat_dive_retries": 1,
            "xhat_mip_time_limit": 600.0, "xhat_mip_rel_gap": 1e-2}
    jev, ev = _pair(jsizes, tsizes, SIZES_KW, opts)
    lp, xlp = solve_ef(ev.batch, solver="highs", mip=False)
    cand = np.asarray(xlp[0])[ev.batch.tree.nonant_indices]
    z, jz = ev.evaluate(cand), jev.evaluate(cand)
    assert np.isfinite(z) and _rel(z, jz) <= 1e-6
    assert _integral(ev) < 1e-6
    assert z >= lp - 1.0
    np.testing.assert_allclose(ev.pri_res, np.asarray(jev.pri_res),
                               atol=1e-9)


def _cardinality(name, num_scens=2):
    """Two scenarios that pick exactly two of four binaries: a round-up
    dive wedges on the cardinality row."""
    snum = extract_num(name)
    b = LinearModelBuilder(name)
    x0 = b.add_var("x0", lb=0.0, ub=10.0, cost=1.0)
    ys = [b.add_var(f"y{j}", lb=0.0, ub=1.0, integer=True,
                    cost=float(j + 1 + snum)) for j in range(4)]
    b.add_eq({y: 1.0 for y in ys}, 2.0)
    b.add_ge({x0: 1.0, ys[0]: 1.0}, 1.0)
    mdl = b.build()
    mdl.prob = 1.0 / num_scens
    mdl.nodes = [ScenarioNode("ROOT", 1.0, 1, np.array([x0], dtype=np.int32))]
    return mdl


def test_retry_dive_unwedges_cardinality_as_reference():
    from tpusppy.ir import LinearModelBuilder as JBuilder
    from tpusppy.scenario_tree import ScenarioNode as JNode

    def jcreator(name, num_scens=2):
        snum = extract_num(name)
        b = JBuilder(name)
        x0 = b.add_var("x0", lb=0.0, ub=10.0, cost=1.0)
        ys = [b.add_var(f"y{j}", lb=0.0, ub=1.0, integer=True,
                        cost=float(j + 1 + snum)) for j in range(4)]
        b.add_eq({y: 1.0 for y in ys}, 2.0)
        b.add_ge({x0: 1.0, ys[0]: 1.0}, 1.0)
        mdl = b.build()
        mdl.prob = 1.0 / num_scens
        mdl.nodes = [JNode("ROOT", 1.0, 1, np.array([x0], dtype=np.int32))]
        return mdl

    names = ["Scenario0", "Scenario1"]
    opts = {"xhat_dive_rounds": 6, "xhat_dive_retries": 16}
    ev = Xhat_Eval(dict(opts, device="cpu"), names, _cardinality,
                   scenario_creator_kwargs={"num_scens": 2})
    jev = JXhat(opts, names, jcreator, scenario_creator_kwargs={
        "num_scens": 2})

    def no_milp(*a, **k):
        raise AssertionError("the host MILP should not be needed")

    ev._host_milp = jev._host_milp = no_milp
    z, jz = ev.evaluate(np.array([1.0])), jev.evaluate(np.array([1.0]))
    assert np.isfinite(z) and _rel(z, jz) <= 1e-6
    ys = np.asarray(ev.local_x)[:, 1:5]
    assert np.abs(ys - np.round(ys)).max() < 1e-5
    np.testing.assert_allclose(ys.sum(axis=1), 2.0, atol=1e-5)
    # the retries alone, on both scenarios, from the clamped box
    lb = np.array(ev.batch.lb, copy=True)
    ub = np.array(ev.batch.ub, copy=True)
    lb[:, 0] = ub[:, 0] = 1.0
    bad = np.arange(2)
    xs, feas = ev._retry_dive(lb, ub, bad)
    jxs, jfeas = jev._retry_dive(lb, ub, bad)
    np.testing.assert_array_equal(feas, jfeas)
    np.testing.assert_allclose(xs, np.asarray(jxs), atol=1e-6)


def test_xhatxbar_default_integer_ladder_matches_reference():
    from tpusppy.cylinders.xhatxbar_bounder import \
        XhatXbarInnerBound as JXbar
    from tpusppy_torch.cylinders.xhatxbar_bounder import XhatXbarInnerBound

    jev, ev = _pair(jnetdes, tnetdes, NETDES_KW, {})
    fev = Xhat_Eval({"device": "cpu"}, tfarmer.scenario_names_creator(3),
                    tfarmer.scenario_creator,
                    scenario_creator_kwargs={"num_scens": 3})
    xk = np.random.RandomState(0).rand(N, ev.nonant_length)
    posted = {}
    for cls, opt, key in ((XhatXbarInnerBound, ev, "port"),
                          (JXbar, jev, "ref"),
                          (XhatXbarInnerBound, fev, "farmer")):
        sp = cls.__new__(cls)
        sp.opt = opt
        sp.got_kill_signal = lambda: True
        sp.main()
        vals = posted[key] = []
        sp.update_if_improving = vals.append
        if key != "farmer":
            sp._sweep(xk, final=True)
        posted[key + "_th"] = sp._thresholds
    assert posted["port_th"] == posted["ref_th"] == list(
        TI.DEFAULT_THRESHOLDS)
    assert posted["farmer_th"] == [0.5]
    assert len(posted["port"]) == 3
    for v, jv in zip(posted["port"], posted["ref"]):
        assert (np.isinf(v) and np.isinf(jv)) or _rel(v, jv) <= 1e-6

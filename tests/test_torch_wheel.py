"""The port's wheel (tpusppy_torch) against the reference's (tpusppy).

Both packages on the same inputs in float64 on the CPU, each check at the
tolerance it states: the mailbox protocol, the gap arithmetic and the
termination verdicts, and the scenario cycler exactly; the Lagrangian
spoke's bound at a W carried over from a reference PH run to 1e-7 (the PH
trajectories' parity); donor-dual bounds to 1e-9 (both packages call the
same HiGHS, and evaluate the donors' duals in f64).  Whole wheels run on the
port alone: thread timing makes them differ from run to run, so they hold
the reference's properties (``tests/test_wheel.py``), not trajectories.
Then the batch cache, the owners of captured sweep loops, and each option
that is not ported yet, which raises and names its ROADMAP item.
"""

import numpy as np
import pytest
import torch

from tpusppy.cylinders import hub as jhub
from tpusppy.cylinders import spcommunicator as jspc
from tpusppy.cylinders.lagrangian_bounder import \
    LagrangianOuterBound as JLagrangian
from tpusppy.cylinders.xhatshufflelooper_bounder import \
    ScenarioCycler as JCycler
from tpusppy.models import farmer as jfarmer
from tpusppy.models import uc as juc
from tpusppy.opt.ph import PH as JPH
from tpusppy.phbase import PHBase as JPHBase
from tpusppy_torch.cylinders import (
    KILL_ID,
    LagrangianOuterBound,
    Mailbox,
    PHHub,
    ScenarioCycler,
    WindowFabric,
    XhatShuffleInnerBound,
    XhatXbarInnerBound,
)
from tpusppy_torch.cylinders import hub as thub
from tpusppy_torch.models import farmer, hydro
from tpusppy_torch.models import uc as tuc
from tpusppy_torch.opt.ph import PH
from tpusppy_torch.phbase import PHBase
from tpusppy_torch.solvers import cuda_kernels, device_loop
from tpusppy_torch.spbase import SPBase, clear_batch_cache
from tpusppy_torch.spin_the_wheel import (MultiprocessWheelSpinner,
                                          WheelSpinner, spin_the_wheel)
from tpusppy_torch.xhat_eval import Xhat_Eval

torch.set_num_threads(1)

EF3 = -108390.0
# farmer S=3's trivial (wait-and-see) bound (tests/test_wheel.py)
TRIVIAL3 = -115405.6


# ---- mailbox ----------------------------------------------------------------

def _mailbox_trace(box_cls, kill_id):
    mb = box_cls(3)
    out = [mb.get()[1], mb.put(np.array([1.0, 2.0, 3.0]))]
    data, wid = mb.get()
    out += [wid, list(data), mb.put(np.array([4.0, 5.0, 6.0]))]
    out.append(mb.put_versioned("a", np.array([7.0, 8.0, 9.0])))
    out.append(mb.put_versioned("a", lambda: 1 / 0))   # skipped: not built
    out.append(mb.put_versioned("b", lambda: np.zeros(3)))
    mb.kill()
    out.append(mb.get()[1] == kill_id)
    # the kill sentinel is terminal: a late put must not resurrect the box
    out += [mb.put(np.array([7.0, 8.0, 9.0])), mb.get()[1], list(mb.get()[0])]
    return out


def test_mailbox_write_id_protocol_matches_reference():
    got = _mailbox_trace(Mailbox, KILL_ID)
    assert got == _mailbox_trace(jspc.Mailbox, jspc.KILL_ID)
    assert got[:2] == [0, 1] and got[-3:] == [KILL_ID, KILL_ID, [0, 0, 0]]


@pytest.mark.parametrize("box_cls", [Mailbox, jspc.Mailbox])
def test_mailbox_length_check(box_cls):
    mb = box_cls(2)
    with pytest.raises(RuntimeError):
        mb.put(np.zeros(3))


# ---- gaps and termination ---------------------------------------------------

class _Opt:
    is_minimizing = True
    _iter = 0


def _bare_hub(cls, options):
    h = cls.__new__(cls)
    h.options = dict(options)
    h.opt = _Opt()
    h.last_gap = np.inf
    h.stalled_iter_cnt = 0
    h.stop_reason = None
    return h


#: (inner, outer) pairs fed in order; a zero outer bound among them (the
#: reference takes the absolute gap as the relative one there)
BOUND_SEQ = [(np.inf, -np.inf), (10.0, -np.inf), (10.0, 0.0), (5e-6, 0.0),
             (1.0, 0.0), (-108000.0, -108500.0), (-108390.0, -108400.0),
             (-108390.0, -108400.0), (-108390.0, -108395.0), (3.0, -2.0),
             (-108390.0, -108391.0), (1.0, 1.0)]


@pytest.mark.parametrize("options", [
    {"rel_gap": 1e-4}, {"abs_gap": 1.0}, {"rel_gap": 1e-3, "abs_gap": 1.0},
    {"max_stalled_iters": 2}, {"rel_gap": 1e-9, "max_stalled_iters": 3},
    {}])
def test_gaps_and_termination_match_reference(options):
    t, j = _bare_hub(thub.Hub, options), _bare_hub(jhub.Hub, options)
    for inner, outer in BOUND_SEQ:
        for h in (t, j):
            h.BestInnerBound, h.BestOuterBound = inner, outer
        assert t.compute_gaps() == j.compute_gaps()
        assert t.determine_termination() == j.determine_termination()
        assert t.stalled_iter_cnt == j.stalled_iter_cnt


def test_zero_outer_bound_terminates_on_rel_gap():
    h = _bare_hub(thub.Hub, {"rel_gap": 1e-4})
    h.BestInnerBound, h.BestOuterBound = 5e-6, 0.0
    abs_gap, rel_gap = h.compute_gaps()
    assert abs_gap == 5e-6 and rel_gap == 5e-6
    assert h.determine_termination()
    h.BestInnerBound = 1.0
    assert not h.determine_termination()


# ---- scenario cycler --------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 17, 12345])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("S", [1, 3, 10])
def test_scenario_cycler_matches_reference(seed, reverse, S):
    t, j = ScenarioCycler(S, seed, reverse), JCycler(S, seed, reverse)
    assert [t.get_next() for _ in range(4 * S + 3)] == \
        [j.get_next() for _ in range(4 * S + 3)]


# ---- the Lagrangian bound ---------------------------------------------------

def test_lagrangian_bound_at_carried_w_matches_reference():
    n = 3
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 8, "convthresh": -1.0,
            "solver_options": {"megastep": 1}}
    jph = JPH(dict(opts), jfarmer.scenario_names_creator(n),
              jfarmer.scenario_creator, scenario_creator_kwargs={
                  "num_scens": n})
    jph.ph_main()
    W = np.array(jph.W)
    assert np.abs(W).max() > 1.0      # a W that moves the bound
    bounds = []
    for lag_cls, ph_cls, creator, fabric, extra in (
            (JLagrangian, JPHBase, jfarmer.scenario_creator,
             jspc.WindowFabric(), {}),
            (LagrangianOuterBound, PHBase, farmer.scenario_creator,
             WindowFabric(), {"device": "cpu"})):
        opt = ph_cls(dict(opts, **extra), farmer.scenario_names_creator(n),
                     creator, scenario_creator_kwargs={"num_scens": n})
        spoke = lag_cls(opt, 1, fabric)
        spoke.lagrangian_prep()
        opt.W = np.zeros_like(W)
        trivial = spoke.lagrangian()
        opt.W = W.copy()
        bounds.append((trivial, spoke.lagrangian()))
    (jt, jb), (tt, tb) = bounds
    assert tt == pytest.approx(jt, rel=1e-7)
    assert tb == pytest.approx(jb, rel=1e-7)
    assert tt <= tb <= EF3 + 1e-6 * abs(EF3)


# ---- donor-dual bounds ------------------------------------------------------

def _donor_seq(opt, q_seq):
    return [opt.dual_donor_bounds(q=q, k=2, budget_s=120.0, time_limit=30.0,
                                  refresh_every=2) for q in q_seq]


@pytest.mark.parametrize("family", ["farmer", "uc"])
def test_donor_bounds_match_reference(family):
    """Three calls at two objectives with refresh_every=2: the first solves
    the donors, the second re-evaluates the cached duals at a new q, the
    third re-solves them."""
    if family == "farmer":
        S, kw = 3, {"num_scens": 3}
        jmod, tmod = jfarmer, farmer
    else:
        S = 4
        kw = {"num_scens": S, "num_gens": 3, "horizon": 6,
              "relax_integers": True}
        jmod, tmod = juc, tuc
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 1,
            "solver_options": {"megastep": 1}}
    jopt = JPHBase(dict(opts), jmod.scenario_names_creator(S),
                   jmod.scenario_creator, scenario_creator_kwargs=kw)
    topt = PHBase(dict(opts, device="cpu"), tmod.scenario_names_creator(S),
                  tmod.scenario_creator, scenario_creator_kwargs=kw)
    c = np.asarray(topt.batch.c)
    rng = np.random.default_rng(3)
    idx = topt.tree.nonant_indices
    q1 = c.copy()
    q1[:, idx] += rng.standard_normal((S, idx.size)) * np.abs(c[:, idx]).max()
    q1[:, idx] -= q1[:, idx].mean(axis=0, keepdims=True) - c[:, idx]
    q_seq = [c, q1, q1]
    jb, tb = _donor_seq(jopt, q_seq), _donor_seq(topt, q_seq)
    for a, b in zip(tb, jb):
        assert a is not None and b is not None
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)
    assert topt.donor_duals_used == 2


# ---- whole wheels on the CPU (properties) -----------------------------------

def _okw(n, iters, creator=farmer.scenario_creator, names=None, kw=None,
         **extra):
    return {
        "options": {"defaultPHrho": 1.0, "PHIterLimit": iters,
                    "convthresh": -1.0, "device": "cpu",
                    "xhat_looper_options": {"scen_limit": 3}, **extra},
        "all_scenario_names": names or farmer.scenario_names_creator(n),
        "scenario_creator": creator,
        "scenario_creator_kwargs": kw or {"num_scens": n},
    }


def _check_farmer_wheel(ws, rel):
    assert ws.BestInnerBound == pytest.approx(EF3, rel=rel)
    assert ws.BestOuterBound <= ws.BestInnerBound + 1e-6
    assert ws.BestOuterBound >= TRIVIAL3
    cache = ws.local_nonant_cache
    assert cache is not None and cache[0].sum() <= 500 + 1e-4
    # every cylinder solved through the sweep (its plain version here),
    # counted in its own thread's view
    for name, st in ws.stats.items():
        assert st["launches"].get(("plain_calls", "fused_sweeps"), 0) > 0, \
            name
        assert st["host_syncs"] > 0, name
    assert not ws.spoke_errors


def test_wheel_farmer_lagrangian_xhatshuffle():
    """PH hub + Lagrangian outer + XhatShuffle inner: the minimum full
    wheel.  The certified gap must close."""
    n = 3
    hub_dict = {"hub_class": PHHub,
                "hub_kwargs": {"options": {"rel_gap": 1e-3, "abs_gap": 1.0,
                                           "linger_secs": 60.0}},
                "opt_class": PH, "opt_kwargs": _okw(n, 40)}
    spokes = [
        {"spoke_class": LagrangianOuterBound, "opt_class": PHBase,
         "opt_kwargs": _okw(n, 40)},
        {"spoke_class": XhatShuffleInnerBound, "opt_class": Xhat_Eval,
         "opt_kwargs": _okw(n, 40)}]
    ws = WheelSpinner(hub_dict, spokes).spin()
    _check_farmer_wheel(ws, 2e-3)
    gap = ws.BestInnerBound - ws.BestOuterBound
    assert gap <= max(1.0, 1e-3 * abs(ws.BestOuterBound))
    assert all(c.bounds_posted > 0 for c in ws.spoke_comms)


def test_wheel_hub_only(tmp_path):
    """A wheel with no spokes is plain PH; its first stage is written as
    CSV and as .npy."""
    hub_dict = {"hub_class": PHHub, "hub_kwargs": {"options": {}},
                "opt_class": PH, "opt_kwargs": _okw(3, 5)}
    ws = spin_the_wheel(hub_dict, [])
    assert ws.spun and np.isfinite(ws.spcomm.BestOuterBound)
    assert ws.spcomm.BestOuterBound == ws.opt.trivial_bound
    assert ws.spcomm.stopped_at == (5, "PHIterLimit")
    first = ws.local_nonant_cache[0]
    ws.write_first_stage_solution(str(tmp_path / "x.csv"))
    rows = (tmp_path / "x.csv").read_text().splitlines()
    assert len(rows) == first.size
    assert [float(r.split(",")[1]) for r in rows] == list(first)
    ws.write_first_stage_solution(str(tmp_path / "x.npy"))
    assert np.array_equal(np.load(tmp_path / "x.npy"), first)


def test_wheel_multistage_hydro():
    """Three-stage hydro: PH hub + Lagrangian + XhatShuffle (per-node
    donor completion keeps shuffled candidates nonanticipative)."""
    from tpusppy_torch.ef import solve_ef
    from tpusppy_torch.spbase import build_batch

    names = hydro.scenario_names_creator(9)
    kw = {"branching_factors": [3, 3]}
    batch, _ = build_batch(names, hydro.scenario_creator, kw)
    ef_obj, _ = solve_ef(batch, solver="highs")

    def okw(iters):
        return _okw(9, iters, hydro.scenario_creator, names, kw,
                    xhat_looper_options={"scen_limit": 2})

    hub_dict = {"hub_class": PHHub,
                "hub_kwargs": {"options": {"rel_gap": 0.01}},
                "opt_class": PH, "opt_kwargs": okw(60)}
    spokes = [
        {"spoke_class": LagrangianOuterBound, "opt_class": PHBase,
         "opt_kwargs": okw(60)},
        {"spoke_class": XhatShuffleInnerBound, "opt_class": Xhat_Eval,
         "opt_kwargs": okw(60)}]
    ws = WheelSpinner(hub_dict, spokes).spin()
    assert ws.BestOuterBound <= ws.BestInnerBound + 1e-6
    assert ws.BestOuterBound <= ef_obj + 1e-6 * abs(ef_obj)
    assert ws.BestInnerBound == pytest.approx(ef_obj, rel=0.02)
    # the incumbent is nonanticipative per stage-2 node (to the solves'
    # tolerance: node-mates agree to ~1e-4 of O(100) flows)
    cache = ws.local_nonant_cache
    stage2 = ws.opt.tree.nonant_stage == 2
    for g in range(3):
        grp = cache[3 * g:3 * g + 3][:, stage2]
        np.testing.assert_allclose(grp, np.broadcast_to(grp[:1], grp.shape),
                                   atol=1e-3)


def test_wheel_on_the_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    okw = _okw(3, 2)
    del okw["options"]["device"]
    hub_dict = {"hub_class": PHHub, "hub_kwargs": {"options": {}},
                "opt_class": PH, "opt_kwargs": okw}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WheelSpinner(hub_dict, []).spin()


# ---- batch cache ------------------------------------------------------------

def test_batch_cache_shares_across_cylinders():
    """options["batch_cache"]: identical (creator, names, kwargs) builds
    share ONE ScenarioBatch (tests/test_wheel.py)."""
    clear_batch_cache()
    names = farmer.scenario_names_creator(3)
    kw = {"num_scens": 3}
    opts = {"batch_cache": True, "device": "cpu"}
    a = SPBase(opts, names, farmer.scenario_creator,
               scenario_creator_kwargs=kw)
    b = SPBase(opts, names, farmer.scenario_creator,
               scenario_creator_kwargs=kw)
    assert a.batch is b.batch
    c = SPBase({"device": "cpu"}, names, farmer.scenario_creator,
               scenario_creator_kwargs=kw)
    assert c.batch is not a.batch
    d = SPBase(opts, names, farmer.scenario_creator,
               scenario_creator_kwargs={"num_scens": 3,
                                        "crops_multiplier": 2})
    assert d.batch is not a.batch
    # fixing on one sharer leaves the shared bounds alone
    ev = Xhat_Eval(dict(opts, defaultPHrho=1.0, PHIterLimit=1), names,
                   farmer.scenario_creator, scenario_creator_kwargs=kw)
    assert ev.batch is a.batch
    lb0 = a.batch.lb.copy()
    ev.fix_nonants(np.full(ev.nonant_length, 100.0))
    assert np.array_equal(a.batch.lb, lb0)
    clear_batch_cache()


# ---- owners of captured sweep loops -----------------------------------------

class _Stub:
    def __init__(self, block, ops, state):
        self.block = block


def test_owners_of_one_signature_get_distinct_loops(monkeypatch):
    monkeypatch.setattr(device_loop, "_Captured", _Stub)
    monkeypatch.setattr(device_loop, "_cache", {})
    ops = (torch.zeros(3, 4), torch.zeros(3, dtype=torch.int64))
    state = [torch.zeros(3, 4), torch.zeros((), dtype=torch.int32)]

    def entry(key=("admm",)):
        return device_loop._entry(None, ops, state, 4, key)

    with cuda_kernels.owned_by("hub"):
        hub_loop = entry()
        assert entry() is hub_loop
    with cuda_kernels.owned_by("spoke"):
        spoke_loop = entry()
        assert spoke_loop is not hub_loop
        # the spoke fills its own cache past the limit ...
        for i in range(device_loop.CACHE_SIZE + 2):
            entry(("other", i))
        assert entry() is not spoke_loop     # its own oldest went
    with cuda_kernels.owned_by("hub"):
        assert entry() is hub_loop           # ... and never the hub's
    # the default owner is the calling thread
    assert entry() is not hub_loop
    device_loop.release("hub")
    assert "hub" not in device_loop._cache
    with cuda_kernels.owned_by("hub"):
        assert entry() is not hub_loop


# ---- what is not ported yet raises ------------------------------------------

def _unported_cases():
    def megastep():
        PH({"defaultPHrho": 1.0, "PHIterLimit": 1, "device": "cpu",
            "megastep_autotune": True},
           farmer.scenario_names_creator(3), farmer.scenario_creator,
           scenario_creator_kwargs={"num_scens": 3})

    # ported since (resilience): each case runs and says so
    def checkpoint():
        import tempfile

        from tpusppy_torch.resilience import checkpoint as ck

        with tempfile.TemporaryDirectory() as d:
            WheelSpinner({"hub_class": PHHub, "opt_class": PH,
                          "opt_kwargs": _okw(3, 1),
                          "hub_kwargs": {"options": {
                              "checkpoint_dir": d,
                              "checkpoint_every_iters": 1,
                              "spoke_timeout_secs": 60.0}}},
                         []).spin()
            return ck.latest_iteration(d) == 1

    def resume():
        import os
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            ws = WheelSpinner({"hub_class": PHHub, "opt_class": PH,
                               "opt_kwargs": _okw(3, 1),
                               "hub_kwargs": {"options": {}}}, [],
                              resume=os.path.join(d, "none")).spin()
            # nothing to resume from: a cold start
            return ws.resumed_from is None and ws.opt._iter == 1

    def preempt():
        # a park request lands at the first window boundary
        ws = WheelSpinner({"hub_class": PHHub, "opt_class": PH,
                           "opt_kwargs": _okw(3, 3),
                           "hub_kwargs": {"options": {
                               "preempt_check": lambda: True}}}, []).spin()
        return ws.spcomm.preempted and ws.opt._iter == 1

    # ported since (integer families): each case runs and says so
    def milp_lift():
        opt = PHBase(dict(_okw(3, 1)["options"],
                          lagrangian_milp_lift={"every": 1}),
                     farmer.scenario_names_creator(3),
                     farmer.scenario_creator, scenario_creator_kwargs={
                         "num_scens": 3, "use_integer": True})
        sp = LagrangianOuterBound(opt, 1, WindowFabric())
        sp.lagrangian_prep()
        return bool(np.isfinite(sp.lagrangian())
                    and sp.last_milp_lift_count == 3)

    def donor_milp():
        opt = Xhat_Eval(dict(_okw(3, 1)["options"], xhat_looper_options={
            "donor_milp": True}), farmer.scenario_names_creator(3),
            farmer.scenario_creator, scenario_creator_kwargs={
                "num_scens": 3})
        sp = XhatShuffleInnerBound(opt, 1, WindowFabric())
        sp.xhatbase_prep()
        return sp.donor_milp and sp._donor_milp_candidate(0) is not None

    def integer_dive():
        ev = Xhat_Eval(_okw(3, 1)["options"],
                       farmer.scenario_names_creator(3),
                       farmer.scenario_creator, scenario_creator_kwargs={
                           "num_scens": 3})
        # an integer recourse column: fixing the nonants leaves it free
        is_int = np.zeros(ev.batch.num_vars, dtype=bool)
        is_int[ev.batch.num_vars - 1] = True
        ev.batch.is_int = is_int
        z = ev.evaluate(np.full(ev.nonant_length, 100.0))
        x = ev.local_x[:, -1]
        return bool(np.isfinite(z)
                    and np.abs(x - np.round(x)).max() < 1e-5)

    def multiprocess():
        MultiprocessWheelSpinner({}, [])

    def lowered_precision():
        okw = _okw(3, 1)
        okw["options"]["solver_options"] = {"sweep_precision": "default"}
        WheelSpinner({"hub_class": PHHub, "opt_class": PH,
                      "opt_kwargs": okw, "hub_kwargs": {"options": {}}},
                     []).spin()

    return [(megastep, "Queue 1 item 5"), (checkpoint, None),
            (resume, None), (preempt, None), (milp_lift, None),
            (donor_milp, None), (integer_dive, None),
            (multiprocess, "Queue 1 item 7"),
            (lowered_precision, "Queue 1 item 5")]


@pytest.mark.parametrize("case", _unported_cases(),
                         ids=lambda c: c[0].__name__)
def test_unported_option_raises_and_names_its_roadmap_item(case):
    """Each part not ported raises naming its ROADMAP item; a case whose
    part has been ported since (``item`` None) runs and checks itself."""
    fn, item = case
    if item is None:
        assert fn() is True
        return
    with pytest.raises(NotImplementedError, match=item):
        fn()

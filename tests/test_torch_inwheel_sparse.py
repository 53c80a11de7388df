"""The in-wheel bound pass on the sparse engine and the in-wheel host rescue,
the port against the reference, float64 on the CPU.

The sparse engine: uc (3 generators x 6 hours, LP relaxation) at S=4 with
its shared A uploaded as a SparseA in both packages.  The reference runs
Iter0 and three legacy iterations; its state is carried into a port PH
(``tpusppy_torch.convert``) and both run ONE bound-pass window with
``n_live=0``: the outer bound and the inner bound agree to 1e-9, the
feasible mass and the sweeps exactly, and the host rescue accepts or
declines as the reference's with the same value to 1e-9.  At both rhos
the frozen clamped evaluation runs its whole sweep budget short of the
1e-3 gate, in both packages, so the inner bound comes from the rescue,
whose candidate (fractional commitments) sits far above the EF.

The rescue: farmer S=40; a candidate 2e-6 over the land row (an f32
consensus) declines in both packages, HiGHS running at its default
tolerances in both; the land met, both give the same value to 1e-9.
"""

import numpy as np
import pytest
import torch

from tpusppy.models import farmer as jfarmer
from tpusppy.models import uc as juc
from tpusppy.opt.ph import PH as JPH
from tpusppy.phbase import PHBase as JPHBase
from tpusppy_torch import convert
from tpusppy_torch.cylinders.lagrangian_bounder import in_wheel_outer_bound
from tpusppy_torch.ef import solve_ef as tsolve_ef
from tpusppy_torch.models import farmer as tfarmer
from tpusppy_torch.models import uc as tuc
from tpusppy_torch.obs import metrics
from tpusppy_torch.opt.ph import PH as TPH
from tpusppy_torch.phbase import PHBase as TPHBase
from tpusppy_torch.solvers.sparse import SparseA as TSparseA

torch.set_num_threads(1)

UC_KW = {"num_scens": 4, "num_gens": 3, "horizon": 6,
         "relax_integers": True}


def _uc_pair(rho):
    names = tuc.scenario_names_creator(4)
    opts = {"defaultPHrho": rho, "PHIterLimit": 40, "convthresh": -1.0,
            "in_wheel_bounds": True, "sparse_device_A": True,
            "straggler_tol_qp": 1e30, "solver_options": {"megastep": 1}}
    jph = JPH(opts, names, juc.scenario_creator, scenario_creator_kwargs=UC_KW)
    jph.Iter0()
    for k in range(1, 4):
        jph._iterk_one(k, -1.0)
    tph = TPH(dict(opts, device="cpu"), names, tuc.scenario_creator,
              scenario_creator_kwargs=UC_KW)
    convert.load_ph_state(
        tph, jph.W, jph.xbars, jph.rho,
        warm=tuple(np.asarray(v) for v in jph._warm),
        factors=jph._factors._asdict(), factors_age=jph._factors_age,
        iteration=jph._iter)
    return jph, tph


@pytest.mark.parametrize("rho", [10.0, 10000.0])
def test_sparse_bound_pass_and_rescue_match_reference(rho):
    jph, tph = _uc_pair(rho)
    assert isinstance(tph._device_consts(torch.float64)[0], TSparseA)
    jm = jph._megastep_solve(4, 0, -1.0, jph.W, jph.xbars, jph.rho,
                             bound_live=True)
    with metrics.window() as w:
        tm = tph._megastep_solve(4, 0, -1.0, tph.W, tph.xbars, tph.rho,
                                 bound_live=True)
        assert w.delta("megastep.bound_passes") == 1
    assert tm["executed"] == jm["executed"] == 0
    scale = max(1.0, abs(jm["bound_outer"]), abs(jm["bound_inner_obj"]))
    for k in ("bound_outer", "bound_inner_obj"):
        assert abs(tm[k] - jm[k]) <= 1e-9 * scale, k
    assert tm["bound_inner_feas"] == jm["bound_inner_feas"]
    assert tm["bound_sweeps"] == jm["bound_sweeps"]
    assert abs(in_wheel_outer_bound(tph) - tm["bound_outer"]) <= 1e-9 * scale
    # why no inner bound comes from the pass: the frozen clamped evaluation
    # runs its whole budget without meeting the 1e-3 gate on every scenario
    assert tm["bound_sweeps"] == tph.admm_settings.max_iter
    assert tm["bound_inner_feas"] < 1.0
    jr = jph._inwheel_host_rescue()
    tr = tph._inwheel_host_rescue()
    assert (tr is None) == (jr is None)
    ef, _ = tsolve_ef(tph.batch)
    assert tm["bound_outer"] <= ef + 1e-6 * abs(ef)
    if tr is not None:
        assert tr == pytest.approx(jr, rel=1e-9)
        assert tr >= ef - 1e-6 * abs(ef)


def _farmer_pair(S=40):
    names = tfarmer.scenario_names_creator(S)
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 1}
    kw = {"num_scens": S}
    return (JPHBase(opts, names, jfarmer.scenario_creator,
                    scenario_creator_kwargs=kw),
            TPHBase(dict(opts, device="cpu"), names,
                    tfarmer.scenario_creator, scenario_creator_kwargs=kw))


def test_rescue_runs_highs_at_its_default_as_the_reference():
    jph, tph = _farmer_pair()
    S, K = tph.batch.num_scenarios, tph.nonant_length
    acres = np.array([170.0, 80.0, 250.0])       # land 500
    feasible = np.tile(acres, (S, 1))
    over = np.tile(acres + np.array([2e-6, 0.0, 0.0]), (S, 1))
    assert K == 3
    for cand in (over, over + np.array([1e-3, 0.0, 0.0])):
        assert jph._inwheel_eval_candidate_host(cand) is None
        assert tph._inwheel_eval_candidate_host(cand) is None
    jv = jph._inwheel_eval_candidate_host(feasible)
    tv = tph._inwheel_eval_candidate_host(feasible)
    assert tv is not None and tv == pytest.approx(jv, rel=1e-9)
    # through the rescue's own candidate rule: the consensus 2e-6 over
    # declines in both, and is counted
    for ph in (jph, tph):
        ph.xbars = over
    with metrics.window() as w:
        assert tph._inwheel_host_rescue() is None
        assert w.delta("megastep.bound_rescues") == 1
    assert jph._inwheel_host_rescue() is None
    for ph in (jph, tph):
        ph.xbars = feasible
    assert tph._inwheel_host_rescue() == pytest.approx(
        jph._inwheel_host_rescue(), rel=1e-9)

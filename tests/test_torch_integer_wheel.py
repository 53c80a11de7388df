"""The integer wheels, float64 on the CPU: the whole slice.

The netdes S=3 hub-only in-wheel wheel (``tests/test_integer.py::
TestWheelCertifies``' settings: each window's integer bound pass, the host
rescue's ladder and the gap-ranked escalation, with a budget that never
binds) gives the reference's outer and inner bound to 1e-6 and certifies a
gap of 0.04, past the LP-only floor (the LP EF 376.306) and below the MIP
EF (398.333).  A sizes S=3 wheel (``tests/test_mip_incumbents.py::
test_integer_sizes_wheel_certified_gap``: a PH hub at rho 0.01, a
Lagrangian and an XhatShuffle spoke) lands in that test's bands; its hub
runs 2 iterations and its spoke evaluates by host MILPs
(``xhat_integer_strategy`` "milp", gap 1e-2), since one dive of sizes costs
minutes on a CPU (the dive is held in
``tests/test_torch_mip_incumbents.py``).
"""

import numpy as np
import torch

from test_torch_integer import LP_EF, MIP_EF, N, NETDES_KW, _rel
from tpusppy.models import netdes as jnetdes
from tpusppy.opt.ph import PH as JPH
from tpusppy_torch.models import netdes as tnetdes
from tpusppy_torch.models import sizes as tsizes
from tpusppy_torch.obs import metrics
from tpusppy_torch.opt.ph import PH as TPH
from tpusppy_torch.xhat_eval import Xhat_Eval

torch.set_num_threads(1)

SIZES_KW = {"scenario_count": N, "relax_integers": False}


def _netdes_wheel(PH, PHHub, WheelSpinner, device=None):
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 60, "convthresh": -1.0,
            "in_wheel_bounds": True, "integer_escalation_budget_s": 600.0}
    if device:
        opts["device"] = device
    mod = tnetdes if device else jnetdes
    okw = {"options": opts, "all_scenario_names":
           mod.scenario_names_creator(N),
           "scenario_creator": mod.scenario_creator,
           "scenario_creator_kwargs": NETDES_KW}
    return WheelSpinner({"hub_class": PHHub,
                         "hub_kwargs": {"options": {"rel_gap": 0.04}},
                         "opt_class": PH, "opt_kwargs": okw}, []).spin()


def test_netdes_hub_only_wheel_matches_reference_and_certifies():
    from tpusppy.cylinders import PHHub as JHub
    from tpusppy.spin_the_wheel import WheelSpinner as JSpinner
    from tpusppy_torch.cylinders import PHHub
    from tpusppy_torch.spin_the_wheel import WheelSpinner

    with metrics.window() as w:
        ws = _netdes_wheel(TPH, PHHub, WheelSpinner, device="cpu")
    jws = _netdes_wheel(JPH, JHub, JSpinner)
    ob, ib = ws.BestOuterBound, ws.BestInnerBound
    assert _rel(ob, jws.BestOuterBound) <= 1e-6
    assert _rel(ib, jws.BestInnerBound) <= 1e-6
    assert (ib - ob) / abs(ob) <= 0.04
    assert LP_EF + 1e-6 < ob <= MIP_EF + 1e-6 * MIP_EF
    assert ib >= MIP_EF - 1e-3
    assert w.delta("integer.feasible_hits") > 0
    assert w.delta("integer.escalations") >= 1
    assert w.delta("integer.escalation_errors") == 0
    assert w.delta("megastep.bound_passes") >= 1


def test_sizes_spoke_wheel_lands_in_the_bands():
    from tpusppy_torch.cylinders import (LagrangianOuterBound, PHHub,
                                         XhatShuffleInnerBound)
    from tpusppy_torch.phbase import PHBase
    from tpusppy_torch.spin_the_wheel import WheelSpinner

    names = tsizes.scenario_names_creator(N)

    def okw(iters):
        return {"options": {"defaultPHrho": 0.01, "PHIterLimit": iters,
                            "convthresh": -1.0, "device": "cpu",
                            "xhat_integer_strategy": "milp",
                            "xhat_mip_time_limit": 600.0,
                            "xhat_mip_rel_gap": 1e-2,
                            "xhat_looper_options": {"scen_limit": 1}},
                "all_scenario_names": names,
                "scenario_creator": tsizes.scenario_creator,
                "scenario_creator_kwargs": SIZES_KW}

    ws = WheelSpinner(
        {"hub_class": PHHub, "hub_kwargs": {"options": {"rel_gap": 0.02}},
         "opt_class": TPH, "opt_kwargs": okw(2)},
        [{"spoke_class": LagrangianOuterBound, "opt_class": PHBase,
          "opt_kwargs": okw(60)},
         {"spoke_class": XhatShuffleInnerBound, "opt_class": Xhat_Eval,
          "opt_kwargs": okw(60)}]).spin()
    ob, ib = ws.BestOuterBound, ws.BestInnerBound
    assert np.isfinite(ib) and ob <= ib + 1e-6
    assert ws.spoke_comms[1].opt.host_milp_secs > 0.0
    assert 218000.0 <= ob <= 230000.0
    assert 220000.0 <= ib <= 240000.0

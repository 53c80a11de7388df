"""The port's wheel (tpusppy_torch) with every ported spoke family at once:
PH hub + Lagrangian + XhatShuffle + XhatXbar on farmer S=3, float64 on the
CPU.  Thread timing makes a wheel differ from run to run, so it holds the
reference's properties (``tests/test_wheel.py``), not a trajectory; the
helpers and the other wheels are in ``tests/test_torch_wheel.py`` (a file
of its own so that its threads run beside that file's tests).
"""

import torch

from test_torch_wheel import _check_farmer_wheel, _okw
from tpusppy_torch.cylinders import (
    LagrangianOuterBound,
    PHHub,
    XhatShuffleInnerBound,
    XhatXbarInnerBound,
)
from tpusppy_torch.opt.ph import PH
from tpusppy_torch.phbase import PHBase
from tpusppy_torch.spin_the_wheel import WheelSpinner
from tpusppy_torch.xhat_eval import Xhat_Eval

torch.set_num_threads(1)


def test_wheel_many_spokes():
    """Every ported spoke family at once."""
    n = 3
    hub_dict = {"hub_class": PHHub,
                "hub_kwargs": {"options": {"rel_gap": 1e-3}},
                "opt_class": PH, "opt_kwargs": _okw(n, 30)}
    spokes = [
        {"spoke_class": LagrangianOuterBound, "opt_class": PHBase,
         "opt_kwargs": _okw(n, 30)},
        {"spoke_class": XhatShuffleInnerBound, "opt_class": Xhat_Eval,
         "opt_kwargs": _okw(n, 30)},
        {"spoke_class": XhatXbarInnerBound, "opt_class": Xhat_Eval,
         "opt_kwargs": _okw(n, 30)}]
    ws = WheelSpinner(hub_dict, spokes).spin()
    _check_farmer_wheel(ws, 5e-3)

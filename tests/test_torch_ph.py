"""The port's farmer PH (tpusppy_torch) against the reference's, farmer S=3.

Both packages run PH on the same family in float64 on the CPU.  The
reference runs its legacy per-iteration loop (``solver_options={"megastep":
1}``), which is the loop the port has.  Per-iteration ``conv`` and the final
``eobj``/trivial bound agree to 1e-7 relative: the trajectory is the same
recurrence, and only last-digit differences of the batched solves (summation
order, the Cholesky inverse) and of the host rescues feed back through the
xbar/W updates.
"""

import numpy as np
import pytest
import torch

from tpusppy.extensions.extension import Extension as JExtension
from tpusppy.models import farmer
from tpusppy.opt.ph import PH as JPH
from tpusppy.solvers import segmented as jsegmented
from tpusppy_torch.ef import solve_ef
from tpusppy_torch.extensions.extension import Extension as TExtension
from tpusppy_torch.models import farmer as tfarmer
from tpusppy_torch.opt.ph import PH as TPH
from tpusppy_torch.spbase import build_batch

torch.set_num_threads(1)

EF3 = -108390.0
OPTIONS = {"defaultPHrho": 1.0, "PHIterLimit": 50, "convthresh": 1e-6,
           "solver_options": {"megastep": 1}}


def _recorder(base):
    class ConvRecorder(base):
        """Records ``conv`` after every PH iteration."""

        def __init__(self, opt):
            super().__init__(opt)
            opt.conv_trace = []

        def enditer(self):
            self.opt.conv_trace.append(self.opt.conv)

    return ConvRecorder


def run_both(num_scens, crops_multiplier=1, options=OPTIONS):
    """(reference PH, port PH) after ph_main on the same family."""
    kw = {"num_scens": num_scens, "crops_multiplier": crops_multiplier}
    names = farmer.scenario_names_creator(num_scens)
    jph = JPH(dict(options), names, farmer.scenario_creator,
              scenario_creator_kwargs=kw, extensions=_recorder(JExtension))
    st = jph.admm_settings
    S, n, m = (jph.batch.num_scenarios, jph.batch.num_vars,
               jph.batch.num_rows)
    # the reference must run the same single-dispatch legacy loop
    assert jph._megastep_request() == 0
    seg_r, seg_f = jsegmented.dispatch_segments(S, n, m, st, factor_batch=S)
    assert seg_r >= st.max_iter and seg_f >= st.max_iter
    jres = jph.ph_main()
    tph = TPH(dict(options, device="cpu"), names, tfarmer.scenario_creator,
              scenario_creator_kwargs=kw, extensions=_recorder(TExtension))
    tres = tph.ph_main()
    return jph, jres, tph, tres


def assert_same_trajectory(jph, jres, tph, tres, rel=1e-7):
    cj = np.asarray(jph.conv_trace)
    ct = np.asarray(tph.conv_trace)
    assert cj.shape == ct.shape and cj.size > 0
    np.testing.assert_allclose(ct, cj, rtol=rel, atol=0)
    for a, b in zip(tres, jres):
        assert a == pytest.approx(b, rel=rel)


def test_ef_highs_golden():
    batch, _ = build_batch(tfarmer.scenario_names_creator(3),
                           tfarmer.scenario_creator, {"num_scens": 3})
    obj, x = solve_ef(batch, solver="highs")
    assert obj == pytest.approx(EF3, rel=1e-6)
    # first stage: wheat 170, corn 80, beets 250 in every scenario
    np.testing.assert_allclose(x[:, :3], [[170.0, 80.0, 250.0]] * 3,
                               atol=1e-6)


def test_ph_matches_reference_farmer3():
    jph, jres, tph, tres = run_both(3)
    assert_same_trajectory(jph, jres, tph, tres)
    _, eobj, tbound = tres
    assert eobj == pytest.approx(EF3, rel=2e-3)
    assert tbound <= EF3
    np.testing.assert_allclose(tph.W, jph.W, rtol=0, atol=1e-9 * max(
        1.0, np.abs(jph.W).max()))
    # E[W] = 0 per nonant slot: the PH dual invariant
    np.testing.assert_allclose(tph.probs @ tph.W, 0.0, atol=1e-6)

"""The port's options (tpusppy_torch.spbase) and the solve loop's frozen
refusals against the reference.

Options the port does not have must not be dropped without a word: lowered
matmul precision raises, scenario bundling builds the reference's bundled
batch, and the reference's ``use_pallas`` is the port's ``use_kernel``.  The frozen-solve acceptance
rule is the reference's: on a small uc_lite batch (float64, the CPU, the
same options) both packages refuse the same number of frozen attempts.
"""

import numpy as np
import pytest
import torch

from tpusppy.models import uc_lite as juc
from tpusppy.opt.ph import PH as JPH
from tpusppy.solvers import segmented as jsegmented
from tpusppy.spopt import SPOpt as JSPOpt
from tpusppy_torch.models import farmer as tfarmer
from tpusppy_torch.models import uc_lite as tuc
from tpusppy_torch.obs import metrics
from tpusppy_torch.opt.ph import PH as TPH
from tpusppy_torch.spbase import build_batch, make_admm_settings

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["high", "default"])
def test_lowered_matmul_precision_raises(mode):
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        make_admm_settings({"solver_options": {"matmul_precision": mode}})


@pytest.mark.parametrize("mode", [None, "highest"])
def test_full_matmul_precision_is_taken(mode):
    st = make_admm_settings({"solver_options": {"matmul_precision": mode,
                                                "max_iter": 7}})
    assert st.max_iter == 7


def test_bundling_raises():
    """``bundles_per_rank`` builds the reference's bundled batch (it raised
    until the port had bundling); a bundle count the family cannot take
    raises as the reference's does."""
    from tpusppy.models import farmer as jfarmer
    from tpusppy.spbase import build_batch as jbuild_batch

    names = tfarmer.scenario_names_creator(3)
    batch, bnames = build_batch(names, tfarmer.scenario_creator,
                                {"num_scens": 3}, {"bundles_per_rank": 2})
    jbatch, bundling, jnames = jbuild_batch(
        {"bundles_per_rank": 2}, names, jfarmer.scenario_creator,
        {"num_scens": 3})
    assert bundling and bnames == jnames == ["bundle_0", "bundle_1"]
    for f in ("c", "q2", "A", "cl", "cu", "lb", "ub", "const"):
        np.testing.assert_array_equal(getattr(batch, f), getattr(jbatch, f))
    np.testing.assert_array_equal(batch.probs, jbatch.probs)
    ph = TPH({"bundles_per_rank": 1, "device": "cpu", "defaultPHrho": 1.0,
              "PHIterLimit": 1}, names, tfarmer.scenario_creator,
             scenario_creator_kwargs={"num_scens": 3})
    assert ph.bundling and ph.batch.num_scenarios == 1
    assert ph.admm_settings.max_iter == 4000
    with pytest.raises(ValueError, match="out of range"):
        build_batch(names, tfarmer.scenario_creator, {"num_scens": 3},
                    {"bundles_per_rank": 4})
    batch, _ = build_batch(names, tfarmer.scenario_creator,
                           {"num_scens": 3}, {"bundles_per_rank": 0})
    assert batch.num_scenarios == 3


@pytest.mark.parametrize("value", [True, False, "auto"])
def test_use_pallas_maps_to_use_kernel(value):
    st = make_admm_settings({"solver_options": {"use_pallas": value}})
    assert st.use_kernel == value
    st = make_admm_settings({"solver_options": {"use_pallas": value,
                                                "use_kernel": value}})
    assert st.use_kernel == value


def test_use_pallas_disagreeing_with_use_kernel_raises():
    with pytest.raises(ValueError, match="disagree"):
        make_admm_settings({"solver_options": {"use_pallas": False,
                                               "use_kernel": True}})


def test_uc_lite_frozen_refusals_match_reference(monkeypatch):
    """uc_lite (3 generators, 6 hours), S=8, rho 500, eps 1e-5, 40 sweeps a
    solve, 12 PH iterations: the frozen attempts the reference refuses
    (counted by a wrapper around its solve loop: a call that tried a frozen
    solve and then refreshed) are the port's ``solve.frozen_rejected``.
    At these settings every frozen attempt (one in each iteration after
    the first, which refreshes for the new prox term) is refused in both
    packages, as on uc_lite-1000 in f32 on the card from its 12th
    iteration on."""
    S, iters = 8, 12
    kw = {"num_scens": S, "num_gens": 3, "horizon": 6,
          "relax_integers": True}
    opts = {"defaultPHrho": 500.0, "convthresh": 1e-9, "PHIterLimit": iters,
            "solver_options": {"megastep": 1, "eps_abs": 1e-5,
                               "eps_rel": 1e-5, "max_iter": 40}}
    calls = {}
    refused = []

    def counted(name, real):
        def run(*a, **k):
            calls[name] = True
            return real(*a, **k)
        return run

    monkeypatch.setattr(jsegmented, "solve_frozen_segmented", counted(
        "frozen", jsegmented.solve_frozen_segmented))
    monkeypatch.setattr(jsegmented, "solve_factored_segmented", counted(
        "refresh", jsegmented.solve_factored_segmented))
    real = JSPOpt._solve_amortized

    def amortized(self, *a, **k):
        calls.clear()
        out = real(self, *a, **k)
        refused.append(bool(calls.get("frozen") and calls.get("refresh")))
        return out

    monkeypatch.setattr(JSPOpt, "_solve_amortized", amortized)
    names = juc.scenario_names_creator(S)
    jres = JPH(dict(opts), names, juc.scenario_creator,
               scenario_creator_kwargs=kw).ph_main()
    with metrics.window() as win:
        tres = TPH(dict(opts, device="cpu"), names, tuc.scenario_creator,
                   scenario_creator_kwargs=kw).ph_main()
    assert sum(refused) == win.delta("solve.frozen_rejected") == iters - 1
    np.testing.assert_allclose(tres, jres, rtol=1e-7)

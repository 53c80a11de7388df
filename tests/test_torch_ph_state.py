"""The port's PH against the reference's on a larger family, and the PH state
carried from the reference into the port (tpusppy_torch.convert).

farmer S=9 with crops_multiplier=2 runs in both packages as in
tests/test_torch_ph.py (same options, same 1e-7 trajectory tolerance).  The
state carry runs the reference for 5 iterations, seats its (W, xbars, rho,
warm start, refresh factors) in a port PH, and runs one more iteration in
both: W and xbars agree to 1e-9, since the port then repeats the same frozen
solve from the same state.
"""

import numpy as np
import pytest
import torch

from test_torch_ph import OPTIONS, assert_same_trajectory, run_both
from tpusppy.ef import solve_ef as jsolve_ef
from tpusppy.models import farmer
from tpusppy.opt.ph import PH as JPH
from tpusppy_torch import convert
from tpusppy_torch.models import farmer as tfarmer
from tpusppy_torch.opt.ph import PH as TPH

torch.set_num_threads(1)


def test_ph_matches_reference_farmer9_cm2():
    jph, jres, tph, tres = run_both(9, crops_multiplier=2)
    assert_same_trajectory(jph, jres, tph, tres)
    obj_ef, _ = jsolve_ef(jph.batch, solver="highs")
    assert tres[2] <= obj_ef + 1.0
    assert tres[1] == pytest.approx(obj_ef, rel=5e-3)


def test_state_carry_reproduces_next_iteration():
    S = 3
    kw = {"num_scens": S}
    names = farmer.scenario_names_creator(S)
    opts = dict(OPTIONS, PHIterLimit=5, convthresh=0.0)
    jph = JPH(dict(opts), names, farmer.scenario_creator,
              scenario_creator_kwargs=kw)
    jph.ph_main()
    assert jph._iter == 5 and jph._factors is not None
    tph = TPH(dict(opts, device="cpu"), names, tfarmer.scenario_creator,
              scenario_creator_kwargs=kw)
    convert.load_ph_state(
        tph, jph.W, jph.xbars, jph.rho,
        warm=tuple(np.asarray(v) for v in jph._warm),
        factors={k: np.asarray(v) for k, v in jph._factors._asdict().items()},
        factors_age=jph._factors_age, iteration=jph._iter)
    age = jph._factors_age
    jph._iterk_one(6, 0.0)
    tph._iterk_one(6, 0.0)
    # both took the frozen path on the carried factors
    assert jph._factors_age == tph._factors_age == age + 1
    for name in ("W", "xbars"):
        a, b = getattr(tph, name), getattr(jph, name)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-9 * max(1.0, np.abs(b).max()))
    assert tph.conv == pytest.approx(jph.conv, rel=1e-9)


def test_batch_carried_from_reference_solves_the_same():
    """convert.batch_from_arrays: the reference's ScenarioBatch fields make
    a port batch whose EF and objectives match."""
    import dataclasses

    from tpusppy.ir import ScenarioBatch
    from tpusppy_torch.ef import solve_ef

    names = farmer.scenario_names_creator(3)
    jb = ScenarioBatch.from_problems(
        [farmer.scenario_creator(nm, num_scens=3) for nm in names])
    fields = {f.name: getattr(jb, f.name) for f in dataclasses.fields(jb)}
    fields["tree"] = dataclasses.asdict(jb.tree)
    tb = convert.batch_from_arrays(**fields)
    assert tb.num_scenarios == 3 and tb.A.shape == jb.A.shape
    obj, x = solve_ef(tb, solver="highs")
    assert obj == pytest.approx(-108390.0, rel=1e-6)
    np.testing.assert_allclose(tb.objective(x), jb.objective(x), rtol=1e-12)

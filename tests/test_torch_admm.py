"""The port's batched ADMM (tpusppy_torch.solvers.admm) against the reference.

Both packages get the same numpy inputs, made from a seed, in float64 on the
CPU.  The reference runs with ``use_pallas=False`` (its batched XLA sweep);
the port's CPU path runs the kernel's plain version, the same recurrence.
Tolerance 1e-9 relative to the largest entry: the recurrence and the
iteration count are the same, only summation orders and the Cholesky inverse
differ in the last digits.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpusppy.ir import ScenarioBatch
from tpusppy.models import farmer
from tpusppy.solvers import admm as jadmm
from tpusppy.solvers import scipy_backend as jscipy
from tpusppy.spopt import SPOpt as JSPOpt
from tpusppy_torch import convert
from tpusppy_torch.models import farmer as tfarmer
from tpusppy_torch.solvers import admm as tadmm
from tpusppy_torch.spopt import SPOpt as TSPOpt

torch.set_num_threads(1)

REL = 1e-9


def _close(a, b, rel=REL):
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    assert a.shape == b.shape
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    assert err <= rel * max(float(np.max(np.abs(b))), 1.0), err


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _settings(**kw):
    """Matching settings for both packages (reference keys; the port's
    ``use_kernel`` stays at its default)."""
    j = jadmm.ADMMSettings(use_pallas=False, **kw)
    t = tadmm.ADMMSettings(**kw)
    return j, t


def _farmer_arrays(S=3):
    names = farmer.scenario_names_creator(S)
    b = ScenarioBatch.from_problems(
        [farmer.scenario_creator(nm, num_scens=S) for nm in names])
    return b, (b.c, b.q2, b.A, b.cl, b.cu, b.lb, b.ub)


def _random_lps(seed=0, S=8, n=8, m=6):
    """Random LPs with a known feasible point (tests/test_admm.py)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(S):
        A = rng.normal(size=(m, n))
        x_feas = rng.uniform(0.2, 0.8, size=n)
        slack = rng.uniform(0.5, 1.5, size=m)
        Ax = A @ x_feas
        cu = Ax + slack
        cl = np.where(rng.uniform(size=m) < 0.3, Ax - slack, -np.inf)
        eq = rng.uniform(size=m) < 0.2
        cl = np.where(eq, Ax, cl)
        cu = np.where(eq, Ax, cu)
        out.append((rng.normal(size=n), A, cl, cu, np.zeros(n),
                    np.full(n, 2.0)))
    c, A, cl, cu, lb, ub = (np.stack([p[i] for p in out]) for i in range(6))
    return c, np.zeros_like(c), A, cl, cu, lb, ub


def _compare(js, ts, c, q2, dual_rel=REL):
    """Same iteration count, iterate, duals, vote and objective.
    ``dual_rel`` loosens the POLISHED duals only (see
    test_frozen_matches_reference_on_perturbed_q); the raw pre-polish
    iterate is always held to 1e-9."""
    assert int(np.asarray(js.iters)[0]) == int(_np(ts.iters)[0])
    for f in ("x", "z"):
        _close(_np(getattr(ts, f)), np.asarray(getattr(js, f)))
    for f in ("y", "yx"):
        _close(_np(getattr(ts, f)), np.asarray(getattr(js, f)), dual_rel)
    for r_t, r_j in zip(ts.raw, js.raw):
        _close(_np(r_t), np.asarray(r_j))
    _close(np.asarray(js.done), _np(ts.done))
    x_j, x_t = np.asarray(js.x), _np(ts.x)
    obj_j = np.einsum("sn,sn->s", c, x_j) + 0.5 * np.einsum(
        "sn,sn->s", q2, x_j * x_j)
    obj_t = np.einsum("sn,sn->s", c, x_t) + 0.5 * np.einsum(
        "sn,sn->s", q2, x_t * x_t)
    _close(obj_t, obj_j)


@pytest.mark.parametrize("case", ["farmer3", "random_lp", "random_qp"])
def test_solve_batch_matches_reference(case):
    if case == "farmer3":
        _, arrs = _farmer_arrays(3)
    else:
        arrs = _random_lps(seed=0)
        if case == "random_qp":
            rng = np.random.RandomState(5)
            arrs = (arrs[0], rng.uniform(0.5, 2.0, size=arrs[0].shape),
                    *arrs[2:])
    js_st, ts_st = _settings()
    js = jadmm.solve_batch(*arrs, js_st)
    ts = tadmm.solve_batch(*arrs, ts_st, device="cpu")
    _compare(js, ts, arrs[0], arrs[1])


def test_solve_batch_warm_start_matches_reference():
    arrs = _random_lps(seed=2, S=4)
    js_st, ts_st = _settings(max_iter=3000)
    js1 = jadmm.solve_batch(*arrs, js_st)
    ts1 = tadmm.solve_batch(*arrs, ts_st, device="cpu")
    js2 = jadmm.solve_batch(*arrs, js_st, warm=tuple(js1.raw))
    ts2 = tadmm.solve_batch(*arrs, ts_st, warm=tuple(np.asarray(v) for v in
                                                      js1.raw),
                            device="cpu")
    _compare(js2, ts2, arrs[0], arrs[1])
    assert int(_np(ts2.iters)[0]) <= int(_np(ts1.iters)[0])


def test_frozen_matches_reference_on_perturbed_q():
    """tests/test_admm.py's frozen-vs-adaptive case, in both packages: a
    refresh solve's factors reused on a PH-style moved linear term.

    The refresh solve's POLISHED duals agree to 1e-7, not 1e-9: the f64
    polish solves a reduced KKT system with penalty weights 1/delta = 1e7,
    and on one degenerate scenario here its multiplier iterations amplify
    the 1e-13 difference of the pre-polish iterates to ~1e-8 in y and yx
    (x, z and the raw iterate stay within 1e-12)."""
    rng = np.random.RandomState(3)
    c, _, A, cl, cu, lb, ub = _random_lps(seed=3, S=12)
    q2 = np.full(c.shape, 0.5)
    js_st, ts_st = _settings(max_iter=2000, restarts=8, eps_abs=1e-7,
                             eps_rel=1e-7)
    j0, jf = jadmm.solve_batch_factored(c, q2, A, cl, cu, lb, ub, js_st)
    t0, tf = tadmm.solve_batch_factored(c, q2, A, cl, cu, lb, ub, ts_st,
                                        device="cpu")
    _compare(j0, t0, c, q2, dual_rel=1e-7)
    for name in ("D", "E", "cost", "rho_a", "rho_x", "K"):
        _close(_np(getattr(tf, name)), np.asarray(getattr(jf, name)))
    qp = c + 0.05 * rng.normal(size=c.shape)
    jfz = jadmm.solve_batch_frozen(qp, q2, A, cl, cu, lb, ub, jf, js_st,
                                   warm=j0.raw)
    tfz = tadmm.solve_batch_frozen(qp, q2, A, cl, cu, lb, ub, tf, ts_st,
                                   warm=t0.raw)
    _compare(jfz, tfz, qp, q2)
    assert int(_np(tfz.iters)[0]) < ts_st.max_iter


def test_frozen_from_carried_factors():
    """convert.factors_from_arrays: the reference's Factors carried into the
    port reproduce the reference's frozen solve."""
    rng = np.random.RandomState(6)
    b, arrs = _farmer_arrays(3)
    js_st, ts_st = _settings()
    j0, jf = jadmm.solve_batch_factored(*arrs, js_st)
    factors = convert.factors_from_arrays(
        {k: np.asarray(v) for k, v in jf._asdict().items()}, device="cpu")
    qp = b.c + rng.normal(scale=1e-3 * np.abs(b.c).max(), size=b.c.shape)
    args = (qp,) + arrs[1:]
    jfz = jadmm.solve_batch_frozen(*args, jf, js_st, warm=j0.raw)
    tfz = tadmm.solve_batch_frozen(
        *args, factors, ts_st,
        warm=tuple(np.asarray(v) for v in j0.raw))
    _compare(jfz, tfz, qp, b.q2)


def test_solve_loop_frozen_refresh_cycle_matches_reference():
    """tests/test_admm.py's SPOpt refresh/frozen cycle in both packages:
    the same solutions every call, frozen calls really taken, and the
    HiGHS optimum recovered on the original objective."""
    n = 3
    names = farmer.scenario_names_creator(n)
    opts = {"solver_refresh_every": 8,
            "solver_options": {"max_iter": 2000, "restarts": 8,
                               "eps_abs": 1e-9, "eps_rel": 1e-9}}
    jopt = JSPOpt(opts, names, farmer.scenario_creator,
                  scenario_creator_kwargs={"num_scens": n})
    topt = TSPOpt(dict(opts, device="cpu"), names, tfarmer.scenario_creator,
                  scenario_creator_kwargs={"num_scens": n})
    b = jopt.batch
    rng = np.random.RandomState(4)
    qs = [None] + [b.c + rng.normal(scale=1e-3 * np.abs(b.c).max(),
                                    size=b.c.shape) for _ in range(4)] + [None]
    for q in qs:
        _close(topt.solve_loop(q=q), jopt.solve_loop(q=q))
        _close(topt.pri_res, jopt.pri_res)
        assert topt._factors_age == jopt._factors_age
    assert topt._factors_age > 1
    ref = jscipy.solve_batch(b, mip=False)
    objs = topt.batch.objective(topt.local_x)
    for s in range(n):
        assert objs[s] == pytest.approx(ref[s].obj, rel=1e-5)


def test_dual_objective_matches_reference():
    b, arrs = _farmer_arrays(3)
    js_st, _ = _settings()
    sol = jadmm.solve_batch(*arrs, js_st)
    y = np.asarray(sol.y) + 0.01  # any y gives a valid weak-duality bound
    x = np.asarray(sol.x)
    jd = np.asarray(jadmm.dual_objective_with_margin(*arrs, y, x))
    t = [torch.tensor(v, dtype=torch.float64) for v in (*arrs, y, x)]
    td = _np(tadmm.dual_objective_with_margin(*t))
    _close(td, jd)
    _close(_np(tadmm.dual_objective(*t)), np.asarray(
        jadmm.dual_objective(*arrs, y, x)))


def test_measure_pack_roundtrip_and_stop_stats():
    _, arrs = _farmer_arrays(3)
    _, ts_st = _settings()
    sol = tadmm.solve_batch(*arrs, ts_st, device="cpu")
    S, n = sol.x.shape
    meas = tadmm.measure_unpack(_np(tadmm.measure_pack(sol)), S, n)
    _close(meas["x"], _np(sol.x), rel=0.0)
    assert meas["iters"] == int(_np(sol.iters).max())
    assert meas["all_done"] == bool(_np(sol.done).all())
    st = _np(tadmm.stop_stats(sol))
    assert st[0] == meas["iters"] and st[3] == float(meas["all_done"])


def test_use_kernel_rejects_unknown_strings():
    _, arrs = _farmer_arrays(3)
    with pytest.raises(ValueError, match="use_kernel"):
        tadmm.solve_batch(*arrs, tadmm.ADMMSettings(use_kernel="yes"),
                          device="cpu")
    # False takes the batched tensor path: same answer on the CPU
    a = tadmm.solve_batch(*arrs, tadmm.ADMMSettings(use_kernel=False),
                          device="cpu")
    k = tadmm.solve_batch(*arrs, tadmm.ADMMSettings(), device="cpu")
    _close(_np(a.x), _np(k.x), rel=0.0)


def test_ef_admm_route_matches_highs():
    from tpusppy_torch.ef import solve_ef
    from tpusppy_torch.spbase import build_batch

    batch, _ = build_batch(tfarmer.scenario_names_creator(3),
                           tfarmer.scenario_creator, {"num_scens": 3})
    obj_h, x_h = solve_ef(batch, solver="highs")
    st = dataclasses.replace(tadmm.ADMMSettings(), max_iter=4000)
    obj_a, _ = solve_ef(batch, solver="admm", settings=st, device="cpu")
    assert obj_h == pytest.approx(-108390.0, rel=1e-6)
    assert obj_a == pytest.approx(obj_h, rel=1e-4)
